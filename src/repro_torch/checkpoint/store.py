"""Atomic, content-addressed checkpoints with restore onto a device.

Layout (the reference's, ``repro/checkpoint/store.py``):
         <dir>/step_<N>/
             manifest.json       — leaf paths, shapes, dtypes, chunk hashes
         <dir>/chunks/chunk_<hash>.npy — deduplicated payload chunks
         <dir>/LATEST            — committed step marker (atomic rename)

- **atomic**: data is written to step_<N>.tmp and renamed; a crash mid-save
  never corrupts LATEST.
- **content-dedup**: chunks are stored by the sha1 of their bytes, and a
  Bloom filter in front of the chunk store's existence check skips the
  stat for definitely-new chunks (the paper's membership pattern).
- **the same bytes as the reference**: leaves are flattened in
  ``jax.tree_util`` order (dict keys sorted, list items by index) under
  keys like ``"params/layers/0/ln1"``; a tensor leaves through
  ``.cpu().numpy()``. A bf16 tensor has no numpy dtype and is refused:
  the train state is f32 and int.
- **restore onto a device**: ``load(step, like_tree, device=)`` takes the
  place of the reference's ``shardings=``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.bloom import BloomFilter, optimal_params


def _flatten_with_paths(tree, prefix=()):
    """(key, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    list and tuple items by index, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(prefix), tree)]
    return [kl for k, v in items
            for kl in _flatten_with_paths(v, prefix + (str(k),))]


def _unflatten(tree, leaves: dict, prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key!r} is bfloat16, which numpy cannot "
                "hold; save the f32 master state")
        return leaf.detach().cpu().contiguous().numpy()
    return np.asarray(leaf)


def _restore(arr: np.ndarray, like, device):
    """``arr`` as the leaf ``like`` stands for: filled into ``like`` in
    place where it is a tensor of that shape and dtype on ``device`` (or
    on its own device when ``device`` is None), else a new tensor on
    ``device``, else the numpy array."""
    if isinstance(like, torch.Tensor):
        target = torch.device(device) if device is not None else like.device
        src = torch.from_numpy(arr)
        if (like.device == target and like.shape == src.shape
                and like.dtype == src.dtype):
            with torch.no_grad():
                return like.copy_(src)
        return src.to(target)
    if device is not None:
        return torch.from_numpy(arr).to(device)
    return arr


class CheckpointStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        m, k = optimal_params(1 << 14, 0.01)
        self._chunk_filter = BloomFilter(m_bits=m, k=k, seed=7)
        self.stat_calls = 0          # accounting: how many existence checks
        self.stat_skipped = 0        # ... the filter saved

    # -- chunk store --------------------------------------------------------
    def _chunk_path(self, digest: str) -> str:
        return os.path.join(self.root, "chunks", f"chunk_{digest}.npy")

    def put_chunk(self, arr: np.ndarray) -> str:
        digest = hashlib.sha1(arr.tobytes()).hexdigest()[:20]
        h = np.frombuffer(hashlib.sha1(digest.encode()).digest()[:8],
                          dtype=np.uint64)
        if self._chunk_filter.query(h)[0]:
            self.stat_calls += 1
            if os.path.exists(self._chunk_path(digest)):
                return digest                    # dedup hit
        else:
            self.stat_skipped += 1               # definitely new: no stat
        self._chunk_filter.insert(h)
        tmp = self._chunk_path(digest) + ".tmp"
        with open(tmp, "wb") as f:           # np.save(str) appends '.npy'
            np.save(f, arr)
        os.replace(tmp, self._chunk_path(digest))
        return digest

    def get_chunk(self, digest: str) -> np.ndarray:
        return np.load(self._chunk_path(digest))

    # -- save / load ---------------------------------------------------------
    def save(self, step: int, tree) -> None:
        d_tmp = os.path.join(self.root, f"step_{step}.tmp")
        d_fin = os.path.join(self.root, f"step_{step}")
        shutil.rmtree(d_tmp, ignore_errors=True)
        os.makedirs(d_tmp)
        manifest = {"step": step, "leaves": []}
        for key, leaf in _flatten_with_paths(tree):
            arr = _to_numpy(key, leaf)
            digest = self.put_chunk(arr)
            manifest["leaves"].append({
                "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype),
                "chunk": digest})
        with open(os.path.join(d_tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(d_fin, ignore_errors=True)
        os.replace(d_tmp, d_fin)
        tmp_latest = os.path.join(self.root, "LATEST.tmp")
        with open(tmp_latest, "w") as f:
            f.write(str(step))
        os.replace(tmp_latest, os.path.join(self.root, "LATEST"))

    def latest_step(self) -> int | None:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def load(self, step: int, like_tree, device=None):
        """Restore into the structure of ``like_tree``. A tensor leaf of
        ``like_tree`` receives the stored values in place, on its own
        device (so a restore onto the card holds one copy of the state);
        with ``device``, every leaf comes back as a tensor there; other
        leaves come back as numpy arrays, as the reference's do."""
        d = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        leaves = {}
        for key, like in _flatten_with_paths(like_tree):
            meta = by_key[key]
            arr = self.get_chunk(meta["chunk"]).reshape(meta["shape"])
            leaves[key] = _restore(arr, like, device)
        return _unflatten(like_tree, leaves)


# -- module-level conveniences (the reference's exports) --------------------

def save_checkpoint(root: str, step: int, tree) -> None:
    CheckpointStore(root).save(step, tree)


def load_checkpoint(root: str, step: int, like_tree, device=None):
    return CheckpointStore(root).load(step, like_tree, device)


def latest_step(root: str) -> int | None:
    return CheckpointStore(root).latest_step()
