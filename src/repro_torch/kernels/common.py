"""Shared plumbing of the probe kernels: devices, host-to-tensor hand-off,
key blocking and the plain torch versions of the per-key lookups.

Device tensors carry uint32 bit patterns as int32 (``to_device``), so no
op on the card needs ``torch.uint32``. The plain lookups below (``bloom_hit``,
``xor_slots``, ``xor_lookup``) take int32 banks and key lanes of any shape
and compute in int64 lanes (``core.hashing``); they are what the CUDA
device functions in ``csrc/probe_common.cuh`` compute, and each kernel's
plain version is built from them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core.tables import pad_words

# the JAX package's (8, 128) key tile: ``blockify`` pads to it so the port
# accepts that package's [R, 128] key blocks; the CUDA kernels read keys
# flat and need no tile
BLOCK_ROWS = 8
BLOCK_COLS = 128
BLOCK = BLOCK_ROWS * BLOCK_COLS


def as_device(device) -> torch.device:
    """Validate an entry point's ``device``: a CUDA device must exist —
    nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' for the plain versions")
    return device


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor of the same bit patterns on
    ``device``. Copies (the source may be a frozen read-only array)."""
    a = np.array(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def key_lanes(keys: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """uint64 keys -> (hi, lo) int32 lane tensors on ``device``."""
    hi, lo = H.np_split_u64(keys)
    return to_device(hi, device), to_device(lo, device)


def check_probe_args(words: torch.Tensor, *lanes: torch.Tensor) -> None:
    """The wrappers' shared argument check: int32 tensors on one device,
    key lanes of one shape."""
    for t in (words, *lanes):
        if t.dtype != torch.int32:
            raise TypeError(f"probe tensors must be int32 bit patterns, "
                            f"got {t.dtype}")
        if t.device != words.device:
            raise ValueError("probe tensors must share one device")
    if any(t.shape != lanes[0].shape for t in lanes):
        raise ValueError("key lanes must share one shape")


# ---------------------------------------------------------------------------
# plain per-key lookups over a packed int32 bank (int64 lanes inside)
# ---------------------------------------------------------------------------

def gather(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """words[idx] as uint32 values in int64 lanes."""
    return H.u32(words[idx])


def bloom_hit(words, hi, lo, *, m_bits: int, k: int, seed: int,
              offset: int = 0) -> torch.Tensor:
    """Bloom membership over a packed word buffer -> bool, shape of hi."""
    out = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    for i in range(k):
        idx = H.t_hash_to_range(hi, lo, seed * 1000 + i, m_bits)
        w = gather(words, offset + (idx >> 5))
        out &= ((w >> (idx & 31)) & 1) == 1
    return out


def xor_slots(hi, lo, *, mode: str, seed: int, seg_len: int, n_seg: int,
              offset: int = 0):
    """The three Bloomier slot indices (uniform or fuse layout), pre-offset."""
    if mode == "uniform":
        return tuple(offset + i * seg_len
                     + H.t_hash_to_range(hi, lo, seed * 7919 + i, seg_len)
                     for i in range(3))
    start = H.t_hash_to_range(hi, lo, seed * 7919 + 3, n_seg - 2)
    return tuple(offset + (start + i) * seg_len
                 + H.t_hash_to_range(hi, lo, seed * 7919 + i, seg_len)
                 for i in range(3))


def xor_lookup(words, hi, lo, *, mode: str, seed: int, seg_len: int,
               n_seg: int, alpha: int, offset: int = 0) -> torch.Tensor:
    """BloomierTable.lookup over a packed buffer -> α-bit values (int64)."""
    s0, s1, s2 = xor_slots(hi, lo, mode=mode, seed=seed, seg_len=seg_len,
                           n_seg=n_seg, offset=offset)
    v = gather(words, s0) ^ gather(words, s1) ^ gather(words, s2)
    return v & ((1 << alpha) - 1)


# ---------------------------------------------------------------------------
# key blocks
# ---------------------------------------------------------------------------

def pad_table(table: np.ndarray, multiple: int = BLOCK_COLS) -> np.ndarray:
    return pad_words(table, multiple)


def blockify(hi: np.ndarray, lo: np.ndarray):
    """Pad key lanes to a whole number of (8,128) blocks; returns
    (hi2d, lo2d, n_valid)."""
    n = len(hi)
    pad = (-n) % BLOCK
    if pad:
        z = np.zeros(pad, dtype=np.uint32)
        hi = np.concatenate([np.asarray(hi, np.uint32), z])
        lo = np.concatenate([np.asarray(lo, np.uint32), z])
    rows = len(hi) // BLOCK_COLS
    return (np.asarray(hi, np.uint32).reshape(rows, BLOCK_COLS),
            np.asarray(lo, np.uint32).reshape(rows, BLOCK_COLS), n)


def unblockify(out2d: torch.Tensor, n_valid: int) -> torch.Tensor:
    return out2d.reshape(-1)[:n_valid]
