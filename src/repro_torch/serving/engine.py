"""Batched serving engine: prefill + greedy decode with a tiered prefix
cache in front of prefill.

A request's prompt prefix is hashed; a prefix-cache hit returns the stored
(logits, KV cache), skipping prefill of the shared prefix entirely — the
filter stack decides *which tier* to fetch from with ≤1 wasted probe
(prefix_cache.py), its tier bank probed on ``device`` by ``bloom_probe``.
The stored payload is a host copy, uploaded again on every hit, as the
reference stores it. Greedy sampling; eager torch (the reference jits
prefill and decode).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.common import as_device
from repro_torch.models import common as C

from .prefix_cache import TieredPrefixCache, TierSpec


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # int32 [S]
    max_new: int = 16
    output: list = field(default_factory=list)


def _prefix_key(tokens: np.ndarray) -> int:
    return int.from_bytes(hashlib.sha1(
        np.asarray(tokens, np.int32).tobytes()).digest()[:8], "little")


def payload_to_host(out):
    """A prefill's (logits, cache) as the prefix cache stores it: a copy on
    the host (a later write to the device tensors cannot reach it)."""
    return C.tree_map(lambda a: a.to("cpu", copy=True)
                      if isinstance(a, torch.Tensor) else a, out)


def payload_to_device(payload, device):
    """A stored payload on ``device``: uploaded from the host copy."""
    return C.tree_map(lambda a: a.to(device)
                      if isinstance(a, torch.Tensor) else a, payload)


class ServeEngine:
    """Serves ``model`` (any of the port's LMs: ``TransformerLM``, ``VLM``,
    ``Zamba2LM``, ``RWKV6LM``, ``EncDecLM``; the engine calls only
    ``prefill`` and ``decode_step`` and reads ``cache["len"]``) on
    ``device``: the card by default, ``"cpu"`` for the plain versions. The
    weights are held once in the compute dtype
    (``models.common.COMPUTE_DTYPE`` when the engine is made): the
    reference casts each weight inside every einsum, the same cast, so
    the numbers are the same and a decode step reads 2 B a bf16 weight
    instead of 4 + 2 + 2."""

    def __init__(self, model, params, max_len: int = 128,
                 cache_tiers: list[TierSpec] | None = None, seed: int = 0,
                 *, device="cuda"):
        self.device = as_device(device)
        self.model = model
        self.params = params
        self.compute_params = C.tree_map(
            lambda a: a.to(self.device, C.COMPUTE_DTYPE), params)
        self.max_len = max_len
        tiers = cache_tiers or [TierSpec("hbm", 8, 1.0),
                                TierSpec("dram", 32, 10.0),
                                TierSpec("ssd", 128, 150.0)]
        self.prefix_cache = TieredPrefixCache(tiers, seed=seed,
                                              device=self.device)
        self.prefill_tokens_total = 0
        self.prefill_tokens_saved = 0

    # -- single-request path with prefix reuse ------------------------------
    def _prefill_one(self, prompt: np.ndarray, extra: dict, *,
                     key: int | None = None, hit: tuple | None = None,
                     computed: dict | None = None):
        """``hit`` is a prefetched (payload, tier) from a batched
        ``lookup_batch`` probe; when absent, falls back to a synchronous
        per-key lookup. ``computed`` memoizes prefills within one run() so
        duplicate prefixes in a batch are prefilled (and inserted) once."""
        if key is None:
            key = _prefix_key(prompt)
        if hit is None:
            hit = self.prefix_cache.lookup(key)
        payload, _tier = hit
        self.prefill_tokens_total += len(prompt)
        if payload is not None:
            self.prefill_tokens_saved += len(prompt)
            return payload                  # (logits, cache) host copy
        if computed is not None and key in computed:
            # duplicate prefix later in the same batch: the prefetched probe
            # predates the insert, so re-lookup for LRU promotion and the
            # same accounting the sequential path would have paid
            cached, _ = self.prefix_cache.lookup(key)
            self.prefill_tokens_saved += len(prompt)
            return cached if cached is not None else computed[key]
        tokens = torch.from_numpy(np.asarray(prompt, np.int32)[None, :])
        batch = {"tokens": tokens.to(self.device)}
        batch.update(extra)
        out = self.model.prefill(self.compute_params, batch, self.max_len)
        self.prefix_cache.insert(key, payload_to_host(out), tier=0)
        if computed is not None:
            computed[key] = out
        return out

    def run(self, requests: list[Request], extra_inputs=None) -> list[Request]:
        """Serve each request (prefill with prefix-cache, then greedy
        decode). Tier admission for the whole batch goes through ONE
        fused FilterBank probe (prefix_cache.lookup_batch)."""
        extra = extra_inputs or {}
        keys = [_prefix_key(r.prompt) for r in requests]
        hits = self.prefix_cache.lookup_batch(keys)
        computed: dict = {}
        with torch.inference_mode():
            for req, key, hit in zip(requests, keys, hits):
                logits, cache = payload_to_device(
                    self._prefill_one(req.prompt, extra, key=key, hit=hit,
                                      computed=computed), self.device)
                tok = int(torch.argmax(logits[0, -1]))
                req.output.append(tok)
                for _ in range(req.max_new - 1):
                    if cache["len"] >= self.max_len:
                        break
                    step = torch.tensor([[tok]], dtype=torch.int32,
                                        device=self.device)
                    lg, cache = self.model.decode_step(self.compute_params,
                                                       cache, step)
                    tok = int(torch.argmax(lg[0, -1]))
                    req.output.append(tok)
        return requests

    def stats(self) -> dict:
        s = self.prefix_cache.stats()
        s["prefill_tokens_saved_frac"] = (
            self.prefill_tokens_saved / max(1, self.prefill_tokens_total))
        return s
