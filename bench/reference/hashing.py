"""32-bit lane hashing of uint64 keys, host numpy only.

Frozen copy of the numpy half of ``repro_torch/core/hashing.py``: keys are
carried as (hi, lo) uint32 lanes and mixed with murmur3's fmix32; range
reduction is Lemire's fastrange ``(h * n) >> 32``.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32
_FMIX_C1 = 0x85EB_CA6B
_FMIX_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9


def np_split_u64(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys -> (hi, lo) uint32 lanes."""
    keys = np.asarray(keys, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFF_FFFF)).astype(U32)
    hi = (keys >> np.uint64(32)).astype(U32)
    return hi, lo


def np_fmix32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=U32)
    with np.errstate(over="ignore"):
        x ^= x >> U32(16)
        x = (x * U32(_FMIX_C1)) & U32(0xFFFF_FFFF)
        x ^= x >> U32(13)
        x = (x * U32(_FMIX_C2)) & U32(0xFFFF_FFFF)
        x ^= x >> U32(16)
    return x


def np_hash_u32(hi: np.ndarray, lo: np.ndarray, seed: int) -> np.ndarray:
    """Avalanche hash of a (hi, lo) key pair with a seed; returns uint32."""
    with np.errstate(over="ignore"):
        h = np_fmix32(lo ^ U32(seed & 0xFFFF_FFFF))
        h = np_fmix32(h ^ hi ^ (U32(seed & 0xFFFF_FFFF) * U32(_GOLDEN)))
    return h


def np_fastrange(h: np.ndarray, n: int) -> np.ndarray:
    """Map a uint32 hash uniformly onto [0, n) via the 64-bit product."""
    return ((h.astype(np.uint64) * np.uint64(n)) >> np.uint64(32)).astype(np.int64)


def np_hash_to_range(hi, lo, seed: int, n: int) -> np.ndarray:
    return np_fastrange(np_hash_u32(hi, lo, seed), n)
