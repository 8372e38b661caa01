"""32-bit lane hashing for membership filters (host numpy + torch twins).

Keys are uint64, carried as two uint32 lanes ``(hi, lo)`` and mixed with
murmur3-style fmix32 avalanche steps; range reduction is Lemire's
"fastrange" ``(h * n) >> 32``. The numpy functions build filters on the
host; the torch functions are the plain versions of what the CUDA probe
kernels compute per key, and must agree with numpy bit for bit.

Torch on the CPU lacks ``>>`` for ``torch.uint32``, so the torch twins
carry every lane as int64 holding a value in ``[0, 2**32)``. Products are
split into 16-bit halves so that no intermediate leaves int64's range, and
the fastrange product ``h * n`` is exact only for ``n < 2**31`` (checked).
Device tensors hold uint32 bit patterns as int32; ``u32`` lifts them into
the int64 lane form.
"""
from __future__ import annotations

import numpy as np
import torch

U32 = np.uint32
_FMIX_C1 = 0x85EB_CA6B
_FMIX_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9
MASK32 = 0xFFFF_FFFF


# ---------------------------------------------------------------------------
# numpy (host / construction) path
# ---------------------------------------------------------------------------

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
    """Map uint32 hash uniformly onto [0, n) via the 64-bit product."""
    return ((h.astype(np.uint64) * np.uint64(n)) >> np.uint64(32)).astype(np.int64)


def np_hash_to_range(hi, lo, seed: int, n: int) -> np.ndarray:
    return np_fastrange(np_hash_u32(hi, lo, seed), n)


# ---------------------------------------------------------------------------
# torch (plain version of the device probes) — int64-carried uint32 lanes
# ---------------------------------------------------------------------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor of uint32 bit patterns -> int64 lanes in
    [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2**32 for lanes x < 2**32 and c an int or a lane tensor
    < 2**32, with every intermediate below 2**49."""
    c_lo = c & 0xFFFF
    c_hi = (c >> 16) & 0xFFFF
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & MASK32


def t_fmix32(x: torch.Tensor) -> torch.Tensor:
    """Twin of ``np_fmix32`` / the JAX package's ``jx_fmix32``."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _FMIX_C2)
    return x ^ (x >> 16)


def t_hash_u32(hi: torch.Tensor, lo: torch.Tensor, seed) -> torch.Tensor:
    """Twin of ``np_hash_u32`` / ``jx_hash_u32``. ``seed`` is a Python int
    (reduced mod 2**32) or an int64 lane tensor broadcasting against the
    keys."""
    s = seed & MASK32
    sg = (_mul32(s, _GOLDEN) if isinstance(s, torch.Tensor)
          else (s * _GOLDEN) & MASK32)
    h = t_fmix32(u32(lo) ^ s)
    return t_fmix32(h ^ u32(hi) ^ sg)


def t_mulhi32(a: torch.Tensor, b) -> torch.Tensor:
    """floor(a * b / 2**32) (twin of ``jx_mulhi32``) for lanes a < 2**32
    and b < 2**31, an int or a lane tensor: the int64 product stays below
    2**63."""
    if isinstance(b, torch.Tensor):
        if b.numel() and int(b.max()) >= 2 ** 31:
            raise ValueError("t_mulhi32 needs every range below 2**31")
    elif not 0 <= int(b) < 2 ** 31:
        raise ValueError(f"t_mulhi32 needs a range in [0, 2**31), got {b}")
    return (u32(a) * b) >> 32


def t_fastrange(h: torch.Tensor, n) -> torch.Tensor:
    return t_mulhi32(h, n)


def t_hash_to_range(hi, lo, seed, n) -> torch.Tensor:
    return t_fastrange(t_hash_u32(hi, lo, seed), n)


# ---------------------------------------------------------------------------
# key helpers
# ---------------------------------------------------------------------------

def random_keys(n: int, seed: int = 0) -> np.ndarray:
    """n distinct uint64 keys (the paper's '64-bit pre-generated random
    integers')."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, size=int(n * 1.1) + 16, dtype=np.uint64)
    keys = np.unique(keys)
    while keys.size < n:  # pragma: no cover — astronomically unlikely
        extra = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        keys = np.unique(np.concatenate([keys, extra]))
    return keys[:n]
