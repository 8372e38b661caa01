"""Batched Bloom-filter probe: CUDA kernel + plain torch version.

Hash i of a key selects bit ``fastrange(hash(seed·1000+i), m_bits)`` of
the filter's bitmap, read from its word ``offset`` in a packed bank; the
key is a maybe-member iff all k bits are set. On a CUDA tensor
``bloom_probe`` launches ``csrc/bloom_probe.cu`` and counts the launch; on
a CPU tensor it runs ``bloom_probe_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import MASK32
from . import _build
from .common import bloom_hit, check_probe_args


def bloom_probe_ref(words, hi, lo, *, m_bits: int, k: int, seed: int,
                    offset: int = 0) -> torch.Tensor:
    """Plain version -> int32 of hi's shape (1 = maybe-member)."""
    return bloom_hit(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                     offset=offset).to(torch.int32)


def bloom_probe(words, hi, lo, *, m_bits: int, k: int, seed: int,
                offset: int = 0) -> torch.Tensor:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape.
    Returns int32 of hi's shape (1 = maybe-member)."""
    check_probe_args(words, hi, lo)
    if not 0 < m_bits < 2 ** 31:
        raise ValueError(f"m_bits must be in (0, 2**31), got {m_bits}")
    if not words.is_cuda:
        return bloom_probe_ref(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                               offset=offset)
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    out = torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("bloom_probe").bloom_probe_launch(
            words.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(),
            m_bits, k, seed & MASK32, offset, hi.numel(),
            torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(err, "bloom_probe")
    bloom_probe.launches += 1
    return out


bloom_probe.launches = 0
