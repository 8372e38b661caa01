"""Batched Bloom-filter probe: CUDA kernels + plain torch version.

Hash i of a key selects bit ``fastrange(hash(seed·1000+i), m_bits)`` of
the filter's bitmap, read from its word ``offset`` in a packed bank; the
key is a maybe-member iff all k bits are set. On a CUDA tensor
``bloom_probe`` launches one of two hand-written paths and counts the
launch, in ``launches`` and in ``onchip_launches`` or ``gather_launches``:
the on-chip path (``csrc/bloom_onchip.cu``: persistent blocks, the bitmap
staged in shared memory where it fits one block) wherever
``bloom_onchip.onchip_reason`` sends the probe there, the gather path
(``csrc/bloom_probe.cu``, one thread per key) elsewhere. Both give the
same bits. ``bloom_probe_onchip`` and ``bloom_probe_gather`` call one
path directly. On a CPU tensor each runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import MASK32
from . import _build, bloom_onchip
from .common import bloom_hit, check_bloom_layers, check_probe_args


def bloom_probe_ref(words, hi, lo, *, m_bits: int, k: int, seed: int,
                    offset: int = 0) -> torch.Tensor:
    """Plain version -> int32 of hi's shape (1 = maybe-member)."""
    return bloom_hit(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                     offset=offset).to(torch.int32)


def _check(words, hi, lo, layer: tuple) -> None:
    check_probe_args(words, hi, lo)
    check_bloom_layers(words, (layer,))


def bloom_probe(words, hi, lo, *, m_bits: int, k: int, seed: int,
                offset: int = 0) -> torch.Tensor:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape.
    Returns int32 of hi's shape (1 = maybe-member). On the card the
    on-chip path serves every probe that ``bloom_onchip.onchip_reason``
    sends to it, the gather path every other."""
    layer = (m_bits, k, seed, offset)
    _check(words, hi, lo, layer)
    if not words.is_cuda:
        return bloom_probe_ref(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                               offset=offset)
    words = words.contiguous()
    if bloom_onchip.onchip_reason((layer,), hi.numel(), words.numel(),
                                  words.data_ptr()) is None:
        return bloom_probe_onchip(words, hi, lo, m_bits=m_bits, k=k,
                                  seed=seed, offset=offset)
    return bloom_probe_gather(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                              offset=offset)


def bloom_probe_gather(words, hi, lo, *, m_bits: int, k: int, seed: int,
                       offset: int = 0) -> torch.Tensor:
    """``bloom_probe``'s gather path (one thread per key, every bit read
    from the bank in global memory) on any probe."""
    _check(words, hi, lo, (m_bits, k, seed, offset))
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
    bloom_probe.gather_launches += 1
    return out


def bloom_probe_onchip(words, hi, lo, *, m_bits: int, k: int, seed: int,
                       offset: int = 0) -> torch.Tensor:
    """``bloom_probe``'s on-chip path (``csrc/bloom_onchip.cu``) on any
    probe. On the CPU: its plain version, reading the bitmap where the
    kernel's plan keeps it."""
    layer = (m_bits, k, seed, offset)
    _check(words, hi, lo, layer)
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    if not words.is_cuda:
        return bloom_onchip.onchip_ref(words, hi, lo, layers=(layer,))[0]
    out = bloom_onchip.bloom_launch(words, hi, lo, layer=layer)
    bloom_probe.launches += 1
    bloom_probe.onchip_launches += 1
    return out


# launches of either path, and of each
bloom_probe.launches = bloom_probe.onchip_launches = 0
bloom_probe.gather_launches = 0
