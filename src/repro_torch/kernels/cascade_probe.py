"""Fused ChainedFilterCascade probe (paper §4, Algorithm 2): CUDA kernel +
plain torch version.

A cascade is L Bloom layers in one packed bank, each ``(m_bits, k, seed,
offset)`` (``CascadeLayout.probe_params()``). Per key, ``first_zero`` is
the first layer (1-based) that misses, or L+1; the key is a member iff
``first_zero`` is even, or L is odd when no layer misses. The probe also
returns the sequential probe count min(first_zero, L): the layers a
short-circuiting querier touches (§5.3/§5.4 accounting).

The CUDA kernels take the layers as data, an int32 [L, DESC_K] descriptor
on the bank's device (``cascade_descriptors``), built once per published
bank and staged in shared memory per block, so any L >= 1 runs on one
build — ``train`` appends layers without a cap. On a CUDA tensor
``cascade_probe`` launches one of two hand-written paths and counts the
launch, in ``launches`` and in ``onchip_launches`` or ``gather_launches``:
the on-chip path (``csrc/bloom_onchip.cu``: persistent blocks, the
descriptors and, where it fits one block, the bank span of all layers in
shared memory; up to ``bloom_onchip.MAX_LAYERS`` layers) wherever
``bloom_onchip.onchip_reason`` sends the probe there, the gather path
(``csrc/cascade_probe.cu``, one thread per key, any L) elsewhere. Both
give the same bits. ``cascade_probe_onchip`` and ``cascade_probe_gather``
call one path directly. On a CPU tensor each runs its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import MASK32
from . import _build, bloom_onchip, ref
from .common import check_bloom_layers, check_probe_args

DESC_K = 4          # m_bits, k, seed, offset


def cascade_descriptors(layers: tuple) -> np.ndarray:
    """int32 [L, DESC_K] kernel descriptor (uint32 bit patterns) of the
    layers' (m_bits, k, seed, offset)."""
    rows = [[int(v) & MASK32 for v in layer] for layer in layers]
    return np.array(rows, np.uint32).reshape(len(layers), DESC_K).view(np.int32)


def cascade_probe_ref(words, hi, lo, *, layers: tuple
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> (member, probes) int32 of hi's shape."""
    hits = [ref.bloom_probe_ref(words, hi, lo, m_bits=m, k=k, seed=s,
                                offset=o) for m, k, s, o in layers]
    member, first_zero = ref.cascade_decide(hits)
    probes = torch.clamp(first_zero, max=len(layers))
    return member.to(torch.int32), probes.to(torch.int32)


def _check(words, hi, lo, desc, layers: tuple) -> None:
    check_probe_args(words, hi, lo)
    check_probe_args(words, desc)
    check_bloom_layers(words, layers)
    if desc.shape != (len(layers), DESC_K):
        raise ValueError(f"desc must be [{len(layers)}, {DESC_K}], "
                         f"got {list(desc.shape)}")
    if not words.is_cuda and not torch.equal(
            desc, torch.from_numpy(cascade_descriptors(layers))):
        raise ValueError("desc is not cascade_descriptors(layers)")


def cascade_probe(words, hi, lo, desc, *, layers: tuple
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape;
    desc: ``cascade_descriptors(layers)`` on the bank's device. Returns
    (member, probes) int32 of hi's shape. On the card the on-chip path
    serves every probe that ``bloom_onchip.onchip_reason`` sends to it,
    the gather path every other."""
    _check(words, hi, lo, desc, layers)
    if not words.is_cuda:
        return cascade_probe_ref(words, hi, lo, layers=layers)
    words = words.contiguous()
    if bloom_onchip.onchip_reason(layers, hi.numel(), words.numel(),
                                  words.data_ptr()) is None:
        return cascade_probe_onchip(words, hi, lo, desc, layers=layers)
    return cascade_probe_gather(words, hi, lo, desc, layers=layers)


def cascade_probe_gather(words, hi, lo, desc, *, layers: tuple
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cascade_probe``'s gather path (one thread per key, every bit read
    from the bank in global memory) on any cascade."""
    _check(words, hi, lo, desc, layers)
    if not words.is_cuda:
        return cascade_probe_ref(words, hi, lo, layers=layers)
    words, desc = words.contiguous(), desc.contiguous()
    hi, lo = hi.contiguous(), lo.contiguous()
    member, probes = torch.empty_like(hi), torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("cascade_probe").cascade_probe_launch(
            words.data_ptr(), desc.data_ptr(), len(layers), hi.data_ptr(),
            lo.data_ptr(), member.data_ptr(), probes.data_ptr(), hi.numel(),
            torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(err, "cascade_probe")
    cascade_probe.launches += 1
    cascade_probe.gather_launches += 1
    return member, probes


def cascade_probe_onchip(words, hi, lo, desc, *, layers: tuple
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cascade_probe``'s on-chip path (``csrc/bloom_onchip.cu``) on any
    cascade of at most ``bloom_onchip.MAX_LAYERS`` layers; raises
    ValueError above. On the CPU: its plain version, reading the span
    where the kernel's plan keeps it."""
    _check(words, hi, lo, desc, layers)
    bloom_onchip.check(layers)
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    if not words.is_cuda:
        return bloom_onchip.onchip_ref(words, hi, lo, layers=layers)
    out = bloom_onchip.cascade_launch(words, hi, lo, desc.contiguous(),
                                      layers=layers)
    cascade_probe.launches += 1
    cascade_probe.onchip_launches += 1
    return out


# launches of either path, and of each
cascade_probe.launches = cascade_probe.onchip_launches = 0
cascade_probe.gather_launches = 0
