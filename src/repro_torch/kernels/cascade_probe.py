"""Fused ChainedFilterCascade probe (paper §4, Algorithm 2): CUDA kernel +
plain torch version.

A cascade is L Bloom layers in one packed bank, each ``(m_bits, k, seed,
offset)`` (``CascadeLayout.probe_params()``). Per key, ``first_zero`` is
the first layer (1-based) that misses, or L+1; the key is a member iff
``first_zero`` is even, or L is odd when no layer misses. The probe also
returns the sequential probe count min(first_zero, L): the layers a
short-circuiting querier touches (§5.3/§5.4 accounting).

The CUDA kernel takes the layers as data, an int32 [L, DESC_K] descriptor
on the bank's device (``cascade_descriptors``), built once per published
bank and staged in shared memory per block, so any L >= 1 runs on one
build — ``train`` appends layers without a cap. On a CUDA tensor
``cascade_probe`` launches ``csrc/cascade_probe.cu`` and counts the
launch; on a CPU tensor it runs ``cascade_probe_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import MASK32
from . import _build, ref
from .common import check_probe_args

DESC_K = 4          # m_bits, k, seed, offset


def cascade_descriptors(layers: tuple) -> np.ndarray:
    """int32 [L, DESC_K] kernel descriptor (uint32 bit patterns) of the
    layers' (m_bits, k, seed, offset)."""
    rows = [[int(v) & MASK32 for v in layer] for layer in layers]
    return np.array(rows, np.uint32).reshape(len(layers), DESC_K).view(np.int32)


def _check_layers(words: torch.Tensor, layers: tuple) -> None:
    if len(layers) == 0:
        raise ValueError("a cascade needs at least one layer")
    for m_bits, k, _, offset in layers:
        if not 0 < m_bits < 2 ** 31:
            raise ValueError(f"m_bits must be in (0, 2**31), got {m_bits}")
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        if offset < 0 or offset + (m_bits + 31) // 32 > words.numel():
            raise ValueError(f"layer at word {offset} ({m_bits} bits) lies "
                             f"outside the {words.numel()}-word bank")


def cascade_probe_ref(words, hi, lo, *, layers: tuple
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> (member, probes) int32 of hi's shape."""
    hits = [ref.bloom_probe_ref(words, hi, lo, m_bits=m, k=k, seed=s,
                                offset=o) for m, k, s, o in layers]
    member, first_zero = ref.cascade_decide(hits)
    probes = torch.clamp(first_zero, max=len(layers))
    return member.to(torch.int32), probes.to(torch.int32)


def cascade_probe(words, hi, lo, desc, *, layers: tuple
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape;
    desc: ``cascade_descriptors(layers)`` on the bank's device. Returns
    (member, probes) int32 of hi's shape."""
    check_probe_args(words, hi, lo)
    check_probe_args(words, desc)
    _check_layers(words, layers)
    if desc.shape != (len(layers), DESC_K):
        raise ValueError(f"desc must be [{len(layers)}, {DESC_K}], "
                         f"got {list(desc.shape)}")
    if not words.is_cuda:
        if not torch.equal(desc, torch.from_numpy(cascade_descriptors(layers))):
            raise ValueError("desc is not cascade_descriptors(layers)")
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
    return member, probes


cascade_probe.launches = 0
