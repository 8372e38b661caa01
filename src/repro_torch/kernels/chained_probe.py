"""Fused ChainedFilterAnd probe (stage 1 ∧ stage 2): CUDA kernel + plain
torch version.

Both stages live in one packed bank: an optional α-bit Xor stage 1 and a
1-bit exact Bloomier stage 2. Per key the probe returns membership and
the sequential probe count, 1 + stage-1 pass (a sequential querier
touches stage 2 only when stage 1 fires; the paper's Fig 7b accounting),
or 1 for a filter without stage 1 (λ < 2).

``l1``/``l2`` are the JAX package's layout tuples ``(mode, seed, seg_len,
n_seg, offset)``, ``l1`` None without stage 1 (``ops.chained_and_params``
makes them from a ``ChainedAndLayout``). On a CUDA tensor
``chained_probe`` launches ``csrc/chained_probe.cu`` and counts the
launch; on a CPU tensor it runs ``chained_probe_ref``.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import check_probe_args
from .xor_probe import exact_fields, xor_fields

_LAYOUT_KEYS = ("mode", "seed", "seg_len", "n_seg", "offset")


def _layout(t: tuple | None) -> dict | None:
    return None if t is None else dict(zip(_LAYOUT_KEYS, t))


def chained_probe_ref(words, hi, lo, *, l1: tuple | None, l2: tuple,
                      alpha: int, fp_seed: int, strategy: str, bit_seed: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version -> (member, probes) int32 of hi's shape."""
    s1, s2 = ref.chained_stages(words, words, hi, lo, l1=_layout(l1),
                                l2=_layout(l2), alpha=alpha, fp_seed=fp_seed,
                                strategy=strategy, bit_seed=bit_seed)
    member = (s1 & s2).to(torch.int32)
    probes = (torch.ones_like(member) if l1 is None
              else 1 + s1.to(torch.int32))
    return member, probes


def chained_probe(words, hi, lo, *, l1: tuple | None, l2: tuple, alpha: int,
                  fp_seed: int, strategy: str, bit_seed: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """words: int32 [W] packed bank holding both stages; hi/lo: int32 key
    lanes of any shape. Returns (member, probes) int32 of hi's shape."""
    check_probe_args(words, hi, lo)
    stage2 = exact_fields(words, **_layout(l2), strategy=strategy,
                          bit_seed=bit_seed)
    # without stage 1 the kernel reads no stage-1 fields
    stage1 = (stage2 if l1 is None else
              xor_fields(words, **_layout(l1), alpha=alpha, fp_seed=fp_seed))
    if not words.is_cuda:
        return chained_probe_ref(words, hi, lo, l1=l1, l2=l2, alpha=alpha,
                                 fp_seed=fp_seed, strategy=strategy,
                                 bit_seed=bit_seed)
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    member, probes = torch.empty_like(hi), torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("chained_probe").chained_probe_launch(
            words.data_ptr(), hi.data_ptr(), lo.data_ptr(), member.data_ptr(),
            probes.data_ptr(), int(l1 is not None), stage1, stage2,
            hi.numel(), torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(err, "chained_probe")
    chained_probe.launches += 1
    return member, probes


chained_probe.launches = 0
