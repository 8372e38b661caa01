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
``chained_probe`` launches one of two hand-written paths and counts the
launch, in ``launches`` and in ``onchip_launches`` or ``gather_launches``:
the on-chip path (``csrc/bloomier_onchip.cu``: both stages' narrow planes
in every block's shared memory) wherever ``bloomier_onchip.onchip_reason`` sends the probe
there, the gather path (``csrc/chained_probe.cu``) elsewhere. ``planes``
are the stages' ``bloomier_onchip.pack_plane`` in stage order (packed per
call where not given). ``chained_probe_onchip`` and
``chained_probe_gather`` call one path directly. On a CPU tensor each
runs its plain version.
"""
from __future__ import annotations

import torch

from . import _build, bloomier_onchip, ref
from .common import check_probe_args
from .xor_probe import (count_launch, exact_fields, exact_stage,
                        xor_fields, xor_stage)

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


def _stages(words, l1, l2, alpha, fp_seed, strategy, bit_seed):
    """(fields, on-chip stages) in stage order; stage 1 only with l1."""
    fields = (exact_fields(words, **_layout(l2), strategy=strategy,
                           bit_seed=bit_seed),)
    stages = (exact_stage(**_layout(l2), strategy=strategy,
                          bit_seed=bit_seed),)
    if l1 is not None:
        fields = (xor_fields(words, **_layout(l1), alpha=alpha,
                             fp_seed=fp_seed),) + fields
        stages = (xor_stage(**_layout(l1), alpha=alpha,
                            fp_seed=fp_seed),) + stages
    return fields, stages


def chained_probe(words, hi, lo, *, l1: tuple | None, l2: tuple, alpha: int,
                  fp_seed: int, strategy: str, bit_seed: int,
                  planes: tuple | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """words: int32 [W] packed bank holding both stages; hi/lo: int32 key
    lanes of any shape. Returns (member, probes) int32 of hi's shape. On
    the card the on-chip path serves every probe that
    ``bloomier_onchip.onchip_reason`` sends to it, the gather path every
    other."""
    args = dict(l1=l1, l2=l2, alpha=alpha, fp_seed=fp_seed,
                strategy=strategy, bit_seed=bit_seed)
    check_probe_args(words, hi, lo)
    _, stages = _stages(words, **args)
    if not words.is_cuda:
        return chained_probe_ref(words, hi, lo, **args)
    if bloomier_onchip.stages_reason(stages, hi.numel()) is None:
        return chained_probe_onchip(words, hi, lo, **args, planes=planes)
    return chained_probe_gather(words, hi, lo, **args)


def chained_probe_gather(words, hi, lo, *, l1: tuple | None, l2: tuple,
                         alpha: int, fp_seed: int, strategy: str,
                         bit_seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``chained_probe``'s gather path (``csrc/chained_probe.cu``) on any
    probe."""
    args = dict(l1=l1, l2=l2, alpha=alpha, fp_seed=fp_seed,
                strategy=strategy, bit_seed=bit_seed)
    check_probe_args(words, hi, lo)
    fields, _ = _stages(words, **args)
    if not words.is_cuda:
        return chained_probe_ref(words, hi, lo, **args)
    # without stage 1 the kernel reads no stage-1 fields
    stage1, stage2 = fields[0], fields[-1]
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    member, probes = torch.empty_like(hi), torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("chained_probe").chained_probe_launch(
            words.data_ptr(), hi.data_ptr(), lo.data_ptr(), member.data_ptr(),
            probes.data_ptr(), int(l1 is not None), stage1, stage2,
            hi.numel(), torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(err, "chained_probe")
    count_launch(chained_probe, "gather")
    return member, probes


def chained_probe_onchip(words, hi, lo, *, l1: tuple | None, l2: tuple,
                         alpha: int, fp_seed: int, strategy: str,
                         bit_seed: int, planes: tuple | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``chained_probe``'s on-chip path (``csrc/bloomier_onchip.cu``) on
    any probe whose planes fit one block (``bloomier_onchip.plan``). On the
    CPU: its plain version, every slot read from the planes."""
    check_probe_args(words, hi, lo)
    fields, stages = _stages(words, l1, l2, alpha, fp_seed, strategy,
                             bit_seed)
    member, probes = bloomier_onchip.run(
        words, hi, lo, stages, fields, planes=planes, with_probes=True, what="chained_probe")
    if words.is_cuda:
        count_launch(chained_probe, "onchip")
    return member, probes


# launches of either path, and of each
chained_probe.launches = chained_probe.onchip_launches = 0
chained_probe.gather_launches = 0
