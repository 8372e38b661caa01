"""Bloomier-table probes: CUDA kernel + plain torch versions.

``xor_probe`` tests an α-bit Xor filter (α = 1…32): the key's three-slot
XOR, masked to α bits, must equal hash(fp_seed) masked alike.
``exact_probe`` tests a 1-bit exact Bloomier: the slot XOR's low bit must
equal hash(bit_seed) & 1 (strategy 'a') or 1 (strategy 'b'). Each reads
its table from word ``offset`` of a packed bank. Both are one test,
((v ^ target) & mask) == 0, made from the fields ``bloomier_fields``
makes. On a CUDA tensor each launches one of two hand-written paths and
counts the launch, in ``launches`` and in ``onchip_launches`` or
``gather_launches``: the on-chip path (``csrc/bloomier_onchip.cu``: the
table's narrow plane, the low α bits of each slot, staged in every
block's shared memory) wherever
``bloomier_onchip.onchip_reason`` sends the probe there, the gather path
(``csrc/xor_probe.cu``, one thread per key, three slot words read from
the bank) elsewhere. Both give the same bits. ``plane`` is the table's
``bloomier_onchip.pack_plane`` (packed per call where not given).
``*_onchip`` and ``*_gather`` call one path directly. On a CPU tensor
each runs its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import MASK32
from . import _build, bloomier_onchip, ref
from .common import check_probe_args

_MODES = ("uniform", "fuse")
N_FIELDS = 8        # probe::BloomierParams in csrc/probe_common.cuh


def bloomier_fields(words: torch.Tensor, *, mode: str, seed: int,
                    seg_len: int, n_seg: int, offset: int, mask: int,
                    hash_target: bool, target: int) -> ctypes.Array:
    """One Bloomier table's kernel fields (``probe::BloomierParams``) as a
    ctypes uint32 array, after checking that the table's slots lie in
    ``words`` and that its ranges are below 2**31 (the plain versions'
    int64 fastrange is exact only there)."""
    if mode not in _MODES:
        raise ValueError(f"unknown slot-layout mode {mode!r}")
    if not 0 < seg_len < 2 ** 31:
        raise ValueError(f"seg_len must be in (0, 2**31), got {seg_len}")
    if n_seg < 3 or n_seg - 2 >= 2 ** 31:
        raise ValueError(f"n_seg must be in [3, 2**31 + 2), got {n_seg}")
    if offset < 0 or offset + n_seg * seg_len > words.numel():
        raise ValueError(f"table [{offset}, {offset + n_seg * seg_len}) "
                         f"lies outside the {words.numel()}-word bank")
    vals = [_MODES.index(mode), seed, seg_len, n_seg - 2, offset, mask,
            int(hash_target), target]
    return (ctypes.c_uint32 * N_FIELDS)(*(int(v) & MASK32 for v in vals))


def _launch(words, hi, lo, fields) -> torch.Tensor:
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    out = torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("xor_probe").bloomier_probe_launch(
            words.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(),
            fields, hi.numel(),
            torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(err, "bloomier_probe")
    return out


def xor_fields(words, *, mode: str, seed: int, seg_len: int, n_seg: int,
               offset: int, alpha: int, fp_seed: int) -> ctypes.Array:
    """Fields of an α-bit Xor filter: mask 2**α - 1, target
    hash(fp_seed)."""
    if not 1 <= alpha <= 32:
        raise ValueError(f"alpha must be in [1, 32], got {alpha}")
    return bloomier_fields(words, mode=mode, seed=seed, seg_len=seg_len,
                           n_seg=n_seg, offset=offset, mask=(1 << alpha) - 1,
                           hash_target=True, target=fp_seed)


def exact_fields(words, *, mode: str, seed: int, seg_len: int, n_seg: int,
                 offset: int, strategy: str, bit_seed: int) -> ctypes.Array:
    """Fields of an exact 1-bit Bloomier: mask 1, target hash(bit_seed)
    (strategy 'a') or 1 ('b')."""
    if strategy not in ("a", "b"):
        raise ValueError(f"strategy must be 'a' or 'b', got {strategy!r}")
    a = strategy == "a"
    return bloomier_fields(words, mode=mode, seed=seed, seg_len=seg_len,
                           n_seg=n_seg, offset=offset, mask=1, hash_target=a,
                           target=bit_seed if a else 1)


# ---------------------------------------------------------------------------
# plain versions -> int32 of hi's shape (1 = member)
# ---------------------------------------------------------------------------

def xor_probe_ref(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                  n_seg: int, alpha: int, fp_seed: int,
                  offset: int = 0) -> torch.Tensor:
    return ref.xor_probe_ref(words, hi, lo, mode=mode, seed=seed,
                             seg_len=seg_len, n_seg=n_seg, alpha=alpha,
                             fp_seed=fp_seed, offset=offset).to(torch.int32)


def exact_probe_ref(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                    n_seg: int, strategy: str, bit_seed: int,
                    offset: int = 0) -> torch.Tensor:
    return ref.exact_bloomier_ref(words, hi, lo, mode=mode, seed=seed,
                                  seg_len=seg_len, n_seg=n_seg,
                                  strategy=strategy, bit_seed=bit_seed,
                                  offset=offset).to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers: a CUDA kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def xor_stage(*, mode: str, seed: int, seg_len: int, n_seg: int, alpha: int,
              fp_seed: int, offset: int = 0) -> bloomier_onchip.Stage:
    """An α-bit Xor filter as the on-chip path takes it."""
    return bloomier_onchip.Stage((mode, seed, seg_len, n_seg, offset), alpha,
                                 True, fp_seed)


def exact_stage(*, mode: str, seed: int, seg_len: int, n_seg: int,
                strategy: str, bit_seed: int,
                offset: int = 0) -> bloomier_onchip.Stage:
    """An exact 1-bit Bloomier as the on-chip path takes it."""
    a = strategy == "a"
    return bloomier_onchip.Stage((mode, seed, seg_len, n_seg, offset), 1, a,
                                 bit_seed if a else 1)


def count_launch(fn, path: str) -> None:
    """One launch of ``fn``'s ``path`` (``onchip`` or ``gather``)."""
    fn.launches += 1
    setattr(fn, f"{path}_launches", getattr(fn, f"{path}_launches") + 1)


def xor_probe(words, hi, lo, *, mode: str, seed: int, seg_len: int,
              n_seg: int, alpha: int, fp_seed: int, offset: int = 0,
              plane=None) -> torch.Tensor:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape.
    Returns int32 of hi's shape (1 = maybe-member). On the card the
    on-chip path serves every probe that ``bloomier_onchip.onchip_reason``
    sends to it, the gather path every other."""
    args = dict(mode=mode, seed=seed, seg_len=seg_len, n_seg=n_seg,
                alpha=alpha, fp_seed=fp_seed, offset=offset)
    check_probe_args(words, hi, lo)
    xor_fields(words, **args)
    if not words.is_cuda:
        return xor_probe_ref(words, hi, lo, **args)
    if bloomier_onchip.stages_reason((xor_stage(**args),), hi.numel()) is None:
        return xor_probe_onchip(words, hi, lo, **args, plane=plane)
    return xor_probe_gather(words, hi, lo, **args)


def xor_probe_gather(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                     n_seg: int, alpha: int, fp_seed: int,
                     offset: int = 0) -> torch.Tensor:
    """``xor_probe``'s gather path (``csrc/xor_probe.cu``) on any probe."""
    args = dict(mode=mode, seed=seed, seg_len=seg_len, n_seg=n_seg,
                alpha=alpha, fp_seed=fp_seed, offset=offset)
    check_probe_args(words, hi, lo)
    fields = xor_fields(words, **args)
    if not words.is_cuda:
        return xor_probe_ref(words, hi, lo, **args)
    out = _launch(words, hi, lo, fields)
    count_launch(xor_probe, "gather")
    return out


def xor_probe_onchip(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                     n_seg: int, alpha: int, fp_seed: int, offset: int = 0,
                     plane=None) -> torch.Tensor:
    """``xor_probe``'s on-chip path (``csrc/bloomier_onchip.cu``) on any
    probe whose plane fits one block (``bloomier_onchip.plan``). On the
    CPU: its plain version, every slot read from the plane."""
    args = dict(mode=mode, seed=seed, seg_len=seg_len, n_seg=n_seg,
                alpha=alpha, fp_seed=fp_seed, offset=offset)
    check_probe_args(words, hi, lo)
    fields = xor_fields(words, **args)
    out, _ = bloomier_onchip.run(
        words, hi, lo, (xor_stage(**args),), (fields,),
        planes=None if plane is None else (plane,), what="xor_probe")
    if words.is_cuda:
        count_launch(xor_probe, "onchip")
    return out


def exact_probe(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                n_seg: int, strategy: str, bit_seed: int, offset: int = 0,
                plane=None) -> torch.Tensor:
    """Exact 1-bit Bloomier probe -> int32 of hi's shape (1 = member); the
    path as ``xor_probe`` picks it."""
    args = dict(mode=mode, seed=seed, seg_len=seg_len, n_seg=n_seg,
                strategy=strategy, bit_seed=bit_seed, offset=offset)
    check_probe_args(words, hi, lo)
    exact_fields(words, **args)
    if not words.is_cuda:
        return exact_probe_ref(words, hi, lo, **args)
    if bloomier_onchip.stages_reason((exact_stage(**args),),
                                     hi.numel()) is None:
        return exact_probe_onchip(words, hi, lo, **args, plane=plane)
    return exact_probe_gather(words, hi, lo, **args)


def exact_probe_gather(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                       n_seg: int, strategy: str, bit_seed: int,
                       offset: int = 0) -> torch.Tensor:
    """``exact_probe``'s gather path (``csrc/xor_probe.cu``) on any probe."""
    args = dict(mode=mode, seed=seed, seg_len=seg_len, n_seg=n_seg,
                strategy=strategy, bit_seed=bit_seed, offset=offset)
    check_probe_args(words, hi, lo)
    fields = exact_fields(words, **args)
    if not words.is_cuda:
        return exact_probe_ref(words, hi, lo, **args)
    out = _launch(words, hi, lo, fields)
    count_launch(exact_probe, "gather")
    return out


def exact_probe_onchip(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                       n_seg: int, strategy: str, bit_seed: int,
                       offset: int = 0, plane=None) -> torch.Tensor:
    """``exact_probe``'s on-chip path on any probe whose plane fits one
    block (``bloomier_onchip.plan``). On the CPU: its plain version, every
    slot read from the plane."""
    args = dict(mode=mode, seed=seed, seg_len=seg_len, n_seg=n_seg,
                strategy=strategy, bit_seed=bit_seed, offset=offset)
    check_probe_args(words, hi, lo)
    fields = exact_fields(words, **args)
    out, _ = bloomier_onchip.run(
        words, hi, lo, (exact_stage(**args),), (fields,),
        planes=None if plane is None else (plane,), what="exact_probe")
    if words.is_cuda:
        count_launch(exact_probe, "onchip")
    return out


# launches of either path, and of each
for _fn in (xor_probe, exact_probe):
    _fn.launches = _fn.onchip_launches = _fn.gather_launches = 0
