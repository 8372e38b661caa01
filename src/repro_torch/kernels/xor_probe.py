"""Bloomier-table probes: CUDA kernel + plain torch versions.

``xor_probe`` tests an α-bit Xor filter (α = 1…32): the key's three-slot
XOR, masked to α bits, must equal hash(fp_seed) masked alike.
``exact_probe`` tests a 1-bit exact Bloomier: the slot XOR's low bit must
equal hash(bit_seed) & 1 (strategy 'a') or 1 (strategy 'b'). Each reads
its table from word ``offset`` of a packed bank. Both are one test,
((v ^ target) & mask) == 0, so both launch the one kernel of
``csrc/xor_probe.cu`` with the fields ``bloomier_fields`` makes; each
wrapper counts its own launches. On a CPU tensor they run the plain
versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import MASK32
from . import _build, ref
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
# wrappers: the CUDA kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def xor_probe(words, hi, lo, *, mode: str, seed: int, seg_len: int,
              n_seg: int, alpha: int, fp_seed: int,
              offset: int = 0) -> torch.Tensor:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape.
    Returns int32 of hi's shape (1 = maybe-member)."""
    check_probe_args(words, hi, lo)
    fields = xor_fields(words, mode=mode, seed=seed, seg_len=seg_len,
                        n_seg=n_seg, offset=offset, alpha=alpha,
                        fp_seed=fp_seed)
    if not words.is_cuda:
        return xor_probe_ref(words, hi, lo, mode=mode, seed=seed,
                             seg_len=seg_len, n_seg=n_seg, alpha=alpha,
                             fp_seed=fp_seed, offset=offset)
    out = _launch(words, hi, lo, fields)
    xor_probe.launches += 1
    return out


xor_probe.launches = 0


def exact_probe(words, hi, lo, *, mode: str, seed: int, seg_len: int,
                n_seg: int, strategy: str, bit_seed: int,
                offset: int = 0) -> torch.Tensor:
    """Exact 1-bit Bloomier probe -> int32 of hi's shape (1 = member)."""
    check_probe_args(words, hi, lo)
    fields = exact_fields(words, mode=mode, seed=seed, seg_len=seg_len,
                          n_seg=n_seg, offset=offset, strategy=strategy,
                          bit_seed=bit_seed)
    if not words.is_cuda:
        return exact_probe_ref(words, hi, lo, mode=mode, seed=seed,
                               seg_len=seg_len, n_seg=n_seg,
                               strategy=strategy, bit_seed=bit_seed,
                               offset=offset)
    out = _launch(words, hi, lo, fields)
    exact_probe.launches += 1
    return out


exact_probe.launches = 0
