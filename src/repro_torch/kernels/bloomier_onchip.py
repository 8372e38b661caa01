"""On-chip path of ``xor_probe``, ``exact_probe`` and ``chained_probe``
(``csrc/bloomier_onchip.cu``): the narrow planes it reads, which probes it
serves, its launches, and its plain torch version.

A Bloomier match reads only the low α bits of each of its three slots
(α = 1 for an exact Bloomier). ``pack_plane`` makes a table's **plane**:
those bits as fields of ``field_width(α)`` bits (1, 2, 4, 8 or 16),
packed LSB-first into int32 words, so no field straddles a word. The
packed bank stays as it is; a plane is a derived device buffer, built
once per published bank (``FilterService``) or per call.

The kernel runs persistent blocks of ``THREADS`` threads; each copies the
probe's planes whole into its shared memory (one ``cp.async.bulk`` a
plane) and reads every slot there. ``plan`` places the planes where they
fit ``BLOCK_BYTES`` together, in any slot layout (uniform or fuse).
Planes that do not fit stay on the gather kernels: a cluster variant that
sharded them by fuse window across 2–8 blocks measured 2.3–6.6× slower
than the gather kernels and was removed (PERF.md, Findings).

``onchip_reason`` says where the wrappers send a probe: where
``chip_smoke.py`` phase 8's turns and crossover sweep measured this path
faster than the gather kernels (PERF.md, Findings; NVIDIA H100 80GB HBM3,
700 W): planes that fit one block, from ``MIN_KEYS`` keys on.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core import hashing as H
from repro_torch.core.hashing import MASK32
from . import _build
from .common import xor_slots

SMEM_BLOCK_BYTES = 232_448   # dynamic shared memory a block may opt into
STATIC_RESERVE = 1024        # left for the kernel's static shared memory
BLOCK_BYTES = SMEM_BLOCK_BYTES - STATIC_RESERVE   # the planes
THREADS = 1024               # csrc/bloomier_onchip.cu kThreads
MAX_WIDTH = 16               # no plane above α = 16
ALIGN = 16                   # cp.async.bulk address and size
# where the path was measured faster than the gather kernels
# (chip_smoke.py phase 8's crossover sweep; PERF.md, Findings)
MIN_KEYS = 1 << 17


class Plane(NamedTuple):
    """A table's narrow plane: int32 ``words`` (a multiple of 4, on the
    table's device) holding the low ``alpha`` bits of ``n_slots`` slots as
    fields of ``width`` bits."""
    words: torch.Tensor
    width: int
    alpha: int
    n_slots: int


class Geometry(NamedTuple):
    """What the plan needs of one stage: its slot layout and α."""
    mode: str
    seg_len: int
    n_seg: int
    alpha: int


class Plan(NamedTuple):
    """Where the planes lie in a block's shared memory: ``smem_words[k]``
    is stage k's first word, ``n_words[k]`` its words; ``smem_bytes`` the
    dynamic shared memory a block takes."""
    smem_words: tuple
    n_words: tuple
    smem_bytes: int


class Stage(NamedTuple):
    """One stage of a probe: its layout tuple (mode, seed, seg_len, n_seg,
    offset), α, and the test's target (``probe::BloomierParams``):
    hash(target) where ``hash_target``, else ``target`` itself."""
    layout: tuple
    alpha: int
    hash_target: bool
    target: int


def field_width(alpha: int) -> int | None:
    """The field width of an α-bit plane: the least power of two ≥ α, or
    None above ``MAX_WIDTH`` (no plane)."""
    if not 1 <= alpha <= 32:
        raise ValueError(f"alpha must be in [1, 32], got {alpha}")
    w = 1 << (alpha - 1).bit_length()
    return w if w <= MAX_WIDTH else None


def plane_words(n_slots: int, width: int) -> int:
    """Words of a plane of ``n_slots`` fields of ``width`` bits (a multiple
    of 4: the copy moves whole 16-byte units)."""
    return -(-n_slots * width // 128) * 4


def pack_plane(words: torch.Tensor, layout: tuple, bits: int) -> Plane:
    """The plane of the Bloomier table at ``layout`` = (mode, seed,
    seg_len, n_seg, offset) in the int32 bank ``words``: the low ``bits``
    (α) of each slot, LSB-first, on the bank's device (torch ops: the same
    code on the card and on the CPU)."""
    width = field_width(bits)
    if width is None:
        raise ValueError(f"alpha {bits} > {MAX_WIDTH}: no plane")
    _, _, seg_len, n_seg, offset = layout
    n_slots = seg_len * n_seg
    if offset < 0 or offset + n_slots > words.numel():
        raise ValueError(f"table [{offset}, {offset + n_slots}) lies outside "
                         f"the {words.numel()}-word bank")
    per = 32 // width
    n_words = plane_words(n_slots, width)
    fields = torch.zeros(n_words * per, dtype=torch.int64, device=words.device)
    fields[:n_slots] = H.u32(words[offset:offset + n_slots]) & ((1 << bits) - 1)
    shifts = torch.arange(per, device=words.device, dtype=torch.int64) * width
    packed = (fields.view(n_words, per) << shifts).sum(dim=1)
    # uint32 bit patterns as int32
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return Plane(packed.to(torch.int32), width, bits, n_slots)


def geometry(layout: tuple, alpha: int) -> Geometry:
    mode, _, seg_len, n_seg, _ = layout
    return Geometry(mode, seg_len, n_seg, alpha)


def plan_reason(geos: tuple) -> tuple[Plan | None, str | None]:
    """(plan, None) where every stage has a plane and the planes fit one
    block together; else (None, why not)."""
    n_words = []
    for g in geos:
        width = field_width(g.alpha)
        if width is None:
            return None, f"alpha {g.alpha} > {MAX_WIDTH}: no plane"
        n_words.append(plane_words(g.seg_len * g.n_seg, width))
    smem_bytes = 4 * sum(n_words)
    if smem_bytes > BLOCK_BYTES:
        return None, (f"the planes take {smem_bytes} B, more than the "
                      f"{BLOCK_BYTES} B one block holds")
    return Plan(tuple(sum(n_words[:k]) for k in range(len(n_words))),
                tuple(n_words), smem_bytes), None


def plan(geos: tuple) -> Plan | None:
    return plan_reason(geos)[0]


def onchip_reason(geos: tuple, n_keys: int) -> str | None:
    """None where ``xor_probe`` / ``exact_probe`` / ``chained_probe`` take
    the on-chip path for ``n_keys`` keys over tables of ``geos`` (one
    ``Geometry`` a stage); else why not."""
    why = plan_reason(geos)[1]
    if why is None and n_keys < MIN_KEYS:
        why = (f"{n_keys} keys are too few to pay for staging the planes "
               f"(fewer than {MIN_KEYS})")
    return why


def stages_reason(stages: tuple, n_keys: int) -> str | None:
    """``onchip_reason`` of a probe's ``Stage`` s."""
    return onchip_reason(tuple(geometry(st.layout, st.alpha)
                               for st in stages), n_keys)


# ---------------------------------------------------------------------------
# plain version: the slots read from the planes
# ---------------------------------------------------------------------------

def plane_field(plane: Plane, slot: torch.Tensor) -> torch.Tensor:
    """The field of each slot (int64 lanes) read from the plane as the
    kernel reads it (``probe::SharedPlane``)."""
    lf = (32 // plane.width).bit_length() - 1
    w = H.u32(plane.words[slot >> lf])
    return (w >> ((slot & ((1 << lf) - 1)) * plane.width)) & (
        (1 << plane.width) - 1)


def _match(plane: Plane, hi, lo, st: Stage) -> torch.Tensor:
    """The Bloomier test of each key with every slot read from ``plane``."""
    mode, seed, seg_len, n_seg, _ = st.layout
    s0, s1, s2 = xor_slots(hi, lo, mode=mode, seed=seed, seg_len=seg_len,
                           n_seg=n_seg)
    v = plane_field(plane, s0) ^ plane_field(plane, s1) ^ plane_field(plane,
                                                                      s2)
    t = (H.t_hash_u32(hi, lo, st.target) if st.hash_target
         else torch.full_like(v, st.target))
    return ((v ^ t) & ((1 << st.alpha) - 1)) == 0


def onchip_ref(planes: tuple, stages: tuple, hi, lo
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the on-chip kernel -> (member, probes) int32 of
    hi's shape: each stage's slots read from its plane; with two stages,
    member = stage 1 AND stage 2 and probes = 1 + stage 1, else member =
    the one stage and probes = 1."""
    first = _match(planes[0], hi, lo, stages[0])
    if len(stages) == 1:
        return first.to(torch.int32), torch.ones_like(hi, dtype=torch.int32)
    member = first & _match(planes[1], hi, lo, stages[1])
    return member.to(torch.int32), 1 + first.to(torch.int32)


# ---------------------------------------------------------------------------
# launches (CUDA tensors; the wrappers in xor_probe.py and chained_probe.py
# call these)
# ---------------------------------------------------------------------------

def stage_words(fields: ctypes.Array, plane: Plane, p: Plan, k: int
                ) -> list[int]:
    """The kernel's 16 host words of stage k (csrc Stage): the 8
    ``probe::BloomierParams`` words, then the plane's."""
    per = 32 // plane.width
    return (list(fields)
            + [per.bit_length() - 1, plane.width.bit_length() - 1,
               (1 << plane.width) - 1, p.smem_words[k], p.n_words[k], 0, 0,
               0])


def grid_blocks(n_keys: int) -> int:
    """Blocks of THREADS threads for ``n_keys`` keys (the card caps them
    at one round of resident blocks)."""
    return max(1, math.ceil(n_keys / THREADS))


def launch(planes: tuple, fields: tuple, hi, lo, p: Plan, *,
           with_probes: bool, what: str
           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The on-chip kernel over contiguous int32 CUDA tensors: ``planes``
    and their stages' ``fields`` (``xor_probe.bloomier_fields``) in stage
    order -> (member, probes or None) int32 of hi's shape."""
    for pl, n in zip(planes, p.n_words, strict=True):
        if pl.words.data_ptr() % ALIGN or pl.words.numel() != n:
            raise ValueError("a plane is not the plan's 16-byte aligned words")
        if pl.words.device != hi.device:
            raise ValueError("planes and keys must share one device")
    host = []
    for k, (f, pl) in enumerate(zip(fields, planes)):
        host += stage_words(f, pl, p, k)
    words = (ctypes.c_uint32 * len(host))(*(int(v) & MASK32 for v in host))
    member = torch.empty_like(hi)
    probes = torch.empty_like(hi) if with_probes else None
    n = hi.numel()
    if n:
        with torch.cuda.device(hi.device):
            err = _build.lib("bloomier_onchip").bloomier_onchip_launch(
                words, len(planes), planes[0].words.data_ptr(),
                planes[-1].words.data_ptr(), p.smem_bytes, hi.data_ptr(),
                lo.data_ptr(), member.data_ptr(),
                0 if probes is None else probes.data_ptr(), n,
                grid_blocks(n),
                torch.cuda.current_stream(hi.device).cuda_stream)
        _build.check(err, f"{what} on-chip path")
    return member, probes


def run(words, hi, lo, stages: tuple, fields: tuple, *,
        planes: tuple | None = None, with_probes: bool = False,
        what: str = "probe") -> tuple[torch.Tensor, torch.Tensor | None]:
    """The on-chip path of one probe over int32 tensors, its planes packed
    here where not given -> (member, probes or None) int32 of hi's shape.
    On a CUDA tensor the kernel, on the CPU ``onchip_ref``. Raises
    ValueError where no plan holds the planes."""
    p, why = plan_reason(tuple(geometry(st.layout, st.alpha)
                               for st in stages))
    if p is None:
        raise ValueError(f"the on-chip path does not serve this probe: {why}")
    if planes is None:
        planes = tuple(pack_plane(words, st.layout, st.alpha)
                       for st in stages)
    for pl, st in zip(planes, stages, strict=True):
        if (pl.alpha, pl.n_slots) != (st.alpha, st.layout[2] * st.layout[3]):
            raise ValueError("a plane does not belong to this probe's table")
    hi, lo = hi.contiguous(), lo.contiguous()
    if not words.is_cuda:
        member, probes = onchip_ref(planes, stages, hi, lo)
        return member, (probes if with_probes else None)
    return launch(planes, fields, hi, lo, p, with_probes=with_probes,
                  what=what)
