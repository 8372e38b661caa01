"""On-chip path of ``bloom_probe`` and ``cascade_probe``
(``csrc/bloom_onchip.cu``): which probes it serves, where it keeps the
bitmap, its launches, and its plain torch version.

The kernel runs persistent blocks of ``THREADS`` threads over the keys
with a grid stride, the layer descriptors in shared memory. A ``Plan``
says where its probes read the bitmap:

- ``LOCAL``: each block copies the span — the bitmap, or for a cascade the
  bank span from its first layer's offset to the end of its last — into
  shared memory (one ``cp.async.bulk``), up to ``BLOCK_BYTES`` with the
  descriptors, where it starts 16-byte aligned inside the bank;
- ``GLOBAL``: the probes read the bank in global memory (L2).

``fit_reason`` says where the kernel can take a probe at all (the layer
count); ``onchip_reason`` where the wrappers send it: where
``chip_smoke.py`` phase 8's crossover sweep measured the on-chip path
faster than the gather kernels (PERF.md, Findings; NVIDIA H100 80GB
HBM3, 700 W). At large batches a Bloom layer costs both paths alike, ~3.3×
the probes its keys need; the on-chip path wins where its shorter chains
of dependent reads matter:

- a cascade of at least ``MIN_LAYERS`` layers, staged or in L2, at any
  batch (one 16-byte descriptor load per layer from shared memory against
  the gather kernel's four, and, staged, reads from shared memory);
- a single layer (``bloom_probe``) only staged, from ``MIN_LOCAL_KEYS`` up
  to ``MAX_LOCAL_KEYS`` keys: below, the bitmap copy's latency is not paid
  back; above, the hashes bound both paths alike; in L2 the gather
  kernel, whose fields sit in registers, is faster.

No flag selects a path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build, ref
from .common import bloom_hit

SMEM_BLOCK_BYTES = 232_448   # dynamic shared memory a block may opt into
STATIC_RESERVE = 1024        # left for the kernel's static shared memory
BLOCK_BYTES = SMEM_BLOCK_BYTES - STATIC_RESERVE   # span + descriptors
DESC_BYTES = 16              # one layer: m_bits, k, seed, offset
MAX_LAYERS = 256             # csrc/bloom_onchip.cu kMaxLayers
ALIGN = 16                   # cp.async.bulk address and size
THREADS = 1024               # csrc/bloom_onchip.cu kThreads
LOCAL, GLOBAL = 0, 1
# where the path was measured faster than the gather kernels
# (chip_smoke.py phase 8's crossover sweep; PERF.md, Findings)
MIN_LAYERS = 2
MIN_LOCAL_KEYS = 1 << 17
MAX_LOCAL_KEYS = 1 << 20


class Plan(NamedTuple):
    """Where the probes read the bitmap. ``base``: the first staged word
    in the bank; ``stage_words``: words staged (a multiple of 4); both 0
    at ``GLOBAL``."""
    mode: int
    base: int
    stage_words: int


def span(layers: tuple) -> tuple[int, int]:
    """[first, end) bank words of the layers' bitmaps."""
    return (min(o for _, _, _, o in layers),
            max(o + (m + 31) // 32 for m, _, _, o in layers))


def block_words(n_layers: int) -> int:
    """Span words one block holds beside ``n_layers`` descriptors (a
    multiple of 4)."""
    return (BLOCK_BYTES - DESC_BYTES * n_layers) // 16 * 4


def plan(layers: tuple, bank_words: int, words_ptr: int = 0) -> Plan:
    """``LOCAL`` where the span, rounded to 16 bytes, fits one block, lies
    inside the bank and starts 16-byte aligned; else ``GLOBAL``."""
    base, end = span(layers)
    stage = -(-(end - base) // 4) * 4
    if (stage <= block_words(len(layers)) and base + stage <= bank_words
            and (words_ptr + 4 * base) % ALIGN == 0):
        return Plan(LOCAL, base, stage)
    return Plan(GLOBAL, 0, 0)


def fit_reason(layers: tuple) -> str | None:
    """None where the on-chip kernel can take ``layers``; else why not."""
    if len(layers) > MAX_LAYERS:
        return (f"{len(layers)} layers exceed the {MAX_LAYERS} whose "
                "descriptors the kernel stages")
    return None


def onchip_reason(layers: tuple, n_keys: int, bank_words: int,
                  words_ptr: int = 0) -> str | None:
    """None where ``bloom_probe`` / ``cascade_probe`` take the on-chip path
    for ``n_keys`` keys over a bank of ``bank_words`` words at device
    address ``words_ptr``; else why not."""
    why = fit_reason(layers)
    if why is not None or len(layers) >= MIN_LAYERS:
        return why
    if plan(layers, bank_words, words_ptr).mode != LOCAL:
        return ("one layer whose bitmap is not staged: the gather kernel is "
                "faster")
    if n_keys < MIN_LOCAL_KEYS:
        return (f"{n_keys} keys are too few to pay for the bitmap copy "
                f"(fewer than {MIN_LOCAL_KEYS})")
    if n_keys >= MAX_LOCAL_KEYS:
        return (f"{n_keys} keys: from {MAX_LOCAL_KEYS} on, the gather "
                "kernel is as fast")
    return None


def check(layers: tuple) -> None:
    """Raise ValueError where ``fit_reason`` refuses the probe."""
    why = fit_reason(layers)
    if why is not None:
        raise ValueError(f"the on-chip path does not serve this probe: {why}")


# ---------------------------------------------------------------------------
# plain version: the bitmap read where the plan keeps it
# ---------------------------------------------------------------------------

def staged_ref(words: torch.Tensor, p: Plan) -> torch.Tensor:
    """The words the probes read: the staged span at ``LOCAL`` (layer
    offsets rebased by ``p.base``), the bank at ``GLOBAL``."""
    return words[p.base:p.base + p.stage_words] if p.mode == LOCAL else words


def onchip_ref(words, hi, lo, *, layers: tuple, p: Plan | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the on-chip kernel -> (member, probes) int32 of
    hi's shape: each layer's bits read from ``staged_ref`` at its rebased
    offset, the first-zero parity rule over the layers (for one layer,
    member is the Bloom test)."""
    p = plan(layers, words.numel()) if p is None else p
    held = staged_ref(words, p)
    hits = [bloom_hit(held, hi, lo, m_bits=m, k=k, seed=s, offset=o - p.base)
            for m, k, s, o in layers]
    member, first_zero = ref.cascade_decide(hits)
    probes = torch.clamp(first_zero, max=len(layers))
    return member.to(torch.int32), probes.to(torch.int32)


# ---------------------------------------------------------------------------
# launches (CUDA tensors; the wrappers in bloom_probe.py and
# cascade_probe.py call these)
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _args(words, p: Plan) -> tuple:
    return (words.data_ptr() + 4 * p.base, p.base, p.stage_words, p.mode)


def grid_blocks(n_keys: int) -> int:
    """Blocks of THREADS threads for ``n_keys`` keys (the card caps them
    at one round of resident blocks)."""
    return max(1, math.ceil(n_keys / THREADS))


def bloom_launch(words, hi, lo, *, layer: tuple) -> torch.Tensor:
    """The on-chip kernel for one Bloom filter over contiguous int32
    tensors -> int32 of hi's shape."""
    p = plan((layer,), words.numel(), words.data_ptr())
    out = torch.empty_like(hi)
    n = hi.numel()
    if n:
        m_bits, k, seed, offset = (int(v) & 0xFFFFFFFF for v in layer)
        with torch.cuda.device(words.device):
            err = _build.lib("bloom_onchip").bloom_onchip_launch(
                *_args(words, p), m_bits, k, seed, offset, hi.data_ptr(),
                lo.data_ptr(), out.data_ptr(), n, grid_blocks(n),
                _stream(words))
        _build.check(err, "bloom_probe on-chip path")
    return out


def cascade_launch(words, hi, lo, desc, *, layers: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The on-chip kernel for a cascade over contiguous int32 tensors;
    ``desc`` its int32 [L, 4] descriptor (16-byte aligned) -> (member,
    probes) int32 of hi's shape."""
    p = plan(layers, words.numel(), words.data_ptr())
    if desc.data_ptr() % ALIGN:
        raise ValueError("the layer descriptor is not 16-byte aligned")
    member, probes = torch.empty_like(hi), torch.empty_like(hi)
    n = hi.numel()
    if n:
        with torch.cuda.device(words.device):
            err = _build.lib("bloom_onchip").cascade_onchip_launch(
                *_args(words, p), desc.data_ptr(), len(layers),
                hi.data_ptr(), lo.data_ptr(), member.data_ptr(),
                probes.data_ptr(), n, grid_blocks(n), _stream(words))
        _build.check(err, "cascade_probe on-chip path")
    return member, probes
