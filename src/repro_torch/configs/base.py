"""ArchDef / Shape plumbing shared by every architecture config.

Shape cells (assigned):
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                   KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     -> serve_step; sub-quadratic
                                                   archs only (SSM/hybrid)

``input_specs`` describes every model input of a cell as ``meta`` tensors
(shape and dtype, no memory), the port's stand-in for the reference's
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str                  # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

SMOKE_SHAPES = {
    "train_4k": Shape("train_4k", "train", 32, 2),
    "prefill_32k": Shape("prefill_32k", "prefill", 16, 1),
    "decode_32k": Shape("decode_32k", "decode", 32, 2),
    "long_500k": Shape("long_500k", "decode", 64, 1),
}


@dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    source: str                        # provenance note
    make_model: Callable               # (smoke: bool, tp_divisor: int) -> model
    subquadratic: bool = False         # may run long_500k
    modality_inputs: Callable | None = None   # (cfg, B, smoke) -> {name: spec}
    encoder_only: bool = False

    def model(self, smoke: bool = False, tp_divisor: int = 1, **kw):
        return self.make_model(smoke, tp_divisor, **kw)


def applicable_shapes(arch: ArchDef) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    out = []
    for n in names:
        s = SHAPES[n]
        if n == "long_500k" and not arch.subquadratic:
            continue          # needs sub-quadratic attention
        if s.kind == "decode" and arch.encoder_only:
            continue          # encoder-only archs have no decode step
        out.append(n)
    return out


def draw_modality_inputs(arch: ArchDef, cfg, B: int, smoke: bool, rng,
                         device) -> dict:
    """The arch's modality inputs (a VLM's patch embeddings) for a batch
    of ``B``, drawn from the numpy generator ``rng`` as the reference's
    entry points draw them (normal x 0.25, then each spec's dtype), on
    ``device``; {} for an arch without them."""
    if arch.modality_inputs is None:
        return {}
    return {k: torch.from_numpy(rng.normal(size=v.shape) * 0.25).to(
        device, v.dtype) for k, v in arch.modality_inputs(cfg, B, smoke).items()}


def _tok(B, S):
    return torch.empty((B, S), dtype=torch.int32, device="meta")


def input_specs(arch: ArchDef, shape_name: str, smoke: bool = False,
                model=None) -> dict:
    """``meta`` tensors standing in for every input of (arch, shape).

    train:   {'batch': {'tokens','labels'(+modality)}}
    prefill: {'batch': {'tokens'(+modality)}}
    decode:  {'cache': <model.cache_specs(B, S)>, 'tokens': (B,1)}
    """
    table = SMOKE_SHAPES if smoke else SHAPES
    s = table[shape_name]
    m = model if model is not None else arch.model(smoke=smoke)
    if s.kind in ("train", "prefill"):
        b = {"tokens": _tok(s.batch, s.seq)}
        if s.kind == "train":
            b["labels"] = _tok(s.batch, s.seq)
        if arch.modality_inputs:
            b.update(arch.modality_inputs(m.cfg, s.batch, smoke))
        return {"batch": b}
    # decode: one new token against a cache of length seq
    return {"cache": m.cache_specs(s.batch, s.seq),
            "tokens": _tok(s.batch, 1)}
