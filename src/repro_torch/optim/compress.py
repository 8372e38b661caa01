"""Gradient compression for the data-parallel all-reduce (the reference's
``repro/optim/compress.py``).

- **bf16**: cast grads to bf16 before the reduction and back after,
  half the bytes on the wire; the Adam update stays f32.
- **int8 + error feedback**: per-leaf max-abs scale, int8 quantize
  (``torch.round`` rounds half to even, as ``jnp.round`` does), carry the
  quantization residual into the next step (EF-SGD), a quarter of the
  bytes.

One device has no all-reduce; these are the same functions of the
gradients, for the multi-GPU split to put on the wire.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"            # 'none' | 'bf16' | 'int8_ef'


def _int8_ef(g, e):
    gf = g.float() + e
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    resid = gf - qi.float() * scale
    return qi, scale, resid


def compress_grads(cfg: CompressionConfig, grads, error_state=None):
    """Returns (wire_grads, aux) where wire_grads is what crosses the
    network. aux carries scales / residuals for decompress."""
    if cfg.mode == "none":
        return grads, None
    if cfg.mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), None
    if cfg.mode == "int8_ef":
        if error_state is None:
            error_state = tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        flat = [_int8_ef(g, e) for g, e in zip(tree_leaves(grads),
                                               tree_leaves(error_state))]
        wire, scales, resid = (tree_unflatten(grads, [t[i] for t in flat])
                               for i in range(3))
        return wire, {"scales": scales, "residual": resid}
    raise ValueError(f"unknown compression mode {cfg.mode!r}")


def decompress_grads(cfg: CompressionConfig, wire, aux):
    if cfg.mode == "none":
        return wire
    if cfg.mode == "bf16":
        return tree_map(lambda g: g.float(), wire)
    if cfg.mode == "int8_ef":
        return tree_unflatten(wire, [q.float() * s for q, s in zip(
            tree_leaves(wire), tree_leaves(aux["scales"]))])
    raise ValueError(cfg.mode)
