"""Shared model substrate, its dense part: param specs, norms, rotary
embeddings, q-chunked softmax attention, the SwiGLU MLP and the
next-token cross entropy.

Conventions, as in the reference (``repro/models/common.py``):

- Params are nested dicts (and lists) of tensors with a parallel tree of
  ``ParamSpec``; the reference's keys and shapes, so weights carry across
  by ``params_from_numpy``.
- Compute dtype bf16 by default, params f32, softmax f32. Every weight is
  cast to the activations' dtype where it is used, as the reference does
  (XLA fuses those casts; eager torch does not, so a caller that runs many
  steps may hand in weights already in the compute dtype — the numbers are
  the same, since the cast is).
- The reference's ``shard_activation`` calls are no-ops without a mesh;
  the port has no ``sharding/`` yet and leaves them out.

- Training differentiates these functions with torch autograd. Two
  carry a hand-written backward that keeps the reference's dtypes: the
  embedding (its custom VJP) and ``matmul_f32`` on the card.

MoE (``moe_block``) waits with the other model families (ROADMAP.md,
Queue 1 item 7).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple            # logical axis names, same rank as shape
    dtype: torch.dtype = torch.float32
    init: str = "normal"   # 'normal' | 'zeros' | 'ones'
    scale: float = 1.0


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_from_specs(specs, generator: torch.Generator, device="cuda"):
    """Materialize a tree of ParamSpec on ``device``, normal leaves drawn
    from ``generator`` (a generator of that device) with std
    ``scale / sqrt(fan_in)``. The draws cannot match ``jax.random``; weights
    that must equal the reference's go through ``params_from_numpy``."""
    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = spec.shape[0] if len(spec.shape) else 1
        std = spec.scale / math.sqrt(max(1, fan_in))
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(std).to(spec.dtype)
    return tree_map(one, specs)


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (the reference's ``jax.tree.map(np.asarray,
    params)``) as the port's params: same keys, shapes, dtypes and values,
    on ``device``. The reference's AdamW state carries the same way
    (``m`` and ``v`` as params, ``step`` a 0-d int32), so a JAX train
    state continues in the port."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

COMPUTE_DTYPE = torch.bfloat16


def set_compute_dtype(dtype) -> None:
    """bf16 is the serving dtype on the card; the CPU comparisons with the
    reference run f32 (the reference's CPU paths switch the same way)."""
    global COMPUTE_DTYPE
    COMPUTE_DTYPE = dtype


class _EmbedLookup(torch.autograd.Function):
    """The reference's ``_embed_lookup`` custom VJP: the forward gathers
    rows (then casts to the compute dtype: the same values as casting the
    table first); the backward scatter-adds ``dx`` into zeros of ``dx``'s
    own dtype (bf16 at bf16 compute) and only then casts to the table's
    dtype. Autograd's own gradient of the gather would accumulate in the
    table's f32. On the card the scatter uses atomics unless
    ``torch.use_deterministic_algorithms(True)`` is on, which makes
    ``index_add_`` sort its indices and sum each row in one order."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return torch.nn.functional.embedding(tokens, table).to(COMPUTE_DTYPE)

    @staticmethod
    def backward(ctx, dx):
        (tokens,) = ctx.saved_tensors
        d = ctx.table_shape[1]
        d_table = torch.zeros(ctx.table_shape, dtype=dx.dtype, device=dx.device)
        d_table.index_add_(0, tokens.reshape(-1), dx.reshape(-1, d))
        return d_table.to(ctx.table_dtype), None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``, in the compute dtype, with the
    reference's embedding gradient (``_EmbedLookup``)."""
    return _EmbedLookup.apply(table, tokens)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 1e4):
    """positions [*(B,)S] -> (cos, sin) [..., dim/2] f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, dh]; cos/sin broadcastable [..., S, 1, dh/2]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two bf16 (or f16) CUDA tensors with an f32 result, and
    the transpose of the reference's ``preferred_element_type=f32``
    einsum as its backward: the f32 cotangent rounded to the inputs'
    dtype, products of that dtype summed in f32, each gradient in its
    input's dtype (the TPU's default-precision dot)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g2 @ b.t()).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            db = a.reshape(-1, a.shape[-1]).t() @ g2
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a [..., K], b [K, N]) with an f32 result: products of the
    inputs' dtype summed in f32, the reference's
    ``preferred_element_type=jnp.float32``. On the card a bf16 product
    writes f32 directly (``out_dtype``) rather than widening ``b``, and
    its backward is ``_MatmulF32``'s."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits [B,S,V] any float, labels
    int. With ``mask``, the mean over the positions it marks (at least
    one)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _gqa_scores(q, k):
    """q [B,Sq,H,dh], k [B,Sk,Hkv,dh] -> scores [B,H,Sq,Sk] (f32)."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    return s.reshape(B, Hkv * g, Sq, k.shape[1])


def _gqa_out(p, v):
    """p [B,H,Sq,Sk] f32, v [B,Sk,Hkv,dh] -> [B,Sq,H,dh] (f32)."""
    B, H, Sq, Sk = p.shape
    Hkv = v.shape[2]
    g = H // Hkv
    pg = p.reshape(B, Hkv, g, Sq, Sk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, v.shape[3])


def dense_attention(q, k, v, *, causal: bool, q_chunk: int = 4096,
                    q_offset: int = 0, window: int | None = None,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """Numerically-standard softmax attention, q-chunked so peak score
    memory is [B,H,q_chunk,Sk].

    q_offset: global position of q[0] (decode: cache length). kv_valid_len:
    mask out cache positions >= this (decode with static cache). Both are
    host ints, so no mask needs a device value on the host.
    """
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    n_chunks = max(1, (Sq + q_chunk - 1) // q_chunk)
    for ci in range(n_chunks):
        lo = ci * q_chunk
        hi = min(Sq, lo + q_chunk)
        s = _gqa_scores(q[:, lo:hi], k) * scale              # [B,H,cq,Sk] f32
        qpos = q_offset + torch.arange(lo, hi, device=q.device)
        neg = -1e30
        if causal:
            m = kpos[None, :] > qpos[:, None]
            if window is not None:
                m |= kpos[None, :] <= (qpos[:, None] - window)
            s = s.masked_fill(m[None, None], neg)
        if kv_valid_len is not None:
            s = s.masked_fill((kpos >= kv_valid_len)[None, None, None, :], neg)
        p = torch.softmax(s, dim=-1)
        outs.append(_gqa_out(p, v).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x, wi_gate, wi_up, wo):
    h = x @ wi_gate.to(x.dtype)
    u = x @ wi_up.to(x.dtype)
    h = torch.nn.functional.silu(h.float()).to(x.dtype) * u
    return h @ wo.to(x.dtype)


def swiglu_param_specs(d_model: int, d_ff: int) -> dict:
    return {
        "wi_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wi_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def pad_heads(n_heads: int, divisor: int) -> int:
    """Zero-padded head count for TP divisibility: padded heads have zero
    W_q/W_o rows, which leaves the function unchanged."""
    return ((n_heads + divisor - 1) // divisor) * divisor
