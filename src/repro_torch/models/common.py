"""Shared model substrate: param specs, norms, rotary embeddings,
q-chunked softmax attention, the SwiGLU MLP, the token-choice MoE block
and the next-token cross entropy.

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
  the port's ``sharding/`` has the rules but no activation context yet,
  so the models leave those calls out.

- Training differentiates these functions with torch autograd. Two
  carry a hand-written backward that keeps the reference's dtypes: the
  embedding (its custom VJP) and ``matmul_f32`` on the card.
- ``moe_block`` computes the reference's one-hot dispatch and combine
  by index (``moe_block``'s docstring says why the values agree).
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


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of a tree of dicts, lists and tuples, in order; a node
    for which ``is_leaf`` is true is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_from_specs(specs, generator: torch.Generator, device="cuda",
                    dtype: torch.dtype | None = None):
    """Materialize a tree of ParamSpec on ``device``, normal leaves drawn
    from ``generator`` (a generator of that device) with std
    ``scale / sqrt(fan_in)``. The draws cannot match ``jax.random``; weights
    that must equal the reference's go through ``params_from_numpy``.

    ``dtype`` (default: each spec's own) is the leaves' dtype. A leaf is
    drawn and scaled in f32, then cast, and its f32 draw is freed before
    the next leaf is drawn: bf16 weights of a model whose f32 copy would
    not fit the card (deepseek-v2-lite's 15.7 G parameters)."""
    def one(spec: ParamSpec) -> torch.Tensor:
        out = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=out, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=out, device=device)
        fan_in = spec.shape[0] if len(spec.shape) else 1
        std = spec.scale / math.sqrt(max(1, fan_in))
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(std).to(out)
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
    input's dtype (the TPU's default-precision dot). ``b`` [K, N], or
    [E, K, N] beside ``a`` [E, M, K] (a batch of products)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if b.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if b.dim() == 3:
            g = g.to(a.dtype)
            if ctx.needs_input_grad[0]:
                da = g @ b.transpose(1, 2)
            if ctx.needs_input_grad[1]:
                db = a.transpose(1, 2) @ g
            return da, db
        g2 = g.reshape(-1, g.shape[-1]).to(a.dtype)
        if ctx.needs_input_grad[0]:
            da = (g2 @ b.t()).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            db = a.reshape(-1, a.shape[-1]).t() @ g2
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a [..., K], b [K, N]; or a [E, M, K], b [E, K, N]) with
    an f32 result: products of the inputs' dtype summed in f32, the
    reference's ``preferred_element_type=jnp.float32``. On the card a
    bf16 product writes f32 directly (``out_dtype``) rather than widening
    ``b``, and its backward is ``_MatmulF32``'s."""
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


def moe_route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """Token-choice top-k routing: ``xt`` [T, D] -> (gate values [T, k]
    f32, renormalised to sum to 1; expert ids [T, k]). The router's
    product sums in f32 and the softmax is f32. Among equal probabilities
    the lower expert id comes first, as ``jax.lax.top_k`` orders them: a
    stable descending sort (``torch.topk`` promises no order for ties)."""
    probs = torch.softmax(matmul_f32(xt, router.to(xt.dtype)), dim=-1)
    gval, gidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gval, gidx = gval[:, :top_k], gidx[:, :top_k]
    return gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9), gidx


def moe_capacity(n_tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25,
                 group_size: int = 4096) -> tuple[int, int, int]:
    """(groups G, tokens a group Tg, slots an expert has in a group). The
    reference reshapes the T tokens into (G, Tg), so a T that G does not
    divide fails there; here it raises. An expert has at least 32 slots
    a group, so a decode step or a prefill of up to 32 tokens drops
    nothing; a longer prefill whose tokens crowd one expert does."""
    G = max(1, n_tokens // group_size)
    if n_tokens % G:
        raise ValueError(f"{n_tokens} tokens do not split into {G} groups "
                         f"of equal size (group_size {group_size})")
    Tg = n_tokens // G
    cap = min(Tg * top_k,
              max(math.ceil(capacity_factor * Tg * top_k / n_experts), 32))
    return G, Tg, cap


def moe_slots(gidx: torch.Tensor, n_groups: int, n_experts: int,
              cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, keep), both [T, k]: each (token, choice)'s position among its
    expert's rows in its group, counted over the FLATTENED (token, choice)
    order (a count per choice would put two choices in one slot), and
    ``pos < cap``; the pairs past an expert's capacity are dropped."""
    T, k = gidx.shape
    flat = gidx.reshape(n_groups, -1)
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat[..., None])
    pos = pos.reshape(T, k)
    return pos, pos < cap


def moe_block(x, params, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 4096):
    """Token-choice top-k MoE with capacity-factor dropping: x [B,S,D].

    The reference dispatches and combines with one-hot tensors
    ``[G, Tg, E, cap]`` (503 MB each at 4,096 tokens of deepseek-v2-lite,
    and 3 GB for its three-operand combine einsum in torch). Each kept
    (token, choice) lands in exactly one (expert, slot) row, so this
    copies the token into its row (``index_copy``: the destinations are
    unique; dropped pairs go to one spare row that is cut off), runs the
    experts' SwiGLU as batched products over ``[E, G*cap, D]``, and
    gathers each pair's row back, summing over k in a fixed order. The
    dispatch is an exact copy in both forms; the combine weights are
    rounded to x's dtype before they multiply, as the reference's
    ``comb.astype(x.dtype)``; products and sums in f32, then rounded to
    x's dtype once. Every expert's weights are read whatever the routing
    (the reference's [E, cap] layout)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gval, gidx = moe_route(xt, params["router"], top_k)
    G, Tg, cap = moe_capacity(T, top_k, n_experts, capacity_factor,
                              group_size)
    pos, keep = moe_slots(gidx, G, n_experts, cap)
    group = torch.arange(T, device=x.device)[:, None] // Tg
    n_rows = n_experts * G * cap
    # expert-major rows, so each expert's G*cap rows are contiguous
    row = torch.where(keep, (gidx * G + group) * cap + pos, n_rows)
    xe = xt.new_zeros(n_rows + 1, D).index_copy(
        0, row.reshape(-1), xt.repeat_interleave(top_k, dim=0))
    xe = xe[:n_rows].reshape(n_experts, G * cap, D)
    h = matmul_f32(xe, params["wi_gate"].to(x.dtype))
    u = matmul_f32(xe, params["wi_up"].to(x.dtype))
    h = (torch.nn.functional.silu(h) * u).to(x.dtype)
    ye = torch.bmm(h, params["wo"].to(x.dtype)).reshape(n_rows, D)
    ye = torch.nn.functional.pad(ye, (0, 0, 0, 1))      # the spare row: 0
    w = torch.where(keep, gval, 0.0).to(x.dtype)
    yt = (w.float()[..., None] * ye[row].float()).sum(1)
    return yt.to(x.dtype).reshape(B, S, D)


def moe_param_specs(d_model: int, d_ff: int, n_experts: int) -> dict:
    return {
        "router": ParamSpec((d_model, n_experts), ("embed", "expert_router")),
        "wi_gate": ParamSpec((n_experts, d_model, d_ff), ("expert", "embed", "mlp")),
        "wi_up": ParamSpec((n_experts, d_model, d_ff), ("expert", "embed", "mlp")),
        "wo": ParamSpec((n_experts, d_ff, d_model), ("expert", "mlp", "embed")),
    }


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
