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
- The reference's ``shard_activation`` calls stand at its points here
  too: an identity without a context; inside ``activation_sharding_ctx``
  (a step run over a ``DeviceMesh``) params and activations are
  ``DTensor``s and each call redistributes to the rules' placements.
  Most ops take DTensors as they are; those that do not (the embedding
  of a vocab-split table, ``matmul_f32``'s ``out_dtype`` product, the
  MoE's routing and combine) run under ``local_map``.

- Training differentiates these functions with torch autograd. Two
  carry a hand-written backward that keeps the reference's dtypes: the
  embedding (its custom VJP) and ``matmul_f32`` on the card.
- ``moe_block`` computes the reference's one-hot dispatch and combine
  by index (``moe_block``'s docstring says why the values agree).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.sharding.ctx import current, is_dtensor, shard_activation


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


class _ShardEmbedLookup(torch.autograd.Function):
    """``_EmbedLookup`` on one shard of a table split on its rows, the
    shard holding rows [lo, lo + rows): a token outside them looks up
    zeros, and its ``dx`` row adds nothing (it is zeroed before the
    scatter, so the shard's gradient sums the same rows in the same order
    as the whole table's)."""

    @staticmethod
    def forward(ctx, table, tokens, lo: int):
        # the tokens' own integer dtype: index_add_ of bf16 rows sums in
        # another order for int32 and int64 indices
        ids = tokens - lo
        valid = (ids >= 0) & (ids < table.shape[0])
        ids = torch.where(valid, ids, 0)
        ctx.save_for_backward(ids, valid)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        rows = torch.nn.functional.embedding(ids, table).to(COMPUTE_DTYPE)
        return rows.masked_fill(~valid[..., None], 0)

    @staticmethod
    def backward(ctx, dx):
        ids, valid = ctx.saved_tensors
        d = ctx.table_shape[1]
        dx = dx.masked_fill(~valid[..., None], 0)
        d_table = torch.zeros(ctx.table_shape, dtype=dx.dtype, device=dx.device)
        d_table.index_add_(0, ids.reshape(-1), dx.reshape(-1, d))
        return d_table.to(ctx.table_dtype), None, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``, in the compute dtype, with the
    reference's embedding gradient (``_EmbedLookup``); a DTensor table
    through ``sharded_embed``."""
    if is_dtensor(table):
        return sharded_embed(table, tokens)
    return _EmbedLookup.apply(table, tokens)


# ---------------------------------------------------------------------------
# DTensor arguments (a step run over a DeviceMesh)
# ---------------------------------------------------------------------------

def _on_mesh(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor (a constant every
    rank holds whole) as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _no_partial(x):
    """``x`` with every ``Partial`` placement summed (all-reduced) to
    ``Replicate``."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(
        x.device_mesh, want)


def _grad_placements(inp, out) -> list:
    """The placements of the gradient of a ``local_map`` input placed as
    ``inp`` whose output is placed as ``out`` (one product or lookup per
    rank): where the input is whole on a mesh dim that splits the output,
    each rank's gradient is a partial sum over that dim."""
    from torch.distributed.tensor import Partial
    return [Partial() if pi.is_replicate() and po.is_shard() else pi
            for pi, po in zip(inp, out)]


def gather_weights(tree):
    """Inside a context, ``tree`` with each DTensor leaf whole
    (``Replicate``) on the data-parallel mesh axes (those the rules split
    the batch over): a weight split there (FSDP) is gathered where a
    layer uses it, and DTensor's backward of the gather reduce-scatters
    its gradient. Other placements stay. ``tree`` itself outside one."""
    ctx = current()
    if ctx is None:
        return tree
    from torch.distributed.tensor import Replicate
    dims = ctx[1].mesh_axes_for("batch")

    def one(w):
        if not is_dtensor(w):
            return w
        names = w.device_mesh.mesh_dim_names
        want = [Replicate() if names[i] in dims else p
                for i, p in enumerate(w.placements)]
        return w if want == list(w.placements) else w.redistribute(
            w.device_mesh, want)
    return tree_map(one, tree)


def sharded_embed(table, tokens):
    """``embed_lookup`` of a DTensor ``table`` [V, D] under ``local_map``.
    The table is whole on its embed dim (a split there is gathered first)
    and may be split on its rows (else each rank runs ``_EmbedLookup``):
    each rank of such a mesh dim looks up the rows it holds and zeros for
    the rest (``_ShardEmbedLookup``), so
    the output is ``Partial`` there, its sum exact (one rank contributes
    each row); elsewhere it is placed as ``tokens``. Each rank's table
    gradient covers its own rows, summed in ``dx``'s dtype, then cast."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = _on_mesh(tokens, mesh)
    t_pl = [Shard(0) if p == Shard(0) else Replicate()
            for p in table.placements]
    row_dims = [i for i, p in enumerate(t_pl) if p.is_shard()]
    k_pl = [Replicate() if i in row_dims else p
            for i, p in enumerate(tokens.placements)]
    out_pl = [Partial() if i in row_dims else p for i, p in enumerate(k_pl)]
    n_rows = table.shape[0]
    for i in row_dims:
        n_rows //= mesh.size(i)
    # DTensor splits a dim over several mesh dims in mesh order
    part = 0
    for i in row_dims:
        part = part * mesh.size(i) + mesh.get_local_rank(i)
    lo = part * n_rows
    lookup = (_EmbedLookup.apply if not row_dims else
              lambda t, k: _ShardEmbedLookup.apply(t, k, lo))
    return local_map(
        lookup, out_placements=out_pl, in_placements=(t_pl, k_pl),
        in_grad_placements=(_grad_placements(t_pl, out_pl), k_pl),
        device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def _matmul_local(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


def einsum(eq: str, *ops, local=None):
    """``torch.einsum(eq, *ops)``, or ``local(*ops)`` computing it, given
    ``local``; DTensors through ``_sharded_einsum``."""
    if any(is_dtensor(o) for o in ops):
        return _sharded_einsum(eq, *ops, local=local)
    return local(*ops) if local else torch.einsum(eq, *ops)


def _sharded_einsum(eq: str, *ops, local=None):
    """``torch.einsum`` of DTensors (``local(*shards)`` on each rank,
    given ``local``) under ``local_map``: on each mesh dim the first
    operand split there (a plain ``Shard``) names the split index; every
    operand that has that index is split on it, the others whole (a
    strided split, what a reshape that merges a split dim into the one
    before it leaves, is gathered: ``local_map`` cannot place an output
    so), and the output is split on it, or a ``Partial`` sum where it is
    contracted (a ``Partial`` input is summed first). DTensor's own
    einsum flattens merged indices first, which some torch versions
    refuse where an inner one is split (a decode's head_dim-split ``wq``
    [D, H, dh] at 16x16)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    subs, out = eq.replace(" ", "").split("->")
    subs = subs.split(",")
    mesh = next(o.device_mesh for o in ops if is_dtensor(o))
    ops = [_no_partial(_on_mesh(o, mesh)) for o in ops]
    in_pl, out_pl = [[] for _ in ops], []
    for i in range(mesh.ndim):
        idx = next((sub[o.placements[i].dim] for sub, o in zip(subs, ops)
                    if type(o.placements[i]) is Shard), None)
        for pl, sub in zip(in_pl, subs):
            pl.append(Shard(sub.index(idx)) if idx is not None and idx in sub
                      else Replicate())
        out_pl.append(Replicate() if idx is None else
                      Shard(out.index(idx)) if idx in out else Partial())
    if local is None:
        def local(*xs):
            return torch.einsum(eq, *xs)
    return local_map(
        local, out_placements=out_pl,
        in_placements=tuple(in_pl),
        in_grad_placements=tuple(_grad_placements(pl, out_pl)
                                 for pl in in_pl),
        device_mesh=mesh, redistribute_inputs=True)(*ops)


def by_groups(fn, dims: list, args: tuple, in_dims: tuple,
              out_dims: tuple):
    """``fn(*args)`` for a computation independent across groups of rows
    (the MoE's routing, dispatch and combine), on DTensors under
    ``local_map``: each rank runs ``fn`` on its own groups. ``in_dims[i]``
    is the group dim of ``args[i]`` (None: it has none, or it is not a
    tensor), ``out_dims`` the same for each output; over the mesh dims
    ``dims`` each is split on its group dim, and on every other mesh dim
    it is whole (gathered). An input whole where the outputs are split
    gets a partial-sum gradient. With ``dims`` empty every rank computes
    the whole values. Without a DTensor argument, ``fn(*args)`` itself."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))

    def pl(d):
        return [Shard(d) if d is not None and i in dims else Replicate()
                for i in range(mesh.ndim)]
    tensor = [isinstance(a, torch.Tensor) for a in args]
    in_pl = tuple(pl(d) if t else None for d, t in zip(in_dims, tensor))
    out_pl = [pl(d) for d in out_dims]
    grad_pl = tuple(_grad_placements(p, out_pl[0]) if p else None
                    for p in in_pl)
    args = [_no_partial(_on_mesh(a, mesh)) if t else a
            for a, t in zip(args, tensor)]
    return local_map(
        fn, out_placements=out_pl[0] if len(out_pl) == 1 else tuple(out_pl),
        in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh,
        redistribute_inputs=True)(*args)


def by_rows_and_heads(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn(*args)`` for a computation independent across batch rows and
    heads (a chunked scan): on DTensors, each rank runs ``fn`` on its
    rows and heads under ``local_map``. ``dims[i]`` = (batch dim, head
    dim) of ``args[i]`` (None where it has none; a non-tensor argument's
    entry is ignored), ``out_dims`` the same for each output. The split
    follows ``args[0]``'s: a mesh dim that splits its batch dim splits
    every batch dim, one that splits its head dim every head dim, any
    other is gathered whole. An input whole where the outputs are split
    gets a partial-sum gradient. Without a DTensor argument,
    ``fn(*args)`` itself."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    lead_b, lead_h = dims[0]
    role = [("b" if p == Shard(lead_b) else "h" if p == Shard(lead_h)
             else None) for p in _on_mesh(args[0], mesh).placements]

    def pl(bh):
        return [Shard(bh[0]) if r == "b" and bh[0] is not None else
                Shard(bh[1]) if r == "h" and bh[1] is not None else
                Replicate() for r in role]
    tensor = [isinstance(a, torch.Tensor) for a in args]
    in_pl = tuple(pl(d) if t else None for d, t in zip(dims, tensor))
    out_pl = tuple(pl(d) for d in out_dims)
    grad_pl = tuple(_grad_placements(p, out_pl[0]) if p else None
                    for p in in_pl)
    args = [_no_partial(_on_mesh(a, mesh)) if t else a
            for a, t in zip(args, tensor)]
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


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
    ``b``, and its backward is ``_MatmulF32``'s. DTensors go through
    ``_sharded_einsum`` with this product on each rank's shards
    (``out_dtype`` has no DTensor strategy)."""
    if is_dtensor(a) or is_dtensor(b):
        batch = "abcdfgh"[:a.dim() - 1]
        eq = ("emk,ekn->emn" if b.dim() == 3
              else f"{batch}k,kn->{batch}n")
        return _sharded_einsum(eq, a, b, local=_matmul_local)
    return _matmul_local(a, b)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits [B,S,V] any float, labels
    int. With ``mask``, the mean over the positions it marks (at least
    one). DTensor logits split on the vocabulary take the vocab-parallel
    form (``_vocab_parallel_nll``): no rank gathers the whole vocabulary."""
    if is_dtensor(logits) and _vocab_dims(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        lg = logits.float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def _vocab_dims(x) -> list:
    """The mesh dims that split DTensor ``x``'s last dim."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(x.placements) if p == Shard(x.dim() - 1)]


class _VocabParallelNll(torch.autograd.Function):
    """Each token's negative log-likelihood from one rank's slice of the
    vocabulary, columns [lo, lo + V_local), over the process ``groups``
    that split it: the running max and the sum of exponentials are
    all-reduced (max, then sum), and the gold logit comes from the rank
    that holds it (a sum over the others' zeros). The backward is each
    rank's slice of softmax - onehot, in the logits' dtype."""

    @staticmethod
    def forward(ctx, lg, labels, lo: int, groups):
        import torch.distributed as dist
        lgf = lg.float()
        mx = lgf.amax(-1)
        for g in groups:
            dist.all_reduce(mx, dist.ReduceOp.MAX, group=g)
        e = torch.exp(lgf - mx[..., None])
        se = e.sum(-1)
        ids = labels.long() - lo
        valid = (ids >= 0) & (ids < lg.shape[-1])
        ids = torch.where(valid, ids, 0)
        gold = torch.where(valid, torch.gather(lgf, -1, ids[..., None])[..., 0],
                           0.0)
        for g in groups:
            dist.all_reduce(se, group=g)
            dist.all_reduce(gold, group=g)
        ctx.save_for_backward(e, se, ids, valid)
        ctx.dtype = lg.dtype
        return torch.log(se) + mx - gold

    @staticmethod
    def backward(ctx, g):
        e, se, ids, valid = ctx.saved_tensors
        d = e / se[..., None]
        d.scatter_add_(-1, ids[..., None], -valid[..., None].to(d.dtype))
        return (d * g[..., None]).to(ctx.dtype), None, None, None


def _vocab_parallel_nll(logits, labels):
    """Per-token nll [B, S] of DTensor ``logits`` split on the vocabulary,
    under ``local_map``: each rank's vocabulary slice and its rows of
    ``labels``; the result is whole over the vocabulary's mesh dims and
    placed as the logits' rows elsewhere."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    logits = _no_partial(logits)
    mesh = logits.device_mesh
    labels = _on_mesh(labels, mesh)
    dims = _vocab_dims(logits)
    out_pl = [Replicate() if i in dims else p
              for i, p in enumerate(logits.placements)]
    n_cols = logits.shape[-1]
    part = 0
    for i in dims:
        n_cols //= mesh.size(i)
        part = part * mesh.size(i) + mesh.get_local_rank(i)
    groups = [mesh.get_group(i) for i in dims]
    return local_map(
        lambda lg, lab: _VocabParallelNll.apply(lg, lab, part * n_cols,
                                                groups),
        out_placements=out_pl,
        in_placements=(list(logits.placements), out_pl),
        in_grad_placements=(list(logits.placements), out_pl),
        device_mesh=mesh, redistribute_inputs=True)(logits, labels)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _gqa_scores(q, k):
    """q [B,Sq,H,dh], k [B,Sk,Hkv,dh] -> scores [B,H,Sq,Sk] (f32).
    DTensors go through ``_sharded_gqa``."""
    if is_dtensor(q) or is_dtensor(k):
        return _sharded_gqa(_gqa_scores, q, k, _GQA_SCORES)
    return _gqa_scores_local(q, k)


def _gqa_out(p, v):
    """p [B,H,Sq,Sk] f32, v [B,Sk,Hkv,dh] -> [B,Sq,H,dh] (f32).
    DTensors go through ``_sharded_gqa``."""
    if is_dtensor(p) or is_dtensor(v):
        return _sharded_gqa(_gqa_out, p, v, _GQA_OUT)
    return _gqa_out_local(p, v)


def _gqa_scores_local(q, k, kv_of=None):
    """``_gqa_scores`` of one rank's shards. ``kv_of`` picks the kv heads
    its q heads read (``_kv_heads_of``); None: all of them."""
    B, Sq, H, dh = q.shape
    if kv_of is not None:
        k = _pick_heads(k, kv_of)
    g = H // k.shape[2]
    qg = q.reshape(B, Sq, k.shape[2], g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_out_local(p, v, kv_of=None):
    """``_gqa_out`` of one rank's shards (``kv_of`` as for the scores)."""
    B, H, Sq, Sk = p.shape
    if kv_of is not None:
        v = _pick_heads(v, kv_of)
    g = H // v.shape[2]
    pg = p.reshape(B, v.shape[2], g, Sq, Sk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, v.shape[3])


def _kv_heads_of(first: int, n: int, g: int):
    """The kv heads that x heads first .. first + n - 1 read (head h
    reads h // g), as dim 2 of a whole kv is picked: a ``slice`` where
    they are consecutive kv heads read by n / (their count) x heads each
    (the plain grouping), else an index per x head."""
    lo, hi = first // g, (first + n - 1) // g + 1
    if n % (hi - lo) == 0 and all((first + j) // g == lo + j // (n // (hi - lo))
                                  for j in range(n)):
        return slice(lo, hi)
    return torch.tensor([(first + j) // g for j in range(n)])


def _pick_heads(t, kv_of):
    if isinstance(kv_of, slice):
        return t[:, :, kv_of]
    return t.index_select(2, kv_of.to(t.device))


# The dims of a GQA product by role: the heads operand x (q; p), the kv
# operand (k; v) and the output (scores; o). "free_x" / "free_kv" are
# each operand's own dim (Sq; Sk or dh), "sum" the contracted one.
_GQA_SCORES = ({"batch": 0, "free_x": 1, "heads": 2, "sum": 3},
               {"batch": 0, "free_kv": 1, "heads": 2, "sum": 3},
               {"batch": 0, "heads": 1, "free_x": 2, "free_kv": 3})
_GQA_OUT = ({"batch": 0, "heads": 1, "free_x": 2, "sum": 3},
            {"batch": 0, "sum": 1, "heads": 2, "free_kv": 3},
            {"batch": 0, "free_x": 1, "heads": 2, "free_kv": 3})


def _gqa_placements(px, pkv, dims):
    """(x's, kv's, the output's) placements on one mesh dim of a GQA
    product, given x's and kv's there (neither Partial). The kv operand's
    split on its own or the contracted dim wins (a decode's head_dim-split
    cache is never gathered: x meets it, the scores come out ``Partial``);
    else x's split stays, the kv operand meeting it (split beside it on
    batch and heads when it already is, else whole); else the kv
    operand's batch or heads split, x's dim meeting it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x_d, kv_d, out_d = dims

    def role(p, d):
        if isinstance(p, Shard):
            return next(r for r, i in d.items() if i == p.dim)
        return None
    rx, rkv = role(px, x_d), role(pkv, kv_d)
    whole = Replicate()
    if rkv in ("free_kv", "sum"):
        x_pl = Shard(x_d["sum"]) if rkv == "sum" else whole
        return x_pl, pkv, Partial() if rkv == "sum" else Shard(out_d[rkv])
    if rx is not None:
        if rx == "sum":
            return px, Shard(kv_d["sum"]), Partial()
        kv_pl = (Shard(kv_d[rx]) if rx == "batch" or rx == rkv == "heads"
                 else whole)
        return px, kv_pl, Shard(out_d[rx])
    if rkv is not None:
        return Shard(x_d[rkv]), pkv, Shard(out_d[rkv])
    return whole, whole, whole


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: DTensor's
    backward of the projection before a ``local_map`` views its local
    gradient, which a local einsum's backward may leave strided."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sharded_gqa(fn, x, kv, dims):
    """``_gqa_scores`` / ``_gqa_out`` of DTensors under ``local_map``,
    placed by ``_gqa_placements`` on every mesh dim. Where x's heads are
    split and the kv heads are whole (the rules replicate kv heads that
    the ``model`` axis does not divide), each rank reads, for each of its
    x heads h, kv head h // g of the whole kv; where both are split (the
    heads of a rank's kv shard are those its x heads map to) and
    elsewhere, the plain grouping of its shards."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (x if is_dtensor(x) else kv).device_mesh
    x, kv = _no_partial(_on_mesh(x, mesh)), _no_partial(_on_mesh(kv, mesh))
    pl = [_gqa_placements(px, pkv, dims)
          for px, pkv in zip(x.placements, kv.placements)]
    x_pl, kv_pl, out_pl = ([p[i] for p in pl] for i in range(3))
    h_x, h_kv = dims[0]["heads"], dims[1]["heads"]
    n_heads, g = x.shape[h_x], x.shape[h_x] // kv.shape[h_kv]
    x_split = [i for i, p in enumerate(x_pl) if p == Shard(h_x)]
    kv_split = [i for i, p in enumerate(kv_pl) if p == Shard(h_kv)]
    local = {_gqa_scores: _gqa_scores_local, _gqa_out: _gqa_out_local}[fn]
    kv_of = None
    if x_split and not kv_split:
        # DTensor splits a dim over several mesh dims in mesh order
        part = 0
        for i in x_split:
            n_heads //= mesh.size(i)
            part = part * mesh.size(i) + mesh.get_local_rank(i)
        kv_of = _kv_heads_of(part * n_heads, n_heads, g)

    def run(a, b):
        return local(_ContiguousGrad.apply(a), _ContiguousGrad.apply(b),
                     kv_of)
    return local_map(
        run, out_placements=out_pl, in_placements=(x_pl, kv_pl),
        in_grad_placements=(_grad_placements(x_pl, out_pl),
                            _grad_placements(kv_pl, out_pl)),
        device_mesh=mesh, redistribute_inputs=True)(x, kv)


def dense_attention(q, k, v, *, causal: bool, q_chunk: int = 4096,
                    q_offset: int = 0, window: int | None = None,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """Numerically-standard softmax attention, q-chunked so peak score
    memory is [B,H,q_chunk,Sk].

    q_offset: global position of q[0] (decode: cache length). kv_valid_len:
    mask out cache positions >= this (decode with static cache). Both are
    host ints, so no mask needs a device value on the host.
    """
    q = shard_activation(q, ("batch", "seq", "heads", "head_dim"))
    if q.shape[1] == 1:
        # decode: keep the KV cache head_dim-sharded; the q·k contraction
        # over the sharded head_dim yields PARTIAL scores ([B,H,1,Sk], tiny)
        # + all-reduce — instead of per-layer all-gathers of the cache.
        kv_ax = ("batch", "seq_kv", "kv_heads", "kv_cache_head_dim")
    else:
        # train/prefill: k/v are fresh transients; replicate head_dim so the
        # heads-sharded q contracts locally (scores stay head-sharded).
        kv_ax = ("batch", "seq_kv", "kv_heads", None)
    k = shard_activation(k, kv_ax)
    v = shard_activation(v, kv_ax)
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
    """The SwiGLU MLP of x [..., D]. Over a mesh, an ``x`` that is a
    partial sum (the norm of a residual that adds the attention's
    head-split output) is summed first: given a partial ``x`` and the
    ``mlp``-split weights, DTensor would gather the weights and run the
    whole MLP on every ``model`` rank (the step trace showed it: 16x the
    MLP's flops at 16x16), where the reference's constraints on ``h`` and
    ``u`` keep each rank on its own columns."""
    if is_dtensor(x):
        x = _no_partial(x)
    h = x @ wi_gate.to(x.dtype)
    u = x @ wi_up.to(x.dtype)
    h = shard_activation(h, ("batch", "seq", "mlp"))
    u = shard_activation(u, ("batch", "seq", "mlp"))
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
    (the reference's [E, cap] layout).

    On DTensors the groups stay split over the batch's mesh dims, as the
    reference keeps its ``[G, E, cap, D]`` dispatch at ``("batch",
    "expert", None, None)``: where those ranks split the batch rows and
    the G groups evenly (``_moe_group_dims``), each rank routes,
    dispatches and combines its own groups (``by_groups``; a group's
    slots count only its own tokens), and the ``[E, G*cap, D]`` rows,
    group-major, are split on dim 1 there. Else (a decode step's or a
    short prefill's single group) every rank routes the whole batch,
    which is then a few tokens. ``expert`` is dim 0 here, where the
    reference has it at dim 1, so the expert products are split over
    experts and groups at once."""
    B, S, D = x.shape
    G = moe_capacity(B * S, top_k, n_experts, capacity_factor,
                     group_size)[0]
    dims = _moe_group_dims(x, G)
    groups = "batch" if dims else None
    xe, row, w = by_groups(functools.partial(
        _moe_dispatch, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, group_size=group_size), dims,
        (x, params["router"]), (0, None), (1, 0, 0))
    xe = shard_activation(xe, ("expert", groups, None))
    h = matmul_f32(xe, params["wi_gate"].to(x.dtype))
    u = matmul_f32(xe, params["wi_up"].to(x.dtype))
    h = shard_activation(h, ("expert", groups, "mlp"))
    u = shard_activation(u, ("expert", groups, "mlp"))
    h = (torch.nn.functional.silu(h) * u).to(x.dtype)
    ye = torch.bmm(h, params["wo"].to(x.dtype))
    ye = shard_activation(ye, ("expert", groups, None))
    return by_groups(_moe_combine, dims, (ye, row, w), (1, 0, 0),
                     (0,)).reshape(B, S, D)


def _moe_group_dims(x, n_groups: int) -> list:
    """The mesh dims over which a step's MoE splits its ``n_groups``
    groups: inside a context, those the rules put the batch on (of more
    than one rank), when their ranks split both ``x``'s rows and the
    groups evenly. Each rank's rows are then whole groups, since the
    B*S tokens are group-major, and each rank's own tokens give its
    groups' capacity exactly as the whole batch does. Else none."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return []
    mesh, rules = ctx
    axes = rules.mesh_axes_for("batch")
    dims = [i for i, name in enumerate(mesh.mesh_dim_names)
            if name in axes and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in dims)
    return dims if dims and x.shape[0] % n == 0 and n_groups % n == 0 else []


def _moe_dispatch(x, router, *, n_experts, top_k, capacity_factor,
                  group_size):
    """x [B,S,D] -> (xe [E, G*cap, D], each (token, choice)'s row [T, k]
    (``E*G*cap`` where dropped), its combine weight [T, k] in x's
    dtype)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gval, gidx = moe_route(xt, router, top_k)
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
    return xe, row, torch.where(keep, gval, 0.0).to(x.dtype)


def _moe_combine(ye, row, w):
    """ye [E, G*cap, D] -> each token's sum over its k choices of the
    weighted rows [T, D], in ye's dtype (f32 products and sums)."""
    ye = ye.reshape(-1, ye.shape[-1])
    ye = torch.nn.functional.pad(ye, (0, 0, 0, 1))      # the spare row: 0
    yt = (w.float()[..., None] * ye[row].float()).sum(1)
    return yt.to(ye.dtype)


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
