"""Logical-axis → mesh-axis sharding rule engine.

Every parameter leaf carries logical axes (``ParamSpec.axes``); a cache
leaf takes them from its model's ``cache_axes()``. A ``ShardingRules``
maps each logical axis name to a mesh axis (or tuple of mesh axes). The
engine checks divisibility per tensor: any logical axis whose dim is not
divisible by the product of its mesh axes falls back to replicated for
that tensor (an uneven shard is refused, as the reference's jit
boundaries refuse it).

A partition spec is a tuple with one entry per leading tensor dim:
``None`` (replicated), a mesh-axis name, or a tuple of names (that dim
split over their product, the first name major), trailing ``None``s
trimmed. Its entries equal those of the reference's ``PartitionSpec``.
``placements`` turns one into ``torch.distributed.tensor`` placements for
a ``DeviceMesh``.

A mesh is anything ``mesh_sizes`` can read: an object whose ``.shape``
maps axis name to size (``launch.mesh.MeshShape``, a test's fake mesh),
or a ``torch.distributed.device_mesh.DeviceMesh`` with dim names.

Default layout:
  TP over 'model'   — mlp, heads, vocab, expert (EP), kv_lora out-dim
  FSDP over 'data'  — embed (d_model) dimension of weight matrices
  DP over (pod, data) — activation batch
  SP over 'model'   — activation sequence between blocks (optional)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

# the models import ``sharding.ctx``: a module import, whose names are
# read at call time, lets the two packages import each other
import repro_torch.models.common as MC


def _canon(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclass(frozen=True)
class ShardingRules:
    """mapping: logical axis name -> mesh axis name(s) (or None)."""
    mapping: dict = field(default_factory=dict)

    def mesh_axes_for(self, logical: str) -> tuple:
        return _canon(self.mapping.get(logical))

    def override(self, **kv) -> "ShardingRules":
        m = dict(self.mapping)
        m.update(kv)
        return ShardingRules(m)


DEFAULT_MAPPING = {
    # --- parameters ---
    "embed": "data",            # FSDP: d_model dim of weights
    "mlp": "model",             # TP
    "heads": "model",           # TP
    "kv_heads": "model",        # TP when divisible, else replicate
    "head_dim": None,
    "vocab": "model",           # TP on the vocabulary
    "expert": "model",          # expert parallelism
    "expert_router": None,
    "kv_lora": None,            # MLA latent dim of weights (head-parallel TP)
    "kv_cache_lora": "model",   # MLA compressed cache latent dim (512/16 ✓)
    "ssm_inner": "model",       # mamba/rwkv inner channels
    "ssm_state": None,
    "conv": None,
    "frames": None,
    "layer": None,              # stacked-layer leading axis — never sharded
    # --- activations ---
    "batch": ("pod", "data"),
    "seq": None,                # attention q positions — keep unsharded
    "seq_save": None,           # layer-boundary (remat-saved) activations;
                                # 'model' = Megatron-style sequence parallelism
    "seq_kv": None,
    "kv_cache_batch": ("pod", "data"),
    "kv_cache_heads": "model",
    # KV cache head_dim: shards over 'model' exactly when kv_heads could not
    # (duplicate-axis suppression keeps one of the two); 128/16 ✓.
    "kv_cache_head_dim": "model",
}

DEFAULT_RULES = ShardingRules(DEFAULT_MAPPING)

SP_RULES = DEFAULT_RULES.override(seq_save="model")  # Megatron-SP boundaries


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of ``mesh``: a ``DeviceMesh`` (by its dim names)
    or anything whose ``.shape`` maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(sizes: dict, names: tuple) -> int:
    return math.prod(sizes[n] for n in names) if names else 1


def partition_spec(mesh, rules: ShardingRules, axes: tuple,
                   shape: tuple) -> tuple:
    """Partition spec of one tensor, with per-dim divisibility fallback
    and duplicate-mesh-axis suppression (a mesh axis may shard only one
    dim)."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    parts = []
    for dim, logical in zip(shape, axes):
        names = rules.mesh_axes_for(logical) if logical else ()
        names = tuple(n for n in names if n in sizes)
        if not names or any(n in used for n in names):
            parts.append(None)
            continue
        size = _axis_size(sizes, names)
        if size <= 1 or dim % size != 0:
            parts.append(None)
            continue
        used.update(names)
        parts.append(names[0] if len(names) == 1 else names)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def local_shape(mesh, spec: tuple, shape: tuple) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (each split dim divided by its mesh axes' product)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        size = _axis_size(sizes, _canon(entry))
        if out[d] % size:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {entry!r} ({size} devices)")
        out[d] //= size
    return tuple(out)


def placements(mesh, spec: tuple) -> list:
    """``torch.distributed.tensor`` placements of ``spec`` on the
    ``DeviceMesh`` ``mesh``: for each mesh dim, ``Shard(d)`` where tensor
    dim d is split over it, else ``Replicate()``. A dim split over several
    mesh axes is ``Shard(d)`` on each of them; DTensor then splits it
    over the mesh dims in mesh order, which is the reference's row-major
    order whenever the entry lists its axes in mesh order (as every rule
    of ``DEFAULT_MAPPING`` does)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {name: d for d, entry in enumerate(spec)
             for name in _canon(entry)}
    return [Shard(where[name]) if name in where else Replicate()
            for name in mesh.mesh_dim_names]


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def tree_specs(mesh, rules: ShardingRules, axes_tree, shape_tree):
    """A tree like ``shape_tree`` (tensors, meta tensors or ParamSpecs)
    whose leaves are their partition specs, walked in lockstep with
    ``axes_tree`` (whose leaves are tuples of logical names). A leaf whose
    axes are None or of another rank than its shape, or that has no
    shape, is replicated: ()."""
    axes = MC.tree_leaves(axes_tree, is_leaf=_is_axes)
    leaves = MC.tree_leaves(shape_tree)
    if len(axes) != len(leaves):
        raise ValueError(f"{len(axes)} axes leaves for {len(leaves)} "
                         "tensors: the trees differ")

    def one(ax, leaf):
        if not hasattr(leaf, "shape"):
            return ()                    # a host int (a cache's length)
        shape = tuple(leaf.shape)
        if ax is None or len(ax) != len(shape):
            return ()
        return partition_spec(mesh, rules, ax, shape)
    return MC.tree_unflatten(shape_tree, [one(a, t) for a, t in zip(axes, leaves)])


def spec_leaves(spec_tree) -> list:
    """The partition specs of a spec tree, in ``tree_leaves`` order."""
    return MC.tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, tuple))


def distribute_tree(tree, mesh, spec_tree):
    """``tree`` with each tensor leaf placed on ``mesh`` by its partition
    spec in ``spec_tree`` (a tree like ``tree`` whose leaves are specs;
    ``()`` is replicated): a plain tensor by ``distribute_tensor``, a
    ``DTensor`` of other placements by ``redistribute``. A leaf that is
    not a tensor (a cache's host-int length) is kept as it is."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    specs = spec_leaves(spec_tree)
    leaves = MC.tree_leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves: the "
                         "trees differ")

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        want = tuple(placements(mesh, spec))
        if isinstance(leaf, DTensor):
            if tuple(leaf.placements) == want:
                return leaf
            return leaf.redistribute(mesh, want)
        return distribute_tensor(leaf, mesh, want)
    return MC.tree_unflatten(tree, [one(t, s) for t, s in zip(leaves, specs)])


def full_tree(tree):
    """``tree`` with each ``DTensor`` leaf replaced by a plain tensor of
    its full value (every rank joins the gathers); other leaves as they
    are."""
    from .ctx import full_value
    return MC.tree_unflatten(tree, [full_value(t)
                                 for t in MC.tree_leaves(tree)])


def local_bytes(tree) -> int:
    """Bytes of the local shards of ``tree``'s tensor leaves (a plain
    tensor whole); a host int (a cache's length) as the reference's int32
    scalar, 4 B, as ``Cell.arg_local_bytes`` counts it."""
    from .ctx import to_local
    n = 0
    for t in MC.tree_leaves(tree):
        t = to_local(t)
        n += t.numel() * t.element_size() if hasattr(t, "element_size") else 4
    return n
