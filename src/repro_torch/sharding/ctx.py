"""Activation-sharding context.

Model code calls ``shard_activation(x, ('batch', 'seq', 'embed'))`` at the
reference's points (layer boundaries, attention q/k/v, the MLP's hidden
activations, the MoE dispatch, the logits). Outside a context (one
device, the CPU tests, the serving engine) it returns ``x`` itself;
inside ``activation_sharding_ctx(mesh, rules)`` it redistributes the
``DTensor`` ``x`` to the placements the rules give its logical axes on
``mesh`` (batch over (pod, data), optionally sequence over model —
Megatron-SP style), as the reference's ``with_sharding_constraint``
constrains GSPMD.

Inside a context every activation is a ``DTensor``: a plain tensor there
is refused rather than left off the mesh.
"""
from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def current():
    """(mesh, rules) of the innermost context, or None outside one."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def activation_sharding_ctx(mesh, rules):
    """rules: ShardingRules (see rules.py). Nestable; inner wins."""
    prev = current()
    _tls.ctx = (mesh, rules)
    try:
        yield
    finally:
        _tls.ctx = prev


def shard_activation(x, axes: tuple):
    """Constrain ``x`` (rank == len(axes)) to the mesh axes that ``rules``
    assigns to each logical activation axis; a dim not divisible by its
    mesh-axis product is replicated. ``x`` itself without a context."""
    ctx = current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    from .rules import partition_spec, placements
    mesh, rules = ctx
    if not isinstance(x, DTensor):
        raise TypeError(f"shard_activation{tuple(axes)}: a plain "
                        f"{type(x).__name__} of shape {tuple(x.shape)} inside "
                        "activation_sharding_ctx; a sharded step's "
                        "activations are DTensors")
    want = tuple(placements(mesh, partition_spec(mesh, rules, axes,
                                                 tuple(x.shape))))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a leaf of a step run over a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_local(x):
    """A DTensor's local shard; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def full_value(x):
    """A DTensor's full value on every rank (every rank joins the
    gathers), as a plain tensor; anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def zeros_placed(make, axes_tree, device):
    """The tree of zeros ``make(device)`` builds (a prefill's empty
    caches), placed inside a context on the mesh by the rules for
    ``axes_tree``: each rank makes only its own shard of each leaf
    (``make("meta")`` gives the shapes), where placing the whole zeros
    would first hold the whole cache on every rank (the step trace saw
    380-480 GiB a device in a 32k prefill at 16x16).
    ``make(device)`` itself outside one."""
    ctx = current()
    if ctx is None:
        return make(device)
    import torch
    from torch.distributed.tensor import DTensor

    import repro_torch.models.common as MC
    from .rules import local_shape, placements, spec_leaves, tree_specs
    mesh, rules = ctx
    shapes = make("meta")
    specs = spec_leaves(tree_specs(mesh, rules, axes_tree, shapes))

    def one(t, spec):
        local = torch.zeros(local_shape(mesh, spec, tuple(t.shape)),
                            dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return MC.tree_unflatten(shapes, [one(t, sp) for t, sp in
                                      zip(MC.tree_leaves(shapes), specs)])
