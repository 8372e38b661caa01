"""AdamW with decoupled weight decay, global-norm clipping and f32 master
params (the reference's ``repro/optim/adamw.py``).

The moments, the update and the bias correction are f32 and ``step`` is
an int32 scalar tensor, on the params' device. The step is functional, as
the reference's is: it returns new params and a new state and leaves the
ones it was given as they were.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.ctx import to_local


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    """Zero f32 moments shaped like ``params`` and ``step`` 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32. Over DTensor
    leaves (split or replicated, as a step places its gradients; not
    Partial): each rank sums its shards' squares, the sums of the leaves
    split over the same mesh dims are added and all-reduced over those
    dims (one collective for each such set of dims), and the norm is a
    replicated scalar."""
    from torch.distributed.tensor import DTensor, Replicate
    leaves = tree_leaves(tree)
    if not any(isinstance(t, DTensor) for t in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in leaves))
    import torch.distributed as dist
    mesh = next(t.device_mesh for t in leaves if isinstance(t, DTensor))
    sums: dict = {}
    for leaf in leaves:
        dims = tuple(i for i, p in enumerate(getattr(leaf, "placements", ()))
                     if p.is_shard())
        sq = torch.sum(torch.square(to_local(leaf).float()))
        sums[dims] = sums[dims] + sq if dims in sums else sq
    total = None
    for dims, s in sorted(sums.items()):
        for i in dims:
            dist.all_reduce(s, group=mesh.get_group(i))
        total = s if total is None else total + s
    return DTensor.from_local(torch.sqrt(total), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def adamw_step(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """Returns (new_params, new_state, metrics). ``grads`` is a tree like
    ``params`` and may be bf16 (compressed); moments and update are f32.
    Over DTensors (each gradient and moment placed as its param, ``step``
    replicated) the update runs on the local shards, elementwise as on
    one device, and every new leaf keeps its param's placements."""
    from torch.distributed.tensor import DTensor
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (to_local(gnorm) + 1e-9), max=1.0)
    step = to_local(state["step"]) + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        step_ = mh / (torch.sqrt(vh) + cfg.eps)
        newp = p.float() - lr * (step_ + cfg.weight_decay * p.float())
        return newp.to(p.dtype), m, v

    def placed(like, t):
        if not isinstance(like, DTensor):
            return t
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    flat = []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        if isinstance(p, DTensor) and not (
                g.placements == m.placements == v.placements == p.placements):
            raise ValueError(f"AdamW over DTensors needs each gradient and "
                             f"moment placed as its param: {p.placements}, "
                             f"{g.placements}, {m.placements}, {v.placements}")
        new = upd(to_local(p), to_local(g), to_local(m), to_local(v))
        flat.append(tuple(placed(p, t) for t in new))
    new_p, new_m, new_v = (tree_unflatten(params, [t[i] for t in flat])
                           for i in range(3))
    metrics = {"grad_norm": gnorm,
               "lr": torch.tensor(lr, dtype=torch.float32)}
    return new_p, {"m": new_m, "v": new_v,
                   "step": placed(state["step"], step)}, metrics
