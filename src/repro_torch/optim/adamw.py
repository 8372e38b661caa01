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
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_step(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """Returns (new_params, new_state, metrics). ``grads`` is a tree like
    ``params`` and may be bf16 (compressed); moments and update are f32."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
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

    flat = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [t[i] for t in flat])
                           for i in range(3))
    metrics = {"grad_norm": gnorm,
               "lr": torch.tensor(lr, dtype=torch.float32)}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
