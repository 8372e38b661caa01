"""Step builders: train / prefill / serve steps of a model on one device.

``build_cell`` is the entry the trainer uses: given (arch, shape) it
returns the step function, the model, and ``meta`` tensors (shape and
dtype, no memory) standing in for every argument.

What the reference's ``repro/launch/steps.py`` has and this one leaves
out: the mesh, the sharding rules and ``donate`` (the row split and
``sharding/`` are ROADMAP.md, Queue 1 item 6), and ``Cell.lower`` (XLA
lowering for the dry-run, item 8). Layers are never scanned: the
reference scans the full configs (``scan_layers = not smoke``) because
XLA's compile time grows with an unrolled graph's depth; eager torch
builds nothing per layer, so the Python loop over layers costs nothing
before the first step.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchDef, SHAPES, SMOKE_SHAPES, input_specs
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def loss_and_grads(model, params, batch):
    """(loss, grads): the model's loss on ``batch`` (detached) and its
    gradient by autograd, a tree like ``params``."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(model, opt_cfg: AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss and its gradient by autograd, then one AdamW step. Functional:
    the params and state it is given are left as they were."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch)
        with torch.no_grad():
            params, opt_state, metrics = adamw_step(opt_cfg, params, grads,
                                                    opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return train_step


def make_prefill_step(model, max_len: int):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch, max_len)
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens):
        with torch.inference_mode():
            return model.decode_step(params, cache, tokens)
    return serve_step


# ---------------------------------------------------------------------------
# cell assembly
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step: object            # the step function
    abstract_args: tuple    # meta tensors, one tree per argument
    model: object
    device: torch.device

    def arg_local_bytes(self) -> dict:
        """Bytes of each argument group on the device, from the meta
        tensors (one device holds every byte)."""
        names = {"train": ("params", "opt", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "cache", "tokens")}[self.kind]
        return {name: sum(t.numel() * t.element_size()
                          for t in tree_leaves(tree))
                for name, tree in zip(names, self.abstract_args)}


def _meta_params(specs, dtype_of):
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype_of(s.dtype),
                                          device="meta"), specs)


def build_cell(arch: ArchDef, shape_name: str, *, device="cuda",
               smoke: bool = False, opt_cfg: AdamWConfig | None = None,
               remat: bool = True, q_chunk: int | None = None,
               model=None) -> Cell:
    """Assemble the step and its abstract inputs for one (arch x shape)."""
    table = SMOKE_SHAPES if smoke else SHAPES
    s = table[shape_name]
    if q_chunk is None:
        # training wants small score chunks (activation memory); prefill can
        # afford larger; decode has Sq=1 so it is irrelevant.
        q_chunk = 512 if s.kind == "train" else 1024
    m = model if model is not None else arch.model(
        smoke=smoke, remat=remat, q_chunk=q_chunk)
    pspecs = m.param_specs()
    ispecs = input_specs(arch, shape_name, smoke=smoke, model=m)
    if s.kind == "train":
        p_abs = _meta_params(pspecs, lambda d: d)
        fn = make_train_step(m, opt_cfg or AdamWConfig())
        args = (p_abs, adamw_init(p_abs), ispecs["batch"])
    else:
        # serving keeps bf16 weights (cast once at load): half the
        # resident parameter bytes.
        p_abs = _meta_params(pspecs, lambda d: torch.bfloat16
                             if d == torch.float32 else d)
        if s.kind == "prefill":
            # VLMs prepend the visual prefix to the decoder cache
            extra = getattr(getattr(m, "cfg", None), "n_patches", 0)
            fn = make_prefill_step(m, max_len=s.seq + extra)
            args = (p_abs, ispecs["batch"])
        else:
            fn = make_serve_step(m)
            args = (p_abs, ispecs["cache"], ispecs["tokens"])
    return Cell(arch_id=arch.arch_id, shape_name=shape_name, kind=s.kind,
                step=fn, abstract_args=args, model=m,
                device=torch.device(device))
