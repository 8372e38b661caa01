"""Step builders: train / prefill / serve steps of a model on one device.

``build_cell`` is the entry the trainer and the dry-run census use: given
(arch, shape) it returns the step function, the model, and ``meta``
tensors (shape and dtype, no memory) standing in for every argument.
Given a mesh, it also records each argument leaf's partition spec under
the sharding rules (``sharding/rules.py``), and ``Cell.arg_local_bytes``
counts one device's share; the steps themselves still run on one device.

What the reference's ``repro/launch/steps.py`` has and this one leaves
out: running the steps sharded over the mesh (its jit in/out shardings,
``donate`` and the activation-sharding context: ROADMAP.md, Queue 1) and
``Cell.lower`` (XLA lowering, which torch has no counterpart of: see
``launch/__init__.py``). Layers are never scanned: the
reference scans the full configs (``scan_layers = not smoke``) because
XLA's compile time grows with an unrolled graph's depth; eager torch
builds nothing per layer, so the Python loop over layers costs nothing
before the first step.
"""
from __future__ import annotations

import inspect
import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchDef, SHAPES, SMOKE_SHAPES, input_specs
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step
from repro_torch.sharding.rules import (DEFAULT_RULES, ShardingRules,
                                        local_shape, mesh_sizes,
                                        partition_spec, tree_specs)


# ---------------------------------------------------------------------------
# sharding specs of a cell's arguments
# ---------------------------------------------------------------------------

def batch_specs(mesh, rules: ShardingRules, tree):
    """tokens/labels [B,S] + modality [B,...]: batch over ('pod','data')."""
    return tree_map(lambda t: partition_spec(
        mesh, rules, ("batch",) + (None,) * (t.dim() - 1), tuple(t.shape)),
        tree)


def param_specs_of(mesh, rules: ShardingRules, model):
    """The partition spec of each parameter leaf, from ``ParamSpec.axes``."""
    specs = model.param_specs()
    return tree_specs(mesh, rules, tree_map(lambda s: s.axes, specs), specs)


def spec_leaves(spec_tree) -> list:
    """The partition specs of a spec tree, in ``tree_leaves`` order."""
    return tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, tuple))


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
    mesh: object = None     # the mesh the specs are for (None: one device)
    arg_specs: tuple = ()   # partition specs, one tree per argument

    def arg_local_bytes(self) -> dict:
        """Bytes of each argument group on one device: every byte without
        a mesh, else each leaf's shard under its partition spec."""
        names = {"train": ("params", "opt", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "cache", "tokens")}[self.kind]
        out = {}
        for i, (name, tree) in enumerate(zip(names, self.abstract_args)):
            leaves = tree_leaves(tree)
            if self.mesh is None:
                shapes = [tuple(t.shape) for t in leaves]
            else:
                shapes = [local_shape(self.mesh, spec, tuple(t.shape))
                          for spec, t in zip(spec_leaves(self.arg_specs[i]),
                                             leaves)]
            out[name] = sum(math.prod(sh) * t.element_size()
                            for sh, t in zip(shapes, leaves))
        return out


def _meta_params(specs, dtype_of):
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype_of(s.dtype),
                                          device="meta"), specs)


def build_cell(arch: ArchDef, shape_name: str, *, device="cuda", mesh=None,
               rules: ShardingRules = DEFAULT_RULES, smoke: bool = False,
               opt_cfg: AdamWConfig | None = None, remat: bool = True,
               q_chunk: int | None = None, model=None) -> Cell:
    """Assemble the step and its abstract inputs for one (arch x shape).
    With ``mesh``, the model pads its heads to the mesh's ``model`` axis
    (``tp_divisor``) and every argument leaf gets its partition spec under
    ``rules``."""
    table = SMOKE_SHAPES if smoke else SHAPES
    s = table[shape_name]
    tp = mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
    if q_chunk is None:
        # training wants small score chunks (activation memory); prefill can
        # afford larger; decode has Sq=1 so it is irrelevant.
        q_chunk = 512 if s.kind == "train" else 1024
    if model is not None:
        m = model
    else:
        # the model classes take different keywords (EncDecLM no remat,
        # RWKV6LM no q_chunk): pass those its constructor names
        kw = {"remat": remat, "q_chunk": q_chunk}
        accepts = inspect.signature(
            type(arch.model(smoke=True)).__init__).parameters
        m = arch.model(smoke=smoke, tp_divisor=tp,
                       **{k: v for k, v in kw.items() if k in accepts})
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
    arg_specs = ()
    if mesh is not None:
        p_sp = param_specs_of(mesh, rules, m)
        if s.kind == "train":
            arg_specs = ({"m": p_sp, "v": p_sp, "step": ()},
                         batch_specs(mesh, rules, args[2]))
        elif s.kind == "prefill":
            arg_specs = (batch_specs(mesh, rules, args[1]),)
        else:
            arg_specs = (tree_specs(mesh, rules, m.cache_axes(), args[1]),
                         batch_specs(mesh, rules, args[2]))
        arg_specs = (p_sp,) + arg_specs
    return Cell(arch_id=arch.arch_id, shape_name=shape_name, kind=s.kind,
                step=fn, abstract_args=args, model=m,
                device=torch.device(device), mesh=mesh, arg_specs=arg_specs)
