"""Step builders: train / prefill / serve steps, on one device or run
sharded over a ``DeviceMesh``.

``build_cell`` is the entry the trainer and the dry-run census use: given
(arch, shape) it returns the step function, the model, and ``meta``
tensors (shape and dtype, no memory) standing in for every argument.
Given a mesh, it also records each argument leaf's partition spec under
the sharding rules (``sharding/rules.py``), and ``Cell.arg_local_bytes``
counts one device's share.

Given a ``DeviceMesh`` (a process group that is up), the steps run
sharded, the port's counterpart of the reference's jit with in/out
shardings and ``activation_sharding_ctx``: each step places its
arguments as DTensors by their specs (its ``in_shardings``), runs the
model inside ``activation_sharding_ctx`` (the models' ``shard_activation``
points redistribute there) and ``implicit_replication`` (the masks,
positions and rope tables every rank builds whole are taken as
replicated), and returns params, AdamW state and caches placed by the
same specs (its ``out_shardings``), the loss and logits replicated. A
``MeshShape`` (a mesh as data, for the census) gives specs only; its
steps run on one device.

What the reference's ``repro/launch/steps.py`` has and this one leaves
out: ``donate`` (a functional torch step has no buffers to donate: it
returns new tensors and the caller drops the old ones) and
``Cell.lower`` (XLA lowering, which torch has no counterpart of: see
``launch/__init__.py``). Layers are never scanned: the reference scans
the full configs (``scan_layers = not smoke``) because XLA's compile
time grows with an unrolled graph's depth; eager torch builds nothing
per layer, so the Python loop over layers costs nothing before the
first step.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchDef, SHAPES, SMOKE_SHAPES, input_specs
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step
from repro_torch.sharding.ctx import activation_sharding_ctx, full_value
from repro_torch.sharding.rules import (DEFAULT_RULES, ShardingRules,
                                        distribute_tree, local_shape,
                                        mesh_sizes, partition_spec,
                                        spec_leaves, tree_specs)


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


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (steps run sharded over it),
    not a mesh as data (``launch.mesh.MeshShape``: specs only)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


@contextlib.contextmanager
def sharded(mesh, rules: ShardingRules):
    """The context a step runs sharded in: ``activation_sharding_ctx``,
    and ``implicit_replication`` for the constants every rank builds
    whole (masks, positions, rope tables): the models make those from
    host ints, the same on every rank, so taking them as replicated is
    exact and keeps them plain tensors. Inference steps run under
    ``no_grad`` there: DTensor's views of weights made outside
    ``inference_mode`` refuse it."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), activation_sharding_ctx(mesh, rules):
        yield


def cache_specs_of(mesh, rules: ShardingRules, model, cache):
    """The partition spec of each leaf of ``cache`` (its host-int
    ``len``: ``()``), from the model's ``cache_axes()``."""
    return tree_specs(mesh, rules, model.cache_axes(), cache)


def make_train_step(model, opt_cfg: AdamWConfig, *, mesh=None,
                    rules: ShardingRules = DEFAULT_RULES):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss and its gradient by autograd, then one AdamW step. Functional:
    the params and state it is given are left as they were. Over a
    ``DeviceMesh``: each argument placed by its specs, every gradient
    placed as its param (a partial sum over the data ranks is
    reduce-scattered there) before AdamW updates the local shards; the
    loss and grad_norm replicated."""
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss, grads = loss_and_grads(model, params, batch)
            with torch.no_grad():
                params, opt_state, metrics = adamw_step(opt_cfg, params,
                                                        grads, opt_state)
            metrics["loss"] = loss
            return params, opt_state, metrics
        return train_step
    p_sp = param_specs_of(mesh, rules, model)
    o_sp = {"m": p_sp, "v": p_sp, "step": ()}

    def sharded_train_step(params, opt_state, batch):
        params = distribute_tree(params, mesh, p_sp)
        opt_state = distribute_tree(opt_state, mesh, o_sp)
        batch = distribute_tree(batch, mesh, batch_specs(mesh, rules, batch))
        with sharded(mesh, rules):
            loss, grads = loss_and_grads(model, params, batch)
            grads = distribute_tree(grads, mesh, p_sp)
            with torch.no_grad():
                params, opt_state, metrics = adamw_step(opt_cfg, params,
                                                        grads, opt_state)
        metrics["loss"] = full_value(loss)
        metrics["grad_norm"] = full_value(metrics["grad_norm"])
        return params, opt_state, metrics
    return sharded_train_step


def make_prefill_step(model, max_len: int, *, mesh=None,
                      rules: ShardingRules = DEFAULT_RULES):
    """(params, batch) -> (logits of the last position, cache)."""
    if mesh is None:
        def prefill_step(params, batch):
            with torch.inference_mode():
                return model.prefill(params, batch, max_len)
        return prefill_step
    p_sp = param_specs_of(mesh, rules, model)

    def sharded_prefill_step(params, batch):
        params = distribute_tree(params, mesh, p_sp)
        batch = distribute_tree(batch, mesh, batch_specs(mesh, rules, batch))
        with torch.no_grad(), sharded(mesh, rules):
            logits, cache = model.prefill(params, batch, max_len)
            cache = distribute_tree(cache, mesh,
                                    cache_specs_of(mesh, rules, model, cache))
        return full_value(logits), cache
    return sharded_prefill_step


def make_serve_step(model, *, mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """(params, cache, tokens [B, 1]) -> (logits, cache): one decode step."""
    if mesh is None:
        def serve_step(params, cache, tokens):
            with torch.inference_mode():
                return model.decode_step(params, cache, tokens)
        return serve_step
    p_sp = param_specs_of(mesh, rules, model)

    def sharded_serve_step(params, cache, tokens):
        c_sp = cache_specs_of(mesh, rules, model, cache)
        params = distribute_tree(params, mesh, p_sp)
        cache = distribute_tree(cache, mesh, c_sp)
        tokens = distribute_tree(tokens, mesh,
                                 batch_specs(mesh, rules, tokens))
        with torch.no_grad(), sharded(mesh, rules):
            logits, cache = model.decode_step(params, cache, tokens)
            cache = distribute_tree(cache, mesh, c_sp)
        return full_value(logits), cache
    return sharded_serve_step


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
    shape: object = None    # the ShapeSpec of shape_name (smoke or full)

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

    def place(self, args: tuple) -> tuple:
        """A one-device argument tuple (trees like ``abstract_args``)
        placed on the cell's ``DeviceMesh`` by ``arg_specs``: each leaf a
        DTensor (a host int, a cache's length, as it is)."""
        if not is_device_mesh(self.mesh):
            raise ValueError("Cell.place needs a cell built over a "
                             "DeviceMesh")
        return tuple(distribute_tree(a, self.mesh, sp)
                     for a, sp in zip(args, self.arg_specs))


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
    ``rules``; with a ``DeviceMesh``, the step runs sharded over it
    (``Cell.place`` places one-device arguments)."""
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
    run_on = {}
    if is_device_mesh(mesh):
        run_on = {"mesh": mesh, "rules": rules}
    if s.kind == "train":
        p_abs = _meta_params(pspecs, lambda d: d)
        fn = make_train_step(m, opt_cfg or AdamWConfig(), **run_on)
        args = (p_abs, adamw_init(p_abs), ispecs["batch"])
    else:
        # serving keeps bf16 weights (cast once at load): half the
        # resident parameter bytes.
        p_abs = _meta_params(pspecs, lambda d: torch.bfloat16
                             if d == torch.float32 else d)
        if s.kind == "prefill":
            # VLMs prepend the visual prefix to the decoder cache
            extra = getattr(getattr(m, "cfg", None), "n_patches", 0)
            fn = make_prefill_step(m, max_len=s.seq + extra, **run_on)
            args = (p_abs, ispecs["batch"])
        else:
            fn = make_serve_step(m, **run_on)
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
                device=torch.device(device), mesh=mesh, arg_specs=arg_specs,
                shape=s)
