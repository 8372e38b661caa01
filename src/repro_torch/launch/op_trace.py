"""The step trace: one step of a cell run once on ``meta`` tensors over a
fake process group, every aten op and collective recorded at its local
(per-device) shape. The port's counterpart of the reference's
``hlo_tools.py``, which reads XLA's optimized HLO for the same answers:
which collectives a step moves and how many bytes, which values it
holds, and the flops and bytes a device computes and touches.

    with fake_process_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        cell = build_cell(arch, "train_4k", device="cpu", mesh=mesh,
                          rules=rules)
        trace = trace_step(cell)
    collective_summary(trace)            # bytes by kind, and the count

How: the fake backend (``torch.testing``'s ``FakeProcessGroup``) gives a
group of any world size in one process, whose collectives move nothing;
DTensor runs the step over a ``DeviceMesh`` of it on ``meta`` local
tensors, so nothing is allocated. The mesh's device type is ``"cpu"``
(DTensor's sharding propagation makes fake tensors of it, which a torch
without CUDA refuses for ``"cuda"``); its Shard -> Shard redistributions
are recorded as the all-to-all they are over NCCL
(``_alltoall_on_any_mesh``), not gloo's all-gather. A ``TorchDispatchMode`` declines the
ops on DTensors (it returns ``NotImplemented``, so DTensor runs first and
desugars each into local ops and the collectives its redistributions
need) and records what reaches it: the local ops, in schedule order
(not the global-shape ops DTensor's sharding propagation runs under a
``FakeTensorMode`` to learn output shapes).
A ``FlopCounterMode`` around the step would count DTensor-level (global)
flops instead.

Each recorded op (``TracedOp``) has the storages it defines (a new
storage, with its bytes) and uses (keyed by storage, so views and a
DTensor's local tensor share their base's key: an in-place op defines
nothing; a view is counted, not scheduled), its flops (``torch.utils.flop_counter``'s formulas:
matmuls, convolutions and attention, on the local shapes), the bytes it
reads and writes, and for a collective its kind, local result shape,
dtype and bytes. ``wait_tensor`` is recorded as an alias and not counted,
as the reference skips each ``-done``. Importing this module touches no
process group and no device.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

# the reference's collective kinds (``hlo_tools.COLLECTIVES``)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# torch's collective ops by kind: ``_c10d_functional`` (what DTensor's
# redistributions call), DTensor's own all-to-all, and the ``c10d``
# in-place forms (what ``torch.distributed.all_reduce`` and its kin call)
_KIND_OF = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
}

# HLO's names of torch's dtypes (the reference's shape text)
_HLO_DTYPE = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
              torch.int16: "s16", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.int32: "s32",
              torch.float32: "f32", torch.int64: "s64",
              torch.float64: "f64", torch.complex64: "c64",
              torch.complex128: "c128"}


def shape_text(t: torch.Tensor) -> str:
    """``t``'s dtype and shape as HLO prints them: ``bf16[2,4096]``."""
    return (f"{_HLO_DTYPE.get(t.dtype, str(t.dtype))}"
            f"[{','.join(str(d) for d in t.shape)}]")


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class TracedOp:
    """One op of a step's schedule. ``defs``: (storage key, bytes, shape
    text) of each storage it allocates; ``uses``: the keys of the
    storages it reads or writes; ``collective``: {kind, shape, dtype,
    bytes} for a collective, else None; ``kind``: ``"op"``, or
    ``"free"`` / ``"outputs"`` for the markers ``trace_step`` adds (a
    value no later op reads is freed after its op; the step's results
    stay live to its end)."""
    name: str
    defs: tuple = ()
    uses: tuple = ()
    flops: int = 0
    bytes: int = 0
    collective: dict | None = None
    kind: str = "op"


@dataclass
class StepTrace:
    """A step's schedule (``ops``), the local bytes of its argument
    groups (``arg_bytes``, as ``Cell.arg_local_bytes``), and the seconds
    the trace took."""
    ops: list = field(default_factory=list)
    arg_bytes: dict = field(default_factory=dict)
    seconds: float = 0.0
    n_views: int = 0

    @property
    def n_ops(self) -> int:
        """The traced ops, views included, markers left out."""
        return self.n_views + sum(op.kind == "op" for op in self.ops)

    @property
    def flops(self) -> int:
        return sum(op.flops for op in self.ops)

    @property
    def bytes_accessed(self) -> int:
        return sum(op.bytes for op in self.ops)


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks in this one process (rank
    0), whose collectives move nothing: the ``"fake"`` backend over a
    ``FakeStore``, destroyed on exit. Refused while another default group
    is up: the trace would take its place."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a default process group is "
                           "already up; trace in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the recording mode
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _collective_kind(func) -> str | None:
    if func.namespace not in ("_c10d_functional", "c10d", "_dtensor"):
        return None
    return _KIND_OF.get(func._overloadpacket.__name__)


class _Recorder:
    """The schedule being recorded. Storages are keyed by their
    ``StorageImpl``; each one seen is held until the trace ends, so no
    key is reused by a later allocation."""

    def __init__(self):
        self.ops: list[TracedOp] = []
        self.known: dict = {}      # key -> storage (held)
        self.alias: dict = {}      # a wrapped collective result -> its own
        self.n_views = 0

    def key(self, t: torch.Tensor):
        s = t.untyped_storage()
        k = s._cdata
        self.known.setdefault(k, s)
        return self.alias.get(k, k)

    def add_args(self, tree) -> None:
        """Know the argument storages: no op defines them."""
        for t in _tensors(tree):
            self.key(t)

    def record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func._overloadpacket.__name__ in _ALIASES:
            # the same value under a new wrapper (the meta kernels of
            # these allocate one): its storage is its input's
            src = self.key(ins[0])
            for t in outs:
                self.known.setdefault(t.untyped_storage()._cdata,
                                      t.untyped_storage())
                self.alias[t.untyped_storage()._cdata] = src
            self.ops.append(TracedOp(str(func), uses=(src,)))
            return
        uses = tuple(dict.fromkeys(self.key(t) for t in ins))
        defs, seen = [], set(uses)
        for t in outs:
            st = t.untyped_storage()
            new = st._cdata not in self.known
            k = self.key(t)
            if k in seen:
                continue
            seen.add(k)
            if new:
                defs.append((k, st.nbytes(), shape_text(t)))
            else:                      # a view, an alias, written in place
                uses += (k,)
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **(kwargs or {}),
                                              out_val=out))
        coll = None
        kind = _collective_kind(func)
        if kind is not None:
            # the result: the functional forms return it; the in-place
            # ones write their first argument (a tensor, or lists of them)
            res = _tensors(args[0]) if func.namespace == "c10d" else outs
            res = [t for t in res if t.dim() or t.numel() > 1] or res
            coll = {"kind": kind,
                    "shape": ", ".join(shape_text(t) for t in res),
                    "dtype": str(res[0].dtype).removeprefix("torch."),
                    "bytes": sum(tensor_bytes(t) for t in res)}
        moved = (sum(tensor_bytes(t) for t in ins)
                 + sum(tensor_bytes(t) for t in outs))
        self.ops.append(TracedOp(str(func), tuple(defs), uses, flops, moved,
                                 coll))


# ops whose result is their input's value: a collective's wait (the
# reference's ``-done``, not counted) and its autograd wrapper
_ALIASES = {"wait_tensor", "_wrap_tensor_autograd"}

# ops that only re-describe a storage: counted, not scheduled (they move
# no byte and define nothing; the ops that read a view use its storage).
# DTensor's shard bookkeeping runs hundreds of thousands of them.
_VIEWS = {"view", "_unsafe_view", "alias", "as_strided", "expand",
          "permute", "transpose", "t", "slice", "select", "squeeze",
          "unsqueeze", "unfold", "split", "split_with_sizes", "chunk",
          "unbind", "narrow", "diagonal", "detach", "lift_fresh",
          "view_as_real", "view_as_complex", "_reshape_alias"}


@contextlib.contextmanager
def _alltoall_on_any_mesh():
    """DTensor's Shard(i) -> Shard(j) as the all-to-all it is over NCCL,
    on a ``"cpu"`` mesh too: there DTensor swaps in an all-gather and a
    chunk (gloo has no all-to-all), which would record the gathered
    bytes. The trace runs on ``meta`` tensors, whose all-to-all is its
    registered fake kernel."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor.placement_types as pt

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    was = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = was


def _mode(rec: _Recorder):
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented          # DTensor desugars it first
            out = func(*args, **(kwargs or {}))
            # DTensor's sharding propagation runs ops at global shapes
            # under a FakeTensorMode to learn their output's metadata:
            # they are not the step's
            fake = torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE)
            if fake is not None or not isinstance(func, torch._ops.OpOverload):
                return out
            if func._overloadpacket.__name__ in _VIEWS:
                rec.n_views += 1
            else:
                rec.record(func, args, kwargs, out)
            return out
    return Trace()


# ---------------------------------------------------------------------------
# tracing a cell's step
# ---------------------------------------------------------------------------

def _decode_args(cell) -> tuple:
    """The cell's abstract arguments, a decode cache's ``len`` made a
    host int: the length of a full cache less one, so the one new token
    fits (the sharded step builds its positions from a host int)."""
    args = cell.abstract_args
    if cell.kind != "decode":
        return args
    return (args[0], {**args[1], "len": cell.shape.seq - 1}, args[2])


def _place_meta(cell, args: tuple) -> tuple:
    """``Cell.place`` of ``meta`` arguments, each DTensor built from a
    ``meta`` local shard of its spec's local shape (``distribute_tensor``
    would split the whole tensor into every rank's chunk first)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.sharding.rules import (local_shape, placements,
                                            spec_leaves)
    mesh = cell.mesh

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        local = torch.empty(local_shape(mesh, spec, tuple(t.shape)),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tuple(tree_unflatten(a, [one(t, sp) for t, sp in
                                    zip(tree_leaves(a), spec_leaves(specs))])
                 for a, specs in zip(args, cell.arg_specs))


def _arg_bytes(cell, local: tuple) -> dict:
    """The bytes of each argument group's local tensors (a host int, a
    cache's ``len``, as the reference's int32 scalar), under
    ``Cell.arg_local_bytes``'s names."""
    from repro_torch.models.common import tree_leaves
    names = {"train": ("params", "opt", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "cache", "tokens")}[cell.kind]
    return {name: sum(tensor_bytes(t) if isinstance(t, torch.Tensor) else 4
                      for t in tree_leaves(tree))
            for name, tree in zip(names, local)}


def trace_fn(fn, *args) -> tuple:
    """(the result of ``fn(*args)``, its schedule as a ``StepTrace``):
    ``fn`` run once under the recording mode, the local storages of
    ``args`` (DTensors or plain tensors, in any tree) its arguments. The
    results stay live to its end (an ``outputs`` marker reads them); a
    value no later op reads is freed right after the op that made it (a
    ``free`` marker), as eager torch frees it."""
    from repro_torch.models.common import tree_map
    from repro_torch.sharding.ctx import to_local
    rec = _Recorder()
    t0 = time.perf_counter()
    rec.add_args(tuple(tree_map(to_local, a) for a in args))
    with _alltoall_on_any_mesh(), _mode(rec):
        out = fn(*args)
    out_keys = tuple(dict.fromkeys(rec.key(to_local(t))
                                   for t in _tensors(out)))
    return out, StepTrace(ops=_with_markers(rec.ops, out_keys),
                          seconds=time.perf_counter() - t0,
                          n_views=rec.n_views)


def trace_step(cell) -> StepTrace:
    """``trace_fn`` of ``cell.step`` on its abstract (``meta``) arguments
    placed as ``Cell.place`` places them (``_place_meta``) on the cell's
    ``DeviceMesh`` (a group of any backend; the fake one moves nothing),
    with ``arg_bytes`` and the seconds placing took too. A decode cache's
    ``len`` is the length of a full cache less one (``_decode_args``)."""
    from repro_torch.launch.steps import is_device_mesh
    from repro_torch.models.common import tree_map
    from repro_torch.sharding.ctx import to_local
    if not is_device_mesh(cell.mesh):
        raise ValueError("trace_step needs a cell built over a DeviceMesh")
    t0 = time.perf_counter()
    placed = _place_meta(cell, _decode_args(cell))
    _, trace = trace_fn(cell.step, *placed)
    trace.arg_bytes = _arg_bytes(cell, tuple(tree_map(to_local, a)
                                             for a in placed))
    trace.seconds = time.perf_counter() - t0
    return trace


def _with_markers(ops: list, out_keys: tuple) -> list:
    """``ops`` with a ``free`` marker after each op whose new storages no
    later op reads (and that are not results), and an ``outputs`` marker
    at the end reading the results."""
    last = {}
    for i, op in enumerate(ops):
        for k in op.uses:
            last[k] = i
    res = set(out_keys)
    out = []
    for i, op in enumerate(ops):
        out.append(op)
        dead = tuple(k for k, _, _ in op.defs
                     if last.get(k, -1) <= i and k not in res)
        if dead:
            out.append(TracedOp("free", uses=dead, kind="free"))
    out.append(TracedOp("outputs", uses=out_keys, kind="outputs"))
    return out


# ---------------------------------------------------------------------------
# the reference's analyses (``hlo_tools``), over a trace
# ---------------------------------------------------------------------------

def collective_table(trace: StepTrace) -> list[dict]:
    """Every collective of the step, in schedule order: kind, result
    shape text, bytes (the result's size: the reference's convention,
    ``dryrun.collective_bytes``), ``halved`` and a line naming the op.
    ``halved`` is always False: the reference halves an f32 collective
    only to undo XLA:CPU's promotion of bf16 (the TPU would move it at
    bf16); the traced dtype is the one the card's wire carries."""
    return [{"kind": op.collective["kind"], "shape": op.collective["shape"],
             "bytes": op.collective["bytes"], "halved": False,
             "line": f"{op.name} -> {op.collective['shape']}"[:160]}
            for op in trace.ops if op.collective is not None]


def collective_summary(trace: StepTrace) -> dict:
    """Bytes of each collective kind, and their ``count``."""
    table = collective_table(trace)
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = len(table)
    for r in table:
        out[r["kind"]] += r["bytes"]
    return out


def largest_buffers(trace: StepTrace, k: int = 6) -> list[int]:
    """The ``k`` largest distinct sizes of the storages the step
    allocates (arguments and aliases allocate none)."""
    seen = {b for op in trace.ops for _, b, _ in op.defs}
    return sorted(seen, reverse=True)[:k]


def top_collectives(trace: StepTrace, n: int = 12) -> list[tuple]:
    """(bytes, count, (kind, shape)) aggregated by (kind, shape), the
    largest first: the what-to-fix view."""
    agg: dict[tuple, list] = {}
    for r in collective_table(trace):
        a = agg.setdefault((r["kind"], r["shape"]), [0, 0])
        a[0] += r["bytes"]
        a[1] += 1
    return sorted(((v[0], v[1], k) for k, v in agg.items()),
                  reverse=True)[:n]
