"""Port parity, slice 13: the step trace (``launch/op_trace.py``), the
liveness model over it (``launch/hbm_model.py``), the dry-run that
traces every cell (``launch/dryrun.py``), ``launch/perf_iter.py`` and
``launch/calibrate.py``, on the CPU.

Each test opens its fake process group (``op_trace.fake_process_group``,
world sizes 1 to 4) and closes it before it returns: no group outlives a
test. The traces run on ``meta`` tensors at smoke width.

- The collective table of a small DTensor program on a fake (2, 2) mesh:
  the kinds and counts ``CommDebugMode`` sees, and each result's bytes
  from its shape.
- ``hbm_model.peak_hbm_bytes`` equals the reference's
  ``repro.launch.hbm_model.peak_hbm_bytes`` on the same schedules: the
  entry computations of ``tests/test_hlo_analysis.py``'s HLO, of a
  chain, and of one with aliases and a value that dies early, each
  turned into the port's schedule (``_schedule_of``).
- The smoke llama's per-device matmul flops on (2, 1) are half of its
  (1, 1) trace's, exactly; the (1, 1) trace's argument bytes are
  ``Cell.arg_local_bytes()`` and the census's.
- The smoke llama's train and decode steps trace on a fake (1, 4) mesh,
  whose ``model`` axis does not divide its 2 kv heads.
- ``dryrun.main`` writes the reference's keys for one smoke cell,
  ``perf_iter.measure`` prints the reference's lines, and
  ``calibrate._extrapolate`` from depths 1 and 2 equals a 4-layer trace.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hbm_model as ref_hbm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import SMOKE_SHAPES  # noqa: E402
from repro_torch.launch import (calibrate, dryrun, hbm_model,  # noqa: E402
                                op_trace, perf_iter, steps)
from repro_torch.launch.mesh import MeshShape, make_mesh  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from test_hlo_analysis import HLO  # noqa: E402

LLAMA = "llama3.2-1b"


def _mesh(dims):
    return MeshShape(dims, ("data", "model"))


def _smoke_trace(dims, shape="train_4k", rules=None, model=None):
    return dryrun.traced_cell(LLAMA, shape, _mesh(dims), rules, smoke=True,
                              model=model)


# ---------------------------------------------------------------- collectives

def test_collective_table_matches_comm_debug_mode_and_the_shapes():
    """A matmul whose output is a partial sum, then three
    redistributions of it or of another tensor on a (2, 2) mesh: an
    all-reduce and an all-gather (to replicated), a reduce-scatter (to
    split) and an all-to-all (a split moved to another dim). The trace
    sees what ``CommDebugMode`` counts, each row's bytes those of its
    local result, and no ``wait_tensor``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    with op_trace.fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")

        def dt(shape, pl):
            local = list(shape)
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    local[p.dim] //= mesh.size(i)
            return DTensor.from_local(
                torch.empty(local, device="meta"), mesh, pl, run_check=False,
                shape=shape, stride=torch.empty(shape, device="meta").stride())

        def program(a, b, x):
            c = a @ b                                   # (Shard(0), Partial)
            return (c.redistribute(mesh, [Replicate(), Replicate()]),
                    c.redistribute(mesh, [Shard(0), Shard(1)]),
                    x.redistribute(mesh, [Replicate(), Shard(1)]))
        args = (dt((8, 16), [Shard(0), Shard(1)]),
                dt((16, 4), [Replicate(), Shard(0)]),
                dt((8, 8), [Replicate(), Shard(0)]))
        with CommDebugMode() as comm:
            out, trace = op_trace.trace_fn(program, *args)
    seen = {str(k).rsplit(".", 1)[-1]: v
            for k, v in comm.get_comm_counts().items()}
    table = op_trace.collective_table(trace)
    kinds = {"all_reduce": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "shard_dim_alltoall": "all-to-all"}
    assert {kinds[k]: v for k, v in seen.items()} == {
        k: sum(r["kind"] == k for r in table) for k in kinds.values()}
    # local results: the (4, 4) partial all-reduced over 'model', then
    # gathered over 'data' to (8, 4); scattered over 'model' to (4, 2);
    # x's (4, 8) rows moved to (8, 4) columns
    assert [(r["kind"], r["shape"], r["bytes"]) for r in table] == [
        ("all-reduce", "f32[4,4]", 4 * 4 * 4),
        ("all-gather", "f32[8,4]", 8 * 4 * 4),
        ("reduce-scatter", "f32[4,2]", 4 * 2 * 4),
        ("all-to-all", "f32[8,4]", 8 * 4 * 4)]
    assert not any(r["halved"] for r in table)
    assert not any("wait" in op.name for op in trace.ops if op.collective)
    summary = op_trace.collective_summary(trace)
    assert summary["count"] == 4 and summary["all-gather"] == 128
    assert summary["collective-permute"] == 0
    top = op_trace.top_collectives(trace, 2)
    assert [t[:2] for t in top] == [(128, 1), (128, 1)]
    assert [tuple(o.placements) for o in out] == [
        (Replicate(), Replicate()), (Shard(0), Shard(1)),
        (Replicate(), Shard(1))]


# ------------------------------------------------------------- liveness model

CHAIN = """
ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  %a = f32[1024]{0} add(%p0, %p0)
  %b = f32[1024]{0} add(%a, %a)
  %c = f32[1024]{0} add(%b, %b)
  %d = f32[1024]{0} add(%c, %c)
  ROOT %e = f32[1024]{0} add(%d, %d)
}
"""

# an alias (a bitcast and a tuple: 0 bytes) and a value that dies early
# (%big, read once right after its def, while %keep lives to the end)
ALIASED = """
ENTRY %main (p0: f32[256,256], p1: bf16[64]) -> (f32[256,256], f32[64]) {
  %p0 = f32[256,256]{1,0} parameter(0)
  %p1 = bf16[64]{0} parameter(1)
  %keep = f32[64]{0} convert(%p1)
  %big = f32[1024,256]{1,0} broadcast(%p0), dimensions={1}
  %red = f32[256]{0} reduce(%big), dimensions={0}
  %bc = f32[16,16]{1,0} bitcast(%red)
  %x = f32[256,256]{1,0} multiply(%p0, %p0)
  %y = f32[256,256]{1,0} add(%x, %bc)
  ROOT %t = (f32[256,256], f32[64]) tuple(%y, %keep)
}
"""


def _schedule_of(hlo: str) -> op_trace.StepTrace:
    """The entry computation of ``hlo`` as the port's schedule, read with
    the reference's own parsers: one op a line, defining its value (0
    bytes for the reference's alias ops and parameters) and using every
    earlier value its line names."""
    import re
    comps = ref_hbm._split_computations(hlo)
    ops, names = [], set()
    for line in comps[ref_hbm._entry_name(hlo)]:
        name = ref_hbm._DEF_RE.match(line).group(1)
        op = ref_hbm._op_of_line(line)
        size = 0 if op in ref_hbm._ALIAS_OPS else ref_hbm._bytes_of(
            ref_hbm._shape_of_line(line))
        refs = [r for r in re.findall(r"%?([\w.\-]+)", line.split("=", 1)[1])
                if r in names and r != name]
        ops.append(op_trace.TracedOp(op, defs=((name, size, op),),
                                     uses=tuple(dict.fromkeys(refs))))
        names.add(name)
    return op_trace.StepTrace(ops=ops)


@pytest.mark.parametrize("hlo", [HLO, CHAIN, ALIASED],
                         ids=["hlo_analysis", "chain", "aliased"])
def test_peak_equals_the_reference_on_the_same_schedule(hlo):
    sched = _schedule_of(hlo)
    assert hbm_model.peak_hbm_bytes(sched) == ref_hbm.peak_hbm_bytes(hlo)
    assert [r[0] for r in hbm_model.peak_report(sched)] == [
        r[0] for r in ref_hbm.peak_report(hlo)]


def test_the_aliased_schedule_frees_the_early_value():
    """%big (1 MiB) is live only with %red; the peak is %big, %red and
    %keep, not %big beside %x and %y."""
    peak = hbm_model.peak_hbm_bytes(_schedule_of(ALIASED))
    assert peak == 1024 * 256 * 4 + 256 * 4 + 64 * 4


def test_trace_markers_free_unread_values_and_keep_results():
    """A value no later op reads gets a ``free`` marker after its op; the
    results get the ``outputs`` marker; a view is counted, not
    scheduled."""
    def fn(x):
        y = x * 2
        _ = (y + 1).sum()                # read by nothing later
        return y.view(-1)
    _, trace = op_trace.trace_fn(fn, torch.empty(4, 4, device="meta"))
    kinds = [op.kind for op in trace.ops]
    assert kinds.count("free") >= 1 and kinds[-1] == "outputs"
    assert trace.n_views == 1 and not any(
        op.name.startswith("aten.view") for op in trace.ops)
    assert trace.n_ops == trace.n_views + kinds.count("op")
    # at the sum: y, y + 1 (read by the sum) and the sum's 4 bytes
    assert hbm_model.peak_hbm_bytes(trace) == 4 * 4 * 4 * 2 + 4


# ---------------------------------------------------------------- the steps

def _matmul_flops(trace):
    return sum(op.flops for op in trace.ops if op.kind == "op"
               and op.name.split(".")[1] in ("mm", "bmm", "addmm", "baddbmm"))


def test_per_device_flops_halve_over_two_data_ranks_and_args_are_the_census():
    """(2, 1) splits the batch: every matmul of the step (forward, remat
    recompute, backward) has half the rows, so the per-device matmul
    flops are half of (1, 1)'s exactly (``torch.utils.flop_counter`` on
    the local shapes, not the global ones a mode above DTensor sees). On
    (1, 1) the traced argument bytes are ``Cell.arg_local_bytes()`` and
    the mesh-less census's."""
    cell1, one = _smoke_trace((1, 1))
    _, two = _smoke_trace((2, 1))
    assert _matmul_flops(one) > 0
    assert 2 * _matmul_flops(two) == _matmul_flops(one)
    assert one.flops == _matmul_flops(one)
    plain = steps.build_cell(get_arch(LLAMA), "train_4k", device="meta",
                             smoke=True).arg_local_bytes()
    assert one.arg_bytes == cell1.arg_local_bytes() == plain
    assert one.n_ops > 100 and one.bytes_accessed > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_smoke_llama_traces_where_model_does_not_divide_its_kv_heads(shape):
    """(1, 4): 8 q heads split over 'model', the 2 kv heads replicated.
    The step runs (it raised in grouped-query attention before the
    repair) with its collectives, and a decode's cache ``len`` is a host
    int one short of the cache."""
    cell, trace = _smoke_trace((1, 4), shape)
    assert trace.n_ops > 0 and op_trace.collective_summary(trace)["count"]
    assert trace.arg_bytes == cell.arg_local_bytes()
    assert hbm_model.peak_hbm_bytes(trace) > 0
    if shape == "decode_32k":
        cache = op_trace._decode_args(cell)[1]
        assert cache["len"] == cell.shape.seq - 1


def test_fake_group_refuses_a_second_group():
    with op_trace.fake_process_group(2):
        with pytest.raises(RuntimeError, match="already up"):
            with op_trace.fake_process_group(2):
                pass
    import torch.distributed as dist
    assert not dist.is_initialized()


# ----------------------------------------------- dryrun, perf_iter, calibrate

@pytest.fixture
def smoke_cells(monkeypatch):
    """``dryrun`` and ``perf_iter`` building smoke cells at the names of
    the full ones (the full ones take seconds to minutes to trace)."""
    build = dryrun.build_cell
    monkeypatch.setattr(dryrun, "build_cell",
                        lambda *a, **k: build(*a, **{**k, "smoke": True}))
    monkeypatch.setattr(dryrun, "SHAPES", SMOKE_SHAPES)


def test_dryrun_main_writes_the_reference_keys(smoke_cells, tmp_path, capsys):
    dryrun.main(["--arch", LLAMA, "--shape", "decode_32k", "--mesh",
                 "single", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / f"{LLAMA}__decode_32k__single_pod_16x16"
                      ".json").read_text())
    assert {"cost", "collectives", "ops", "trace_s"} <= set(rec)
    assert set(rec["memory_model"]) == {
        "args", "grads_est", "remat_stash_est", "transient_top4",
        "liveness_peak", "total"}
    mm = rec["memory_model"]
    assert mm["total"] == sum(mm["args"].values()) + mm["liveness_peak"]
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert set(rec["collectives"]) == set(op_trace.COLLECTIVES) | {"count"}
    out = capsys.readouterr().out
    assert "flops/dev=" in out and "coll=" in out and "peak≈" in out
    assert "all dry-run cells traced OK" in out


def test_perf_iter_prints_the_reference_lines(smoke_cells, capsys):
    res = perf_iter.measure(LLAMA, "train_4k", dryrun.SP_RULES, "auto",
                            report=True)
    out = capsys.readouterr().out
    for line in ("==== auto: llama3.2-1b train_4k", "collective total",
                 "flops/dev", "peak HBM modeled", "top collectives:",
                 "live at peak:"):
        assert line in out
    assert res["flops"] > 0 and res["coll"] == sum(
        res["cs"][k] for k in op_trace.COLLECTIVES)


def test_calibrate_extrapolates_two_depths_to_a_full_trace():
    """A homogeneous smoke llama on (2, 2): the flops, bytes and
    collective bytes of depths 1 and 2, extrapolated to 4 layers
    (``calibrate._extrapolate``), equal a 4-layer trace's."""
    arch = get_arch(LLAMA)
    cfg = arch.model(smoke=True).cfg

    def measure(depth):
        m = TransformerLM(dataclasses.replace(cfg, n_layers=depth),
                          tp_divisor=2, q_chunk=512, remat=True)
        _, tr = _smoke_trace((2, 2), rules=dryrun.SP_RULES, model=m)
        coll = op_trace.collective_summary(tr)
        return {"flops": float(tr.flops), "bytes": float(tr.bytes_accessed),
                "coll": float(sum(coll[k] for k in op_trace.COLLECTIVES))}
    vals = {d: measure(d) for d in (1, 2)}
    assert calibrate._extrapolate(arch, vals, 4, (1, 2)) == measure(4)
    assert calibrate.depths_for(arch) == (1, 2)
