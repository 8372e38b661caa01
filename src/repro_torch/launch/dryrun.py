"""Dry-run: every (arch x input-shape) cell on the production meshes,
each step traced on ``meta`` tensors over a fake process group, with
what each device would hold, move and compute.

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh both --out artifacts/dryrun

Writes one JSON per (arch, shape, mesh) cell under --out, with the
reference's field names:

- the census: ``memory_model.args`` (per-device bytes of each argument
  group under the sharding rules), ``grads_est``, ``remat_stash_est``,
  ``params_total``, ``params_active``, ``model_flops`` (6·N_active·tokens
  to train, 2·N_active·batch to serve) and ``n_devices``;
- the step trace (``op_trace.trace_step``: the cell's step run once over
  a ``DeviceMesh`` of a fake group of the mesh's size, every local op and
  collective recorded): ``cost`` (``flops``: per device, by
  ``torch.utils.flop_counter``'s formulas, which count matmuls,
  convolutions and attention; ``bytes accessed``: per device, the bytes
  each traced op reads and writes — eager torch fuses nothing, so this
  is the unfused sum, above what XLA's fused HLO reports),
  ``collectives`` (``op_trace.collective_summary``: result bytes by
  kind, and the count), ``memory_model.liveness_peak`` (``hbm_model``),
  ``transient_top4`` and ``total`` (args + liveness), ``ops`` (the traced
  aten ops: the reference's ``hlo_ops`` counts HLO lines) and ``trace_s``
  (the trace's seconds, in place of ``lower_s`` and ``compile_s``).

Nothing is allocated and no device is needed. Any cell that fails to
trace is a bug in the sharding config or the sharded step: it is
reported and the run exits nonzero, as the reference's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback

from repro_torch.configs import REGISTRY, applicable_shapes
from repro_torch.configs.base import SHAPES
from repro_torch.launch import hbm_model, op_trace
from repro_torch.launch.mesh import MeshShape, make_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, is_device_mesh
from repro_torch.sharding.rules import (DEFAULT_RULES, SP_RULES, local_shape,
                                        mesh_sizes, partition_spec)


def cell_rules(arch_id: str, shape_name: str, mesh):
    """The reference's production rules for a cell: Megatron-SP
    sequence-sharded layer boundaries to train (a 16x smaller remat
    stash); the plain rules to serve, except that a decode whose kv_heads
    do not divide the ``model`` axis shards attention over head_dim
    (a partial-score all-reduce instead of per-layer KV-cache gathers)."""
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return SP_RULES
    if kind == "decode":
        cfg = getattr(REGISTRY[arch_id].model(smoke=False), "cfg", None)
        lm = getattr(cfg, "lm", cfg)
        kvh = getattr(lm, "n_kv_heads", 0)
        if kvh and kvh % mesh_sizes(mesh).get("model", 1) != 0:
            return DEFAULT_RULES.override(heads=None, head_dim="model")
    return DEFAULT_RULES


def traced_cell(arch_id: str, shape_name: str, mesh, rules=None, *,
                smoke: bool = False, model=None, wrap=None):
    """(cell, trace): the cell of (arch, shape) over a ``DeviceMesh`` of
    ``mesh``'s dims and names on a fake process group of its size, and
    ``op_trace.trace_step`` of its step (of ``wrap(cell)``'s, given
    ``wrap``). Every tensor is ``meta``: no card is needed. Refused while
    another default group is up (``op_trace.fake_process_group``)."""
    sizes = mesh_sizes(mesh)
    if rules is None:
        rules = cell_rules(arch_id, shape_name, mesh)
    with op_trace.fake_process_group(math.prod(sizes.values())):
        dmesh = make_mesh(tuple(sizes.values()), tuple(sizes), device="cpu")
        cell = build_cell(REGISTRY[arch_id], shape_name, device="meta",
                          mesh=dmesh, rules=rules, smoke=smoke, model=model)
        return cell, op_trace.trace_step(wrap(cell) if wrap else cell)


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
             rules=None, verbose: bool = True, trace: bool = False) -> dict:
    """The census of one cell on ``mesh`` (a ``MeshShape``, a
    ``DeviceMesh`` or anything the sharding rules can read; a
    ``DeviceMesh`` is read as its names and sizes), and with ``trace`` its
    step traced over a fake group of the mesh's size (``traced_cell``)
    with the reference's cost, collective and liveness fields."""
    arch = REGISTRY[arch_id]
    if is_device_mesh(mesh):
        mesh = MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    if rules is None:
        rules = cell_rules(arch_id, shape_name, mesh)
    cell = build_cell(arch, shape_name, device="meta", mesh=mesh,
                      rules=rules, smoke=False)
    args_local = cell.arg_local_bytes()
    s = SHAPES[shape_name]
    stash = 0
    if cell.kind == "train":
        # the bf16 layer-boundary activations remat saves, one per layer
        # (the port never scans layers)
        cfg = getattr(cell.model, "cfg", None)
        lmcfg = getattr(cfg, "lm", cfg)
        n_saves = getattr(lmcfg, "n_layers", 0)
        if arch.family == "audio":
            n_saves *= 2
        shape = (s.batch, s.seq, getattr(lmcfg, "d_model", 0))
        spec = partition_spec(mesh, rules, ("batch", "seq_save", None), shape)
        b, t, d = local_shape(mesh, spec, shape)
        stash = n_saves * b * t * d * 2
    grads = args_local.get("params", 0) if cell.kind == "train" else 0
    n_total = cell.model.param_count()
    n_active = cell.model.active_param_count()
    tokens = s.batch * s.seq if cell.kind == "train" else s.batch
    model_flops = (6 if cell.kind == "train" else 2) * n_active * tokens
    mem_model = {"args": args_local, "grads_est": int(grads),
                 "remat_stash_est": int(stash)}
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind,
        "n_devices": math.prod(mesh_sizes(mesh).values()),
        "memory_model": mem_model,
        "params_total": int(n_total), "params_active": int(n_active),
        "model_flops": float(model_flops),
    }
    if trace:
        _, tr = traced_cell(arch_id, shape_name, mesh, rules)
        if tr.arg_bytes != args_local:
            raise AssertionError(f"traced argument bytes {tr.arg_bytes} "
                                 f"differ from the census's {args_local}")
        liveness = hbm_model.peak_hbm_bytes(tr)
        mem_model.update(
            transient_top4=sum(op_trace.largest_buffers(tr, 4)),
            liveness_peak=int(liveness),
            total=int(sum(args_local.values()) + liveness))
        rec.update(cost={"flops": float(tr.flops),
                         "bytes accessed": float(tr.bytes_accessed)},
                   collectives=op_trace.collective_summary(tr),
                   ops=tr.n_ops, trace_s=round(tr.seconds, 2))
    if verbose and trace:
        coll = rec["collectives"]
        print(f"[dryrun] {arch_id:26s} {shape_name:12s} {mesh_name:18s} "
              f"trace={rec['trace_s']:6.1f}s "
              f"flops/dev={rec['cost']['flops']:.3e} "
              f"coll={sum(coll[k] for k in op_trace.COLLECTIVES) / 2**20:9.1f}"
              f"MiB peak≈{mem_model['total'] / 2**30:6.2f}GiB "
              f"(args={sum(args_local.values()) / 2**30:.2f}G)", flush=True)
    elif verbose:
        per_dev = sum(args_local.values()) + grads + stash
        print(f"[dryrun] {arch_id:26s} {shape_name:12s} {mesh_name:18s} "
              f"args/dev={sum(args_local.values()) / 2**30:8.2f}GiB "
              f"+grads+stash={per_dev / 2**30:8.2f}GiB "
              f"flops={model_flops:.3e}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel layer boundaries for train")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(REGISTRY) if args.arch == "all" else [args.arch]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16",
                       make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16",
                       make_production_mesh(multi_pod=True)))
    rules = DEFAULT_RULES if args.no_sp else None

    failures = []
    for mesh_name, mesh in meshes:
        for aid in archs:
            shapes = (applicable_shapes(REGISTRY[aid]) if args.shape == "all"
                      else [args.shape])
            for sn in shapes:
                fn = os.path.join(args.out, f"{aid}__{sn}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(fn):
                    continue
                try:
                    rec = run_cell(aid, sn, mesh, mesh_name, rules=rules,
                                   trace=True)
                except Exception as e:  # noqa: BLE001 — report every cell
                    traceback.print_exc()
                    failures.append((aid, sn, mesh_name, repr(e)))
                    continue
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print("\nDRY-RUN FAILURES (sharding bugs):")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run cells traced OK")


if __name__ == "__main__":
    main()
