"""FLOP/byte/collective calibration by depth extrapolation.

The reference calibrates because XLA's ``cost_analysis`` visits a scanned
layer loop once. The port never scans (its traces count every layer),
but a full-depth trace takes long (deepseek-7b's 30-layer ``train_4k`` at
16x16: 44.5 s; deepseek-67b has 95 layers). So this traces the step of
reduced-depth variants of each (arch x shape) at the same global shapes
and mesh (``op_trace``, over a fake group of the mesh's size) and
extrapolates linearly in depth, as the reference does (layers are
homogeneous; piecewise for the MoE dense prefix and the Zamba2 shared
block):

    dense/moe/rwkv/whisper/vlm:  total(L) = f(d1) + (L - d1) * (f(d2) - f(d1))
    zamba2 (shared every E):     m = f(E+1)-f(E);  s = f(2E)-f(E)-(E-1)m
                                 total(L) = f(E) + (L-E)m + (L/E - 1)s

Writes artifacts/calib/<arch>__<shape>__<mesh>.json with the reference's
keys; ``benchmarks/roofline.py`` prefers these totals over a cell's own
record. A train cell also records ``fwd_flops`` (the loss's forward,
traced without its backward, extrapolated) and ``flops_scan_corrected``:
the reference adds one forward per scan group there (its grouped remat
re-runs one); the port runs no scan, and its per-layer remat recompute
is already in the trace, so the key equals ``flops``.

    PYTHONPATH=src python -m repro_torch.launch.calibrate \\
        [--arch A] [--shape S] [--out artifacts/calib] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import REGISTRY, applicable_shapes
from repro_torch.configs.base import SHAPES
from repro_torch.launch import op_trace
from repro_torch.launch.dryrun import traced_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.rules import DEFAULT_RULES, SP_RULES, mesh_sizes


def _reduced_model(arch, depth: int, tp: int, kind: str):
    """The full model with n_layers=depth, same family features."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.rwkv6 import RWKV6LM
    from repro_torch.models.ssm import Zamba2LM
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.models.vlm import VLM, VLMConfig
    full = arch.model(smoke=False, tp_divisor=tp)
    remat = kind == "train"
    q_chunk = 512 if kind == "train" else 1024
    if isinstance(full, VLM):
        cfg = VLMConfig(lm=dataclasses.replace(full.cfg.lm, n_layers=depth),
                        n_patches=full.cfg.n_patches)
        return VLM(cfg, tp_divisor=tp, q_chunk=q_chunk, remat=remat)
    if isinstance(full, TransformerLM):
        cfg = dataclasses.replace(full.cfg, n_layers=depth)
        return TransformerLM(cfg, tp_divisor=tp, q_chunk=q_chunk, remat=remat)
    if isinstance(full, RWKV6LM):
        cfg = dataclasses.replace(full.cfg, n_layers=depth)
        return RWKV6LM(cfg, chunk=full.chunk, remat=remat)
    if isinstance(full, Zamba2LM):
        cfg = dataclasses.replace(full.cfg, n_layers=depth)
        return Zamba2LM(cfg, chunk=full.chunk, q_chunk=q_chunk, remat=remat)
    if isinstance(full, EncDecLM):
        cfg = dataclasses.replace(full.cfg, n_layers=depth)
        return EncDecLM(cfg, tp_divisor=tp, q_chunk=q_chunk)
    raise TypeError(type(full))


def _measure(arch, shape_name, mesh, rules, depth: int, tp: int) -> dict:
    m = _reduced_model(arch, depth, tp, SHAPES[shape_name].kind)
    _, tr = traced_cell(arch.arch_id, shape_name, mesh, rules, model=m)
    coll = op_trace.collective_summary(tr)
    return {"flops": float(tr.flops), "bytes": float(tr.bytes_accessed),
            "coll": float(sum(coll[k] for k in op_trace.COLLECTIVES))}


def _extrapolate(arch, vals: dict, L: int, depths: tuple) -> dict:
    out = {}
    for key in ("flops", "bytes", "coll"):
        if arch.family == "hybrid":
            E = depths[0]
            fE, fE1, f2E = (vals[d][key] for d in depths)
            m = fE1 - fE
            s = f2E - fE - (E - 1) * m
            out[key] = fE + (L - E) * m + (L // E - 1) * s
        else:
            d1, d2 = depths
            f1, f2 = vals[d1][key], vals[d2][key]
            out[key] = f1 + (L - d1) * (f2 - f1)
    return out


def depths_for(arch) -> tuple:
    full = arch.model(smoke=False)
    cfg = getattr(full, "cfg", None)
    lm = getattr(cfg, "lm", cfg)
    if arch.family == "hybrid":
        E = lm.shared_every
        return (E, E + 1, 2 * E)
    fk = getattr(lm, "first_k_dense", 0) if getattr(lm, "n_experts", 0) else 0
    return (fk + 1, fk + 2)


def _measure_fwd(arch, shape_name, mesh, rules, depth: int, tp: int) -> float:
    """Forward-only flops at reduced depth: the trace of the model's loss
    on the train cell's placed params and batch, without its backward
    (remat off, as the reference's)."""
    from repro_torch.launch.steps import sharded
    from repro_torch.sharding.ctx import full_value
    m = _reduced_model(arch, depth, tp, "prefill")

    def forward(cell):
        def fwd(params, _opt_state, batch):
            with torch.no_grad(), sharded(cell.mesh, rules):
                return full_value(m.loss(params, batch))
        return dataclasses.replace(cell, step=fwd)
    _, tr = traced_cell(arch.arch_id, shape_name, mesh, rules, model=m,
                        wrap=forward)
    return float(tr.flops)


def run_calibration(arch_id: str, shape_name: str, mesh, mesh_name: str,
                    out_dir: str) -> dict:
    arch = REGISTRY[arch_id]
    rules = SP_RULES if SHAPES[shape_name].kind == "train" else DEFAULT_RULES
    tp = mesh_sizes(mesh).get("model", 1)
    full = arch.model(smoke=False, tp_divisor=tp)
    lm = getattr(getattr(full, "cfg", None), "lm", getattr(full, "cfg", None))
    L = lm.n_layers
    depths = depths_for(arch)
    t0 = time.perf_counter()
    vals = {d: _measure(arch, shape_name, mesh, rules, d, tp) for d in depths}
    tot = _extrapolate(arch, vals, L, depths)
    if SHAPES[shape_name].kind == "train":
        d1, d2 = depths[0], depths[1]
        f1, f2 = (_measure_fwd(arch, shape_name, mesh, rules, d, tp)
                  for d in (d1, d2))
        tot["fwd_flops"] = f1 + (L - d1) * (f2 - f1)
        tot["flops_scan_corrected"] = tot["flops"]
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "depths": list(depths), "raw": vals, "extrapolated": tot,
           "n_layers": L, "wall_s": round(time.perf_counter() - t0, 1)}
    fn = f"{out_dir}/{arch_id}__{shape_name}__{mesh_name}.json"
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[calib] {arch_id:26s} {shape_name:12s} flops={tot['flops']:.3e} "
          f"bytes={tot['bytes']:.3e} coll={tot['coll']/2**20:9.1f}MiB "
          f"({rec['wall_s']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="artifacts/calib")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    mesh = make_production_mesh(multi_pod=False)
    mesh_name = "single_pod_16x16"
    archs = sorted(REGISTRY) if args.arch == "all" else [args.arch]
    failures = []
    for aid in archs:
        shapes = (applicable_shapes(REGISTRY[aid]) if args.shape == "all"
                  else [args.shape])
        for sn in shapes:
            fn = f"{args.out}/{aid}__{sn}__{mesh_name}.json"
            if args.skip_existing and os.path.exists(fn):
                continue
            try:
                run_calibration(aid, sn, mesh, mesh_name, args.out)
            except Exception as e:  # noqa: BLE001 — report every cell
                traceback.print_exc()
                failures.append((aid, sn, repr(e)))
    if failures:
        print("CALIBRATION FAILURES:", failures)
        raise SystemExit(1)
    print("calibration complete")


if __name__ == "__main__":
    main()
