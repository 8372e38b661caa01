"""Perf iteration tool: trace ONE cell under a rules variant and print
the roofline-relevant deltas (collective bytes by kind and by op and
shape, the liveness peak, flops per device): the measure step of
hypothesis -> change -> measure. The reference compiles the cell with
XLA; this traces its step (``op_trace``, on a fake group of the 16x16
mesh's 256 ranks, nothing allocated).

    PYTHONPATH=src python -m repro_torch.launch.perf_iter \\
        --arch llama3.2-1b --shape train_4k [--rules auto|default] [--report]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import SHAPES
from repro_torch.launch import hbm_model, op_trace
from repro_torch.launch.dryrun import traced_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.rules import DEFAULT_RULES, SP_RULES


def measure(arch_id, shape_name, rules, label, report=False):
    """Trace (arch, shape) on the 16x16 mesh under ``rules`` and print
    the reference's lines; returns its numbers."""
    cell, tr = traced_cell(arch_id, shape_name, make_production_mesh(),
                           rules)
    cs = op_trace.collective_summary(tr)
    coll = sum(cs[k] for k in op_trace.COLLECTIVES)
    live = hbm_model.peak_hbm_bytes(tr)
    args = sum(tr.arg_bytes.values())
    print(f"\n==== {label}: {arch_id} {shape_name}")
    print(f"  collective total {coll/2**30:8.2f} GiB   "
          f"(AR {cs['all-reduce']/2**30:.2f} AG {cs['all-gather']/2**30:.2f} "
          f"RS {cs['reduce-scatter']/2**30:.2f} A2A {cs['all-to-all']/2**30:.2f})")
    print(f"  flops/dev {tr.flops:.3e}   bytes {tr.bytes_accessed:.3e}")
    print(f"  peak HBM modeled {(live+args)/2**30:8.2f} GiB "
          f"(args {args/2**30:.2f} + live {live/2**30:.2f})")
    print("  top collectives:")
    for b, c, (kind, shape) in op_trace.top_collectives(tr, 8):
        print(f"    {b/2**20:9.1f} MiB x{c:4d} {kind:15s} {shape[:70]}")
    if report:
        print("  live at peak:")
        for b, n, s in hbm_model.peak_report(tr, 8):
            print(f"    {b/2**20:9.1f} MiB  {n[:44]:44s} {s}")
    return {"coll": coll, "cs": cs, "live": live, "args": args,
            "flops": float(tr.flops)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--rules", default="auto")
    ap.add_argument("--report", action="store_true")
    a = ap.parse_args(argv)
    rules = (SP_RULES if SHAPES[a.shape].kind == "train" else DEFAULT_RULES) \
        if a.rules == "auto" else DEFAULT_RULES
    return measure(a.arch, a.shape, rules, a.rules, report=a.report)


if __name__ == "__main__":
    main()
