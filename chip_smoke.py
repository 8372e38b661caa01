#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, one line each; any failure exits non-zero and prints no result:

1. device    the card's name and power limit (nvidia-smi)
2. build     nvcc for sm_90a, one process per kernel source, all at once
3. kernels   each CUDA kernel against its plain torch version at the edge
             shapes (T in {1, 16, 32}; fuse, uniform, no stage 1, bloom,
             always): exact equality
4. main      the paper's §5.4 point query at full width: a chained
             ``LsmStore`` of 16 flushes x 500,000 keys (8M keys, a ~41 MB
             bank), ``get_batch`` of 1,048,576 existing and 1,048,576
             missing keys (one fused ``lsm_probe`` launch each), and its
             ``FilterService`` bank probe (``lsm_chain_probe``); values
             exact, reads == 1 on existing keys and <= 1 on misses, a
             2,000-key sample equal to the host model
5. baselines chained / bloom (bits per key matched) / none stores at
             8 x 100,000 keys (the ``benchmarks/lsm_store.py`` grid) and
             the bloom store's bank probe (``bloom_probe``)
6. serving   zipfian read-heavy traffic with compaction, replayed against
             a dict
7. times     each kernel's device time (20 calls in one CUDA graph,
             median of 5 replay windows of >= 5 ms), its time per eager
             call and its plain version's at the main path's shapes,
             beside bounds counted from the work these keys need

Then one JSON line of kernel records, the card line and the result line.
Launch counts are set to 0 just before each path is driven and read just
after; launches made to compare a kernel with its plain version or to
time it are not counted.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SMS, INT32_LANES = 132, 64         # INT32 lanes per SM per clock (Hopper)
# the main path's size: 16 flushes x 500,000 keys, 1,048,576-key batches
FLUSHES, PER_TABLE, QUERIES = 16, 500_000, 1_048_576

# Integer instructions that each function needs, counted from csrc/
# (probe_common.cuh, lsm_probe.cu, bloom_probe.cu). Loads go through the
# load/store unit, and values that depend only on a table (seed*golden,
# seed*7919+i, ...) are made once per table, so neither is counted.
# fmix32 = 8 (three shift-xor pairs, two multiplies); hash_u32 = 18 (two
# fmix32, two xors); fastrange = 1 (__umulhi). A fuse stage 1 = 108: the
# window start (hash, fastrange), 3 slots of hash, fastrange, 3 index ops
# and a xor, and the fingerprint (hash, masked xor, compare); a uniform one
# = 83 (one index op per slot, no window). The Othello stage 2 = 48: two
# hash + fastrange, two word indices (shift, add), two bit shifts (mask,
# shift), xor and test; it is needed only where stage 1 passes. A Bloom
# probe = 24 (hash, fastrange, word index, bit test) and is needed up to
# the key's first zero bit. Each table costs 2 to fold its decision into
# the mask, each key 5 (its index, the bound check, the outputs).
OPS_STAGE1 = {"fuse": 108, "uniform": 83}
OPS_OTHELLO, OPS_BLOOM_PROBE, OPS_TABLE, OPS_KEY = 48, 24, 2, 5
TIME_WINDOWS, WINDOW_MS = 5, 5.0   # median of 5 windows of >= 5 ms each


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def chain_ops(chain, n_keys: int, n_pass: int) -> int:
    """Integer ops one 'chain' table needs for ``n_keys`` keys, of which
    ``n_pass`` pass its stage 1 (all of them without a stage 1)."""
    s1 = 0 if chain[1] is None else OPS_STAGE1[chain[1][0]] * n_keys
    return s1 + OPS_OTHELLO * n_pass


def bound(n_bytes: float, n_ops: float, int32_per_s: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / int32_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script runs only on a GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import hashing as H
        from repro_torch.core.lsm import LsmLevelChained
        from repro_torch.kernels import _build, common, selfcheck
        from repro_torch.kernels.bloom_probe import bloom_probe, bloom_probe_ref
        from repro_torch.kernels.lsm_probe import (lsm_chain_probe,
                                                   lsm_chain_probe_ref,
                                                   lsm_probe, lsm_probe_ref)
        from repro_torch.storage import (LatencyAccountant, LsmStore,
                                         zipfian_read_heavy)
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script ({exc})")
    kernels = {"lsm_probe": lsm_probe, "lsm_chain_probe": lsm_chain_probe,
               "bloom_probe": bloom_probe}

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0

    def cuda_ms(fn, windows: int = TIME_WINDOWS) -> tuple[float, list]:
        """Median ms per call over ``windows`` CUDA-event windows, each of
        enough warm calls to cover WINDOW_MS; also every window's ms."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        est_ms = (time.perf_counter() - t0) * 1e3 / 3
        iters = max(3, math.ceil(WINDOW_MS / est_ms))
        per = []
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            per.append(start.elapsed_time(end) / iters)
        return statistics.median(per), per

    def graph_ms(fn, calls: int = 20) -> tuple[float, list]:
        """Device ms per call: ``calls`` calls captured in one CUDA graph,
        so no host launch work sits between them, replayed in
        ``cuda_ms`` windows."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        ms, per = cuda_ms(graph.replay)
        return ms / calls, [t / calls for t in per]

    t_start = time.monotonic()
    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    card = smi("name,power.limit")
    print(card, flush=True)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    int32_per_s = SMS * INT32_LANES * sm_mhz * 1e6
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | max SM clock {sm_mhz:.0f} MHz -> "
          f"INT32 peak {int32_per_s / 1e12:.2f} Tops/s", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build_all()
    regs = "; ".join(
        f"{s}: " + ", ".join(line.split("ptxas info    : ")[-1]
                             for line in log.splitlines() if "registers" in line)
        for s, log in sorted(_build.build_logs.items()))
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.1f} s | {regs}",
          flush=True)

    # -- 3. kernels vs plain at the edge shapes ------------------------------
    reset_counts()
    results = selfcheck.run_edge_checks(dev)
    torch.cuda.synchronize()
    bad = {name: sum(b for k, _, b in results if k == name) for name in kernels}
    print("kernels: " + json.dumps([
        {"name": name, "launches": fn.launches, "mismatches": bad[name],
         "cases": [c for k, c, _ in results if k == name]}
        for name, fn in kernels.items()]), flush=True)
    check(all(v == 0 for v in bad.values()), f"kernel != plain version: {bad}")
    check(all(fn.launches > 0 for fn in kernels.values()),
          "an edge check launched no kernel")

    # -- 4. main path at full width -------------------------------------------
    per, n_fl, nq = PER_TABLE, FLUSHES, QUERIES
    keys = H.random_keys(per * n_fl + nq, seed=42)
    stored = keys[:per * n_fl]
    rng = np.random.default_rng(7)
    exist = rng.choice(stored, nq, replace=False)
    miss = keys[per * n_fl:]
    t0 = time.monotonic()
    store = LsmStore(filter_kind="chained", auto_compact=False,
                     memtable_capacity=2**62, device=dev)
    for i in range(n_fl):
        ks = stored[i * per:(i + 1) * per]
        store.put_batch(ks, ks >> np.uint64(13))
        store.flush()
    t_build = time.monotonic() - t0
    gen = store.generation
    check(gen.n_tables == n_fl, f"expected {n_fl} tables, got {gen.n_tables}")
    reset_counts()
    f_e, v_e, r_e = store.get_batch(exist)
    f_m, v_m, r_m = store.get_batch(miss)
    bank_m, bank_p = store.service.probe(exist)
    main_launches = {"lsm_probe": lsm_probe.launches,
                     "lsm_chain_probe": lsm_chain_probe.launches}
    torch.cuda.synchronize()
    check(main_launches["lsm_probe"] == 2,
          f"lsm_probe launched {main_launches['lsm_probe']} times for 2 get_batch")
    check(main_launches["lsm_chain_probe"] == n_fl,
          "the bank probe did not launch lsm_chain_probe once per table")
    check(bool(f_e.all()) and not f_m.any(), "found flags wrong")
    check(bool((v_e == exist >> np.uint64(13)).all()), "values wrong")
    check(bool((r_e == 1).all()), "an existing key cost other than 1 read")
    check(int(r_m.max()) <= 1, "a missing key cost more than 1 read")
    check(bool(bank_m.any(axis=0).all()), "a stored key fired no filter")
    sample = np.concatenate([exist[:1000], miss[:1000]])
    lvl = LsmLevelChained.from_parts(store.sstables, store.filters,
                                     seed=store.seed)
    ref = [lvl.point_query(int(k)) for k in sample]
    s_found, _, s_reads = store.get_batch(sample)
    check(bool((s_found == np.array([r[0] for r in ref])).all()
               and (s_reads == np.array([r[1] for r in ref])).all()),
          "store disagrees with the host model")
    bank_mb = gen.tables.nbytes / 1e6
    print(f"main: {n_fl} tables x {per} keys built in {t_build:.1f} s, bank "
          f"{bank_mb:.1f} MB ({gen.tables.nbytes / (per * n_fl):.2f} B/key, "
          f"{store.filter_bits / (per * n_fl):.2f} filter bits/key) | "
          f"get_batch {nq}+{nq} keys: avg reads exist {r_e.mean():.6f} miss "
          f"{r_m.mean():.6f} | launches {main_launches} | host model on "
          f"{len(sample)} keys MATCH", flush=True)

    # -- 5. baselines at the paper-scale grid ---------------------------------
    per_b, n_b, nq_b = 100_000, 8, 200_000
    keys_b = H.random_keys(per_b * (n_b + 1) + nq_b, seed=42)
    exist_b = np.random.default_rng(7).choice(keys_b[:per_b * n_b], nq_b,
                                               replace=False)
    miss_b = keys_b[per_b * n_b: per_b * n_b + nq_b]

    def grid_store(kind, bpk=0.0):
        s = LsmStore(filter_kind=kind, bits_per_key=bpk, seed=1,
                     memtable_capacity=2**62, auto_compact=False, device=dev)
        for i in range(n_b):
            ks = keys_b[i * per_b:(i + 1) * per_b]
            s.put_batch(ks, ks >> np.uint64(13))
            s.flush()
        return s

    grid = {"chained": grid_store("chained")}
    bpk = grid["chained"].filter_bits / (per_b * n_b)
    grid["bloom-1x"] = grid_store("bloom", bpk)
    grid["bloom-0x"] = grid_store("none")
    reads = {}
    for name, s in grid.items():
        if name == "bloom-1x":
            reset_counts()
        for qn, qs in (("exist", exist_b), ("miss", miss_b)):
            f, v, r = s.get_batch(qs)
            check(bool(f.all()) if qn == "exist" else not f.any(),
                  f"{name} {qn}: found flags wrong")
            check(bool((v[f] == qs[f] >> np.uint64(13)).all()),
                  f"{name} {qn}: values wrong")
            reads[f"{name}_{qn}"] = float(r.mean())
        if name == "bloom-1x":
            s.service.probe(exist_b)
            main_launches["bloom_probe"] = bloom_probe.launches
            check(lsm_probe.launches == 2 and bloom_probe.launches == n_b,
                  "the bloom store's path missed its kernels")
    check(reads["chained_exist"] == 1.0 and reads["chained_miss"] <= 1.0,
          "chained store broke the <= 1 read bound")
    print(f"baselines: {n_b} tables x {per_b} keys, {bpk:.2f} bits/key, "
          f"{nq_b} queries: avg reads " + json.dumps(reads), flush=True)

    # -- 6. serving with compaction ----------------------------------------
    serve = LsmStore(seed=11, memtable_capacity=25_000, compact_min_run=4,
                     device=dev)
    ops = zipfian_read_heavy(64, batch=12_500, n_keys=100_000, seed=5)
    truth: dict[int, int] = {}
    acct = LatencyAccountant()
    n_get = n_agree = 0
    for op in ops:
        if op.kind == "put":
            serve.put_batch(op.keys, op.vals)
            truth.update(zip(op.keys.tolist(), op.vals.tolist()))
            continue
        f, v, r = serve.get_batch(op.keys)
        acct.record(r)
        want_f = np.array([k in truth for k in op.keys.tolist()])
        want_v = np.array([truth.get(k, 0) for k in op.keys.tolist()],
                          np.uint64)
        n_get += len(op.keys)
        n_agree += int(((f == want_f) & (v == want_v)).sum())
    rep = acct.report()
    check(n_agree == n_get, f"serving: {n_get - n_agree} gets disagree with "
          "the dict replay")
    check(serve.stats.compactions > 0, "serving ran no compaction")
    print(f"serving: {rep['n']} gets, avg reads {rep['avg_reads']:.6f}, "
          f"max reads {rep['max_reads']}, P99 {rep['p99_us']:.1f} us (latency "
          f"model), {serve.stats.compactions} compactions, {serve.n_tables} "
          f"tables, dict replay agrees on {n_agree}/{n_get}", flush=True)

    # -- 7. times at the main path's shapes ------------------------------------
    hi, lo = common.key_lanes(exist, dev)
    n = hi.numel()
    chain0 = gen.chains[0]
    lay0 = store.service.bank.layouts[0]
    bstate = grid["bloom-1x"].service.state
    blay = bstate.bank.layouts[0]
    bargs = dict(m_bits=blay.m_bits, k=blay.k, seed=blay.seed,
                 offset=blay.offset)
    # the work these keys need: stage 1 passes per table (the probes
    # output of lsm_chain_probe: 2 where stage 1 passed) and Bloom probes
    # up to each key's first zero bit (keys alive after j probes, j < k)
    check(all(c[0] == "chain" for c in gen.chains), "main store is chained")
    passes = [int((lsm_chain_probe(gen.tables_dev, hi, lo, chain=c)[1] == 2)
                  .sum()) if c[1] is not None else n for c in gen.chains]
    bloom_probes = sum(int(bloom_probe_ref(bstate.tables, hi, lo,
                                           **dict(bargs, k=j)).sum())
                       for j in range(blay.k))
    runs = {
        "lsm_probe": (
            lambda: lsm_probe(gen.tables_dev, hi, lo, gen.desc_dev,
                              chains=gen.chains),
            lambda: lsm_probe_ref(gen.tables_dev, hi, lo, chains=gen.chains),
            8 * n + 8 * n + gen.tables.nbytes + gen.desc_dev.numel() * 4,
            (OPS_KEY + OPS_TABLE * gen.n_tables) * n
            + sum(chain_ops(c, n, p) for c, p in zip(gen.chains, passes))),
        "lsm_chain_probe": (
            lambda: lsm_chain_probe(gen.tables_dev, hi, lo, chain=chain0),
            lambda: lsm_chain_probe_ref(gen.tables_dev, hi, lo, chain=chain0),
            16 * n + 4 * lay0.width,
            OPS_KEY * n + chain_ops(chain0, n, passes[0])),
        "bloom_probe": (
            lambda: (bloom_probe(bstate.tables, hi, lo, **bargs),),
            lambda: (bloom_probe_ref(bstate.tables, hi, lo, **bargs),),
            12 * n + 4 * ((blay.m_bits + 31) // 32),
            OPS_KEY * n + OPS_BLOOM_PROBE * bloom_probes),
    }
    print(f"work: stage 1 passes {sum(passes) / n:.6f} tables per key over "
          f"{gen.n_tables} tables ({passes[0] / n:.6f} on table 0); bloom "
          f"probes {bloom_probes / n:.6f} per key of k = {blay.k}", flush=True)
    sources = {"lsm_probe": ("src/repro_torch/csrc/lsm_probe.cu",
                             "src/repro/kernels/lsm_probe.py:270"),
               "lsm_chain_probe": ("src/repro_torch/csrc/lsm_probe.cu",
                                   "src/repro/kernels/lsm_probe.py:328"),
               "bloom_probe": ("src/repro_torch/csrc/bloom_probe.cu",
                               "src/repro/kernels/bloom_probe.py:32")}
    records = []
    for name, (kern, plain, n_bytes, n_ops) in runs.items():
        got, want = kern(), plain()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        check(err == 0, f"{name}: kernel != plain version at the main shapes")
        ms, per = graph_ms(kern)
        eager_ms, _ = cuda_ms(kern)
        plain_ms, _ = cuda_ms(plain, windows=1)
        bound_ms, bound_by = bound(n_bytes, n_ops, int32_per_s)
        src, replaces = sources[name]
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
        print(f"time {name}: {ms:.4f} ms kernel on the device (graph "
              f"replay, median of windows "
              f"{', '.join(f'{t:.4f}' for t in per)}), {eager_ms:.4f} ms "
              f"per eager call (host launch path included), {plain_ms:.3f} "
              f"ms plain, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} G int ops) at {n} "
              f"keys | {card}", flush=True)
    gathers = 3 * gen.n_tables * n + 2 * sum(passes)
    gather_gb = 32 * gathers / 1e9
    print(f"time lsm_probe gather sectors: {gather_gb:.2f} GB (32 B x "
          f"{gathers / n:.3f} gathers per key: 3 per table, 2 per stage-1 "
          f"pass) = {gather_gb / (records[0]['ms'] / 1e3):.0f} GB/s achieved",
          flush=True)

    def host_ms(fn, reps: int = 3) -> float:
        fn()                                             # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    # where a get_batch goes: key split + upload, the generation probe
    # (upload, launch, download), the whole call (+ overlay and resolve)
    lanes_ms = host_ms(lambda: common.key_lanes(exist, dev))
    probe_ms = host_ms(lambda: gen.probe_batch(exist))
    get_ms = host_ms(lambda: store.get_batch(exist))
    kern_ms = records[0]["ms"]
    print(f"time get_batch: {nq / (get_ms / 1e3):.0f} keys/s ({get_ms:.1f} ms "
          f"per {nq}-key batch, host clock, {n_fl} tables) | split+upload "
          f"{lanes_ms:.1f} ms, probe_batch {probe_ms:.1f} ms (kernel "
          f"{kern_ms:.3f} ms), overlay+resolve {get_ms - probe_ms:.1f} ms, "
          f"device busy {100 * kern_ms / get_ms:.1f}% | {card} | total "
          f"{time.monotonic() - t_start:.0f} s", flush=True)

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
