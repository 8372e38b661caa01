#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, one line each; any failure exits non-zero and prints no result:

1. device    the card's name and power limit (nvidia-smi)
2. build     nvcc for sm_90a, one process per kernel source, all at once
3. kernels   each CUDA kernel against its plain torch version at the edge
             shapes (lsm: T in {1, 16, 32}; fuse, uniform, no stage 1,
             bloom, always; both paths of lsm_probe on all-fuse banks, one
             window per table at n = 1, empty windows;
             xor: alpha in {1, 8, 32} x uniform/fuse; exact: strategy a/b;
             chained: with and without stage 1, eps > 0; cascade: L in
             {1, 2, 5, 18, 1100}; seeds >= 2**31; both paths of bloom_probe
             and cascade_probe: a bitmap one chunk under and over what one
             block stages, 1.2 MB, k = 0 and 1, n = 1, 1061 and 1,500,003,
             seed 2**32-1, cascades of L = 1, 18 and 256 staged or in L2;
             both paths of xor_probe, exact_probe and chained_probe: alpha
             in {1, 3, 8, 9, 16} by both (17, 32: no plane, gather only),
             uniform and fuse, strategy a/b, with and without stage 1;
             planes at and one segment over what one block holds, 2-, 4-,
             8- and 16-bit fields, two planes in one block, the filters
             cell's exact table at n = 1, 1061 and 1,500,003, seg_len 8,
             seed 2**32-1; the filters cell's Xor and ChainedFilterAnd by
             the gather kernels) and the window path's
             partition scratch against its torch twin: exact equality
4. main      the paper's §5.4 point query at full width: a chained
             ``LsmStore`` of 16 flushes x 500,000 keys (8M keys, a ~41 MB
             bank), ``get_batch`` of 1,048,576 existing and 1,048,576
             missing keys (one fused ``lsm_probe`` launch each, by the
             window path), and its ``FilterService`` bank probe (one
             ``lsm_chain_probe`` launch per table); values exact, reads == 1 on
             existing keys and <= 1 on misses, a 2,000-key sample equal to
             the host model
5. baselines chained / bloom (bits per key matched) / none stores at
             8 x 100,000 keys (the ``benchmarks/lsm_store.py`` grid) and
             the bloom store's bank probe (``bloom_probe``, each table's
             path as ``bloom_onchip.onchip_reason`` picks it)
6. serving   zipfian read-heavy traffic with compaction, replayed against
             a dict
7. filters   the paper's §5.1-§5.3 serving bank at full width, as
             ``benchmarks/filter_service.py`` builds it: 1,000,000
             positives, lambda = 8, five filters (Bloom 1%, Xor alpha = 8,
             ExactBloomier, ChainedFilterAnd, an 18-layer
             ChainedFilterCascade) packed into one ~28.5 MB bank, and
             ``FilterService.probe`` of 4,000,000 queries (one launch each
             of bloom_probe, xor_probe, exact_probe, chained_probe and
             cascade_probe, each kernel's path as its ``onchip_reason``
             picks it: bloom_onchip for Bloom and cascade, bloomier_onchip
             for Xor, exact and chained); member and probes equal to the
             host filters on
             every query, the exact filters exact over their universes,
             bits per key against the lower bound, and ``refresh_tables``
             or ``rebuild`` after online cascade training
8. times     each kernel's device time (20 calls in one CUDA graph,
             median of 5 replay windows of >= 5 ms), its time per eager
             call and its plain version's at its path's shapes, beside
             bounds counted from the work these keys need; lsm_probe by
             both paths in turns (gather, window, window, gather), with
             the window path's scratch bytes and peak device memory as the
             allocator counts them, and both paths over the first T tables
             (T from 1 to 16) at two batch sizes: where the window path
             starts to pay; bloom_probe (grid table 0 at 1,048,576 and at
             200,000 keys, the filters bank's Bloom at 4,000,000) and
             cascade_probe by both paths in turns (gather, on-chip,
             on-chip, gather), both paths over 2^10 to 4,000,000 keys for
             four bitmaps (where the on-chip path pays), and what bounds a
             Bloom probe (k = 1, and k = 8 over a full and a half-full
             bitmap); the gather kernels' rate against the table's
             footprint (xor_probe's gather kernel over synthetic fuse
             tables of 96 B to 67 MB at 4,000,000 keys), chained_probe over
             three pass mixes, and the G gathers/s each gather row
             achieves; exact_probe by both paths in turns (gather, on-chip,
             on-chip, gather) at the filters cell's shape, the plane bytes
             of each Bloomier filter of the bank, why a path was not
             taken and what packing the bank's planes costs, and both paths of the three over 2^10 to 4,000,000
             keys (the cell's exact table, an Xor plane and two chained
             planes that fit one block); host-clock times of get_batch and
             of both FilterService banks' probes
9. query     the query layer and the prefix cache (``query_cell``,
             ``prefix_cache_cell``): ``benchmarks/query_pipeline.py``'s
             cell built with the port at its full scale (``events``,
             2^19 keys in 4 flushes with a 4-bit tag index; 2^18
             candidates through TagEq, RangeFence, TagIn, Member; a
             semijoin into ``orders``), fused == naive == a dict model,
             host-clock medians and the split of one fused run; the same
             at CI scale, reproducing BENCH_baseline.json's four counts
             exactly; a Member plan over the main store (wrapped by
             ``Catalog.create_collection(store=...)``, nothing rebuilt)
             == ``get_batch`` by one window-path launch, and a
             scan-driven plan == the snapshot's scan; the prefix cache at
             the engine's default tiers (8 / 32 / 128 entries), 400
             inserts and 4,096 lookups, ``lookup_batch`` == ``lookup``
             and the stats equal, its ``bloom_probe`` launches by path

Then one JSON line of kernel records, the card line and the result line.
Launch counts are set to 0 just before each path is driven and read just
after; launches made to compare a kernel with its plain version or to
time it are not counted.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import functools
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
# the filter bank's size: benchmarks/filter_service.py at full scale
F_POS, F_LAMBDA, F_QUERIES = 1_000_000, 8, 4_000_000

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
# A Bloomier match (xor_probe.cu, chained_probe.cu) costs what a stage 1
# does: the target hash counts 18 of it, and strategy b's constant target
# needs none. A cascade layer costs 2 (the loop and its test) where a key
# reaches it, and its Bloom probes 24 each up to the first zero bit.
OPS_STAGE1 = {"fuse": 108, "uniform": 83}
OPS_OTHELLO, OPS_BLOOM_PROBE, OPS_TABLE, OPS_KEY = 48, 24, 2, 5
OPS_TARGET_HASH = 18
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


def bloomier_ops(mode: str, hashed_target: bool) -> int:
    """Integer ops of one Bloomier match for one key."""
    return OPS_STAGE1[mode] - (0 if hashed_target else OPS_TARGET_HASH)


def bound(n_bytes: float, n_ops: float, int32_per_s: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / int32_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 9: the query layer (benchmarks/query_pipeline.py, with the port) --
Q_TAG_BITS = 4
Q_FULL, Q_CI = (1 << 19, 1 << 18), (1 << 15, 1 << 15)   # (keys, candidates)
Q_BASELINE = ("query_pipeline (filter-pushdown query plans)",
              ("survivor_reduction_frac", "semijoin_candidate_reduction",
               "semijoin_matched", "crosscheck_match"))
# the engine's default tiers (name, entries, probe cost in us)
PC_TIERS = (("hbm", 8, 1.0), ("dram", 32, 10.0), ("ssd", 128, 150.0))


def q_tag_fn(keys, vals):
    return vals & np.uint64((1 << Q_TAG_BITS) - 1)


def q_collection(cat, name, keys, vals, n_tables, seed, device):
    """A chained collection with a ``tags`` index, ``keys`` in
    ``n_tables`` flushes (as the benchmark builds it)."""
    coll = cat.create_collection(name, filter_kind="chained", seed=seed,
                                 memtable_capacity=2 ** 62,
                                 auto_compact=False, device=device)
    coll.create_index("tags", q_tag_fn, tag_bits=Q_TAG_BITS)
    per = max(1, len(keys) // n_tables)
    for i in range(n_tables):
        ks = keys[i * per:(i + 1) * per] if i < n_tables - 1 \
            else keys[i * per:]
        coll.store.put_batch(ks, vals[i * per:i * per + len(ks)])
        coll.store.flush()
    return coll


def q_naive(view, stages, cands):
    """No pushdown: every predicate over all candidates, one resolution of
    all of them, the masks ANDed at the end."""
    from repro_torch.query import Member
    from repro_torch.query.pipeline import predicate_mask
    keep = None
    for stage in stages:
        if not isinstance(stage, Member):
            m = predicate_mask(view, stage, cands)
            keep = m if keep is None else keep & m
    found, vals, _ = view.snap.get_batch(cands)
    keep = found if keep is None else keep & found
    return cands[keep], vals[keep]


def q_model_match(keys, vals, stages, cands, got_keys, got_vals) -> bool:
    """The same conjunctive plan over a dict of the collection's rows."""
    from repro_torch.query import RangeFence, TagEq, TagIn
    data = dict(zip(keys.tolist(), vals.tolist()))
    got = np.array([data.get(int(k)) is not None for k in cands])
    cvals = np.array([data.get(int(k), 0) for k in cands], dtype=np.uint64)
    keep = got.copy()
    for stage in stages:
        if isinstance(stage, RangeFence):
            keep &= ((cands >= np.uint64(stage.lo))
                     & (cands < np.uint64(stage.hi)))
        elif isinstance(stage, TagEq):
            keep &= q_tag_fn(cands, cvals) == np.uint64(stage.tag)
        elif isinstance(stage, TagIn):
            keep &= np.isin(q_tag_fn(cands, cvals),
                            np.asarray(stage.tags, np.uint64))
    return (np.array_equal(got_keys, cands[keep])
            and np.array_equal(got_vals, cvals[keep]))


def query_cell(n_keys: int, n_cands: int, device, *, repeat: int = 3,
               reset=lambda: None, read=dict, profile=None) -> dict:
    """The query cell of ``benchmarks/query_pipeline.py`` built with the
    port on ``device``: ``events`` (``n_keys`` keys in 4 flushes, a 4-bit
    ``tags`` index), ``n_cands`` candidates (half present), the 4-stage
    plan fused and naive, and a semijoin into ``orders`` (every 4th key,
    2 flushes) with a tag predicate pushed down. ``reset()`` is called
    just before the fused plan and the semijoin run once each, ``read()``
    just after; the result holds the benchmark's four counts, the naive
    and dict-model verdicts, host-clock medians, the split of one fused
    run and, given ``profile``, what it reports of one more."""
    from repro_torch.query import (Catalog, JoinStep, Member, Pipeline,
                                   RangeFence, SemiJoin, TagEq, TagIn)
    rng = np.random.default_rng(7)
    keys = rng.choice(np.uint64(2 ** 62), size=n_keys, replace=False
                      ).astype(np.uint64)
    vals = rng.integers(1, 2 ** 60, n_keys, dtype=np.uint64)
    t0 = time.perf_counter()
    cat = Catalog()
    coll = q_collection(cat, "events", keys, vals, 4, 3, device)
    build_s = time.perf_counter() - t0
    present = rng.choice(keys, size=n_cands // 2)
    absent = rng.integers(1, 2 ** 62, n_cands - len(present),
                          dtype=np.uint64)
    cands = np.concatenate([present, absent])
    rng.shuffle(cands)
    ks = np.sort(keys)
    lo, hi = int(ks[len(ks) // 4]), int(ks[3 * len(ks) // 4])
    stages = (TagEq("tags", 3), RangeFence(lo, hi), TagIn("tags", (1, 3, 5)),
              Member())
    out = {"build_s": build_s,
           "bank_bytes": coll.store.generation.tables.nbytes,
           "filter_bits": coll.store.filter_bits,
           "tag_bank_bytes": coll.indexes["tags"].service.bank.nbytes}
    with Pipeline(coll, stages).open() as ex:
        ex.run(cands)                                   # warm
        reset()
        res = ex.run(cands)
        out["fused_launches"] = read()
        fused, naive = [], []
        for _ in range(repeat):
            t = time.perf_counter()
            res = ex.run(cands)
            fused.append(time.perf_counter() - t)
            t = time.perf_counter()
            naive_k, naive_v = q_naive(ex.view, stages, cands)
            naive.append(time.perf_counter() - t)
        out["fused_ms"] = 1e3 * statistics.median(fused)
        out["naive_ms"] = 1e3 * statistics.median(naive)
        out["naive_equal"] = bool(np.array_equal(res.keys, naive_k)
                                  and np.array_equal(res.vals, naive_v))
        out["split_ms"] = q_split(ex, coll, cands)
        if profile is not None:
            out["profile"] = profile(lambda: ex.run(cands))
    out["model_match"] = q_model_match(keys, vals, stages, cands, res.keys,
                                       res.vals)
    entry = [res.n_candidates] + [n for _, n in res.stage_survivors[:-1]]
    orders = q_collection(cat, "orders", keys[::4],
                          vals[::4] + np.uint64(1), 2, 11, device)
    sj = SemiJoin(Pipeline(coll, (Member(),)),
                  (JoinStep(orders, stages=(TagIn("tags", (2, 4, 6, 8)),)),))
    reset()
    sj_stats = sj.run(cands).step_stats[0]
    out["semijoin_launches"] = read()
    out["stage_survivors"] = res.stage_survivors
    out["counts"] = {
        "survivor_reduction_frac":
            1.0 - sum(entry) / (len(stages) * res.n_candidates),
        "semijoin_candidate_reduction": float(sj_stats["reduction"]),
        "semijoin_matched": int(sj_stats["matched"]),
        "crosscheck_match": float(out["model_match"])}
    return out


def q_split(ex, coll, cands) -> dict:
    """Host ms of one fused run of the open plan ``ex``, split into the
    memtable overlay, the tag-bank probes (``FilterService.probe``), the
    membership resolution (``Snapshot.get_batch``) and the rest (numpy
    gathers and masks), by timing those calls in place."""
    spent = {"overlay": 0.0, "tag_bank_probe": 0.0, "get_batch": 0.0}

    def timed(obj, attr, part):
        fn = getattr(obj, attr)

        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[part] += time.perf_counter() - t
        setattr(obj, attr, wrapper)

    snap, svc = ex.view.snap, coll.indexes["tags"].service
    timed(snap, "memtable_probe", "overlay")
    timed(svc, "probe", "tag_bank_probe")
    timed(snap, "get_batch", "get_batch")
    try:
        t = time.perf_counter()
        ex.run(cands)
        total = time.perf_counter() - t
    finally:
        for obj, attr in ((snap, "memtable_probe"), (svc, "probe"),
                          (snap, "get_batch")):
            delattr(obj, attr)
    out = {k: 1e3 * v for k, v in spent.items()}
    out["numpy"] = 1e3 * total - sum(out.values())
    out["total"] = 1e3 * total
    return out


def prefix_cache_cell(device, *, n_inserts: int = 400, n_lookups: int = 4096,
                      seed: int = 5, reset=lambda: None, read=dict) -> dict:
    """Two caches at the engine's default tiers take the same seeded
    stream: half the inserts, half the lookups, the other half of the
    inserts (so the bank is re-packed by ``refresh_tables``), the other
    half of the lookups. One looks up by ``lookup_batch`` (``reset()`` /
    ``read()`` around both batches), its twin key by key (``lookup``).
    Half the looked-up keys were inserted, half never were."""
    from repro_torch.serving import TieredPrefixCache, TierSpec
    tiers = [TierSpec(*t) for t in PC_TIERS]
    rng = np.random.default_rng(seed)
    ins = rng.integers(1, 2 ** 62, n_inserts, dtype=np.uint64)
    look = np.concatenate([rng.choice(ins, n_lookups // 2),
                           rng.integers(2 ** 62, 2 ** 63,
                                        n_lookups - n_lookups // 2,
                                        dtype=np.uint64)])
    rng.shuffle(look)
    batched = TieredPrefixCache(tiers, seed=seed, device=device)
    single = TieredPrefixCache(tiers, seed=seed, device=device)
    got, want, versions, launches = [], [], [], []
    t_ins = t_batch = 0.0
    for part in range(2):
        sl = slice(part * n_inserts // 2, (part + 1) * n_inserts // 2)
        t = time.perf_counter()
        for i, k in zip(range(sl.start, sl.stop), ins[sl].tolist()):
            batched.insert(k, payload=i)
            single.insert(k, payload=i)
        t_ins += time.perf_counter() - t
        q = look[part * n_lookups // 2:(part + 1) * n_lookups // 2].tolist()
        reset()
        t = time.perf_counter()
        got += batched.lookup_batch(q)
        t_batch += time.perf_counter() - t
        launches.append(read())
        versions.append(batched._service.version)
        want += [single.lookup(k) for k in q]
    sa, sb = batched.stats(), single.stats()
    sb["batched_lookups"] = sa["batched_lookups"]
    return {"equal": got == want, "stats_equal": sa == sb, "stats": sa,
            "hits": sum(p is not None for p, _ in got),
            "versions": versions, "launches": launches,
            "service": batched._service,
            "overflowed": all(len(s) == t.capacity
                              for s, t in zip(batched.store, tiers)),
            "insert_ms": 1e3 * t_ins, "lookup_batch_ms": 1e3 * t_batch,
            "n_lookups": n_lookups, "n_inserts": n_inserts}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script runs only on a GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import hashing as H, theory
        from repro_torch.core.bloom import BloomFilter
        from repro_torch.core.bloomier import ExactBloomier, XorFilter
        from repro_torch.core.chained import (ChainedFilterAnd,
                                              ChainedFilterCascade)
        from repro_torch.core.lsm import LsmLevelChained
        from repro_torch.kernels import (_build, bloom_onchip,
                                         bloomier_onchip, common, lsm_window,
                                         ops, ref, selfcheck)
        from repro_torch.kernels.bloom_probe import (bloom_probe,
                                                     bloom_probe_gather,
                                                     bloom_probe_onchip,
                                                     bloom_probe_ref)
        from repro_torch.kernels.cascade_probe import (cascade_probe,
                                                       cascade_probe_gather,
                                                       cascade_probe_onchip,
                                                       cascade_probe_ref)
        from repro_torch.kernels.chained_probe import (
            chained_probe, chained_probe_gather, chained_probe_onchip,
            chained_probe_ref)
        from repro_torch.kernels.lsm_probe import (
            lsm_chain_probe, lsm_chain_probe_ref, lsm_probe, lsm_probe_gather,
            lsm_probe_ref, lsm_probe_window)
        from repro_torch.kernels.xor_probe import (
            exact_probe, exact_probe_gather, exact_probe_onchip,
            exact_probe_ref, xor_probe, xor_probe_gather, xor_probe_onchip,
            xor_probe_ref)
        from repro_torch.query import Catalog, Member, Pipeline, RangeFence
        from repro_torch.serving.filter_service import (FilterService,
                                                        bank_probe,
                                                        layout_planes)
        from repro_torch.storage import (LatencyAccountant, LsmStore,
                                         zipfian_read_heavy)
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script ({exc})")
    kernels = {"lsm_probe": lsm_probe, "lsm_chain_probe": lsm_chain_probe,
               "bloom_probe": bloom_probe, "xor_probe": xor_probe,
               "exact_probe": exact_probe, "chained_probe": chained_probe,
               "cascade_probe": cascade_probe}
    bank_kernels = ("bloom_probe", "xor_probe", "exact_probe",
                    "chained_probe", "cascade_probe")
    bloomier_kernels = ("xor_probe", "exact_probe", "chained_probe")

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        lsm_probe.window_launches = lsm_probe.gather_launches = 0
        for fn in (bloom_probe, cascade_probe, xor_probe, exact_probe,
                   chained_probe):
            fn.onchip_launches = fn.gather_launches = 0

    def path_counts() -> dict:
        return {"window": lsm_probe.window_launches,
                "gather": lsm_probe.gather_launches}

    def bloom_paths(fn) -> dict:
        """Launches of the two paths of bloom_probe, cascade_probe,
        xor_probe, exact_probe or chained_probe."""
        return {"onchip": fn.onchip_launches, "gather": fn.gather_launches}

    def geometries(*stages) -> tuple:
        """bloomier_onchip Geometry of (table layout, alpha) stages."""
        return tuple(bloomier_onchip.Geometry(t.mode, t.seg_len, t.n_seg, a)
                     for t, a in stages)

    def bloomier_rule(geos, n_keys: int) -> dict:
        """The path bloomier_onchip.onchip_reason picks for one probe."""
        onchip = int(bloomier_onchip.onchip_reason(geos, n_keys) is None)
        return {"onchip": onchip, "gather": 1 - onchip}

    def rule_paths(layer_sets, n_keys: int, words) -> dict:
        """The paths bloom_onchip.onchip_reason picks for each of
        ``layer_sets`` at ``n_keys`` keys over the bank ``words``."""
        onchip = sum(bloom_onchip.onchip_reason(
            layers, n_keys, words.numel(), words.data_ptr()) is None
            for layers in layer_sets)
        return {"onchip": onchip, "gather": len(layer_sets) - onchip}

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
    def spills(log: str) -> int:
        """Bytes of spill stores and loads over a source's kernels."""
        return sum(int(w) for line in log.splitlines()
                   for w, b, kind in zip(line.split(), line.split()[1:],
                                         line.split()[2:])
                   if b == "bytes" and kind == "spill" and w.isdigit())

    regs = "; ".join(
        f"{s}: " + ", ".join(line.split("ptxas info    : ")[-1]
                             for line in log.splitlines() if "registers" in line)
        + f" (spill bytes {spills(log)})"
        for s, log in sorted(_build.build_logs.items()))
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.1f} s | {regs}",
          flush=True)

    # -- 3. kernels vs plain at the edge shapes ------------------------------
    reset_counts()
    results = selfcheck.run_edge_checks(dev)
    torch.cuda.synchronize()
    bad = {name: max(b for k, _, b in results if k == name) for name in kernels}
    print("kernels: " + json.dumps([
        {"name": name, "launches": fn.launches, "max_abs_err": bad[name],
         "cases": [c for k, c, _ in results if k == name]}
        for name, fn in kernels.items()]), flush=True)
    check(all(v == 0 for v in bad.values()), f"kernel != plain version: {bad}")
    check(all(fn.launches > 0 for fn in kernels.values()),
          "an edge check launched no kernel")
    # both paths of lsm_probe, each against the plain version
    paths = {}
    for path in ("window", "gather"):
        errs = [b for k, c, b in results if k == "lsm_probe"
                and c.startswith(path)]
        paths[f"lsm_probe {path}"] = {
            "cases": len(errs), "max_abs_err": max(errs, default=-1),
            "launches": path_counts()[path]}
    for name, fn in ((k, kernels[k]) for k in
                     ("bloom_probe", "cascade_probe") + bloomier_kernels):
        for path in ("onchip", "gather"):
            errs = [b for k, c, b in results if k == name
                    and c.startswith(path)]
            paths[f"{name} {path}"] = {
                "cases": len(errs), "max_abs_err": max(errs, default=-1),
                "launches": bloom_paths(fn)[path]}
    part_err = {n: selfcheck.check_partition(device=dev, **a)
                for n, a in selfcheck.PARTITION_CASES}
    torch.cuda.synchronize()
    print("kernels by path: " + json.dumps(paths) + " | partition scratch "
          "vs torch twin, max_abs_err: " + json.dumps(part_err), flush=True)
    check(all(p["cases"] > 0 and p["max_abs_err"] == 0 and p["launches"] > 0
              for p in paths.values()), f"a path != plain version: {paths}")
    check(all(v == 0 for v in part_err.values()),
          "partition scratch != its torch twin")

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
    main_paths = path_counts()
    torch.cuda.synchronize()
    check(main_launches["lsm_probe"] == 2,
          f"lsm_probe launched {main_launches['lsm_probe']} times for 2 get_batch")
    check(main_launches["lsm_chain_probe"] == n_fl,
          "the bank probe did not launch lsm_chain_probe once per table")
    check(main_paths == {"window": 2, "gather": 0},
          f"get_batch did not take lsm_probe's window path: {main_paths}")
    check(bool(f_e.all()) and not f_m.any(), "found flags wrong")
    check(bool((v_e == exist >> np.uint64(13)).all()), "values wrong")
    check(bool((r_e == 1).all()), "an existing key cost other than 1 read")
    check(int(r_m.max()) <= 1, "a missing key cost more than 1 read")
    check(bool(bank_m.any(axis=0).all()), "a stored key fired no filter")
    sample = np.concatenate([exist[:1000], miss[:1000]])
    lvl = LsmLevelChained.from_parts(store.sstables, store.filters,
                                     seed=store.seed)
    model = [lvl.point_query(int(k)) for k in sample]
    s_found, _, s_reads = store.get_batch(sample)
    check(bool((s_found == np.array([r[0] for r in model])).all()
               and (s_reads == np.array([r[1] for r in model])).all()),
          "store disagrees with the host model")
    bank_mb = gen.tables.nbytes / 1e6
    print(f"main: {n_fl} tables x {per} keys built in {t_build:.1f} s, bank "
          f"{bank_mb:.1f} MB ({gen.tables.nbytes / (per * n_fl):.2f} B/key, "
          f"{store.filter_bits / (per * n_fl):.2f} filter bits/key) | "
          f"get_batch {nq}+{nq} keys: avg reads exist {r_e.mean():.6f} miss "
          f"{r_m.mean():.6f} | launches {main_launches}, lsm_probe by path "
          f"{main_paths} | host model on "
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
            grid_paths = bloom_paths(bloom_probe)
            want_paths = rule_paths(
                [((lay.m_bits, lay.k, lay.seed, lay.offset),)
                 for lay in s.service.state.bank.layouts],
                len(exist_b), s.service.state.tables)
            check(grid_paths == want_paths,
                  f"the bloom bank probe took paths {grid_paths}, the rule "
                  f"says {want_paths}")
    check(reads["chained_exist"] == 1.0 and reads["chained_miss"] <= 1.0,
          "chained store broke the <= 1 read bound")
    print(f"baselines: {n_b} tables x {per_b} keys, {bpk:.2f} bits/key, "
          f"{nq_b} queries: avg reads " + json.dumps(reads) + " | bloom "
          f"bank probe of {nq_b} keys, bloom_probe by path {grid_paths} "
          f"(bloom_onchip.onchip_reason: {want_paths})", flush=True)

    # -- 6. serving with compaction ----------------------------------------
    serve = LsmStore(seed=11, memtable_capacity=25_000, compact_min_run=4,
                     device=dev)
    traffic = zipfian_read_heavy(64, batch=12_500, n_keys=100_000, seed=5)
    truth: dict[int, int] = {}
    acct = LatencyAccountant()
    n_get = n_agree = 0
    for op in traffic:
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

    # -- 7. filters: the §5.1-§5.3 serving bank at full width --------------------
    t0 = time.monotonic()
    fkeys = H.random_keys(F_POS * (F_LAMBDA + 1) + F_QUERIES, seed=42)
    pos, neg = fkeys[:F_POS], fkeys[F_POS:F_POS * (F_LAMBDA + 1)]
    queries = np.random.default_rng(7).choice(fkeys, size=F_QUERIES,
                                              replace=True)
    builds = {}

    def timed(name, make):
        t = time.monotonic()
        f = make()
        builds[name] = time.monotonic() - t
        return f

    fbloom = timed("bloom", lambda: BloomFilter.build(pos, 0.01, seed=11))
    fxor = timed("xor", lambda: XorFilter.build(pos, 8, seed=12))
    fexact = timed("exact", lambda: ExactBloomier.build(
        pos[:F_POS // 2], neg[:F_POS], seed=13))
    fchained = timed("chained", lambda: ChainedFilterAnd.build(pos, neg,
                                                               seed=14))
    fcascade = timed("cascade", lambda: ChainedFilterCascade.build(pos, neg,
                                                                   seed=3))
    filters = [fbloom, fxor, fexact, fchained, fcascade]
    svc = FilterService(filters, device=dev)
    fstate = svc.state                      # the bank as built, for times
    t_fbuild = time.monotonic() - t0
    reset_counts()
    f_member, f_probes = svc.probe(queries)
    filter_launches = {k: kernels[k].launches for k in bank_kernels}
    torch.cuda.synchronize()
    check(all(v == 1 for v in filter_launches.values()),
          f"FilterService.probe launches {filter_launches}, not one each")
    filter_paths = {k: bloom_paths(kernels[k]) for k in
                    ("bloom_probe", "cascade_probe") + bloomier_kernels}
    flay0, flay4 = fstate.bank.layouts[0], fstate.bank.layouts[4]
    flx, fle, flc = fstate.bank.layouts[1:4]
    f_geos = {"xor_probe": geometries((flx, flx.alpha)),
              "exact_probe": geometries((fle, 1)),
              "chained_probe": geometries(
                  *(() if flc.xor is None else ((flc.xor, flc.xor.alpha),)),
                  (flc.exact, 1))}
    f_plans = {k: bloomier_onchip.plan(g) for k, g in f_geos.items()}
    filter_rule = {
        "bloom_probe": rule_paths([((flay0.m_bits, flay0.k, flay0.seed,
                                     flay0.offset),)], F_QUERIES,
                                  fstate.tables),
        "cascade_probe": rule_paths([flay4.probe_params()], F_QUERIES,
                                    fstate.tables),
        **{k: bloomier_rule(g, F_QUERIES) for k, g in f_geos.items()}}
    check(filter_paths == filter_rule,
          f"the filters bank probe took paths {filter_paths}, the rule says "
          f"{filter_rule}")
    fstats = svc.stats.as_dict()
    # every query against the host filters: member, probes, stats
    host_probes = [np.ones(F_QUERIES, np.int64)] * 3 + [
        1 + fchained.stage_queries(queries)[0].astype(np.int64),
        fcascade.probes_until_decided(queries).astype(np.int64)]
    for i, f in enumerate(filters):
        check(bool((f_member[i] == f.query(queries)).all()),
              f"filter {i}: member != host query on {F_QUERIES} queries")
        check(bool((f_probes[i] == host_probes[i]).all()),
              f"filter {i}: probes != host count")
        check(fstats["avg_probes"][i] == host_probes[i].sum() / F_QUERIES,
              f"filter {i}: avg_probes != host mean")
    # the exact filters are exact over their universes, through the kernels
    exact_universe = (pos[:F_POS // 2], neg[:F_POS])
    fp_fn = {
        "chained": (int((~ops.chained_query(fchained, pos, dev)).sum()),
                    int(ops.chained_query(fchained, neg, dev).sum())),
        "exact": (int((~ops.exact_query(fexact, exact_universe[0], dev)).sum()),
                  int(ops.exact_query(fexact, exact_universe[1], dev).sum())),
        "cascade": (int((~ops.cascade_query(fcascade, pos, dev)).sum()),
                    int(ops.cascade_query(fcascade, neg, dev).sum())),
    }
    check(all(v == (0, 0) for v in fp_fn.values()),
          f"an exact filter erred (false negatives, false positives): {fp_fn}")
    bpk = fchained.bits / F_POS
    lower = theory.f_lower_bound(0.0, float(F_LAMBDA))
    print(f"filters: {F_POS} positives, lambda {F_LAMBDA}, bank "
          f"{svc.bank.nbytes / 1e6:.1f} MB, cascade {fcascade.n_layers} "
          f"layers, chained alpha {fchained.f1.alpha} with "
          f"{fchained.n_false_pos} stage-2 whitelists | host build "
          f"{t_fbuild:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                              builds.items())
          + f") | probe of {F_QUERIES} queries: launches {filter_launches}, "
          f"by path {filter_paths} (bloom_onchip.onchip_reason, "
          f"bloomier_onchip.onchip_reason: {filter_rule}; planes in one "
          f"block, bytes: " + json.dumps({k: None if p is None else
                                          p.smem_bytes
                                          for k, p in f_plans.items()})
          + "), "
          f"member and probes == host on every query, avg_probes "
          f"{[round(float(p), 6) for p in fstats['avg_probes']]}, hit_rate "
          f"{[round(float(h), 6) for h in fstats['hit_rate']]} | exact over their "
          f"universes (false negatives, false positives): "
          + json.dumps(fp_fn), flush=True)
    print(f"filters bits/key: ChainedFilterAnd {bpk:.4f} bits per positive "
          f"against the lower bound f(0, {F_LAMBDA}) = {lower:.4f} "
          f"({bpk / lower:.4f}x); cascade {fcascade.bits / F_POS:.4f}",
          flush=True)
    # §5.3 online training, then the new contents through the service
    n_before = fcascade.n_layers
    stream = fkeys[-20_000:]
    labels = np.arange(len(stream)) % 2 == 0
    errs = fcascade.train(stream, labels)
    check(errs[-1] == 0.0, "cascade training did not converge")
    if fcascade.n_layers == n_before:
        svc.refresh_tables(filters)
        how = "refresh_tables"
    else:
        try:
            svc.refresh_tables(filters)
            fail("refresh_tables took a cascade whose layers changed")
        except ValueError:
            pass
        svc.rebuild(filters)
        how = "refresh_tables refused, rebuild"
    check(bool((svc.probe_filter(4, stream) == labels).all()),
          "the served cascade disagrees with its training labels")
    sample = queries[:200_000]
    check(bool((svc.probe(sample)[0][4] == fcascade.query(sample)).all()),
          "the served cascade disagrees with the host after training")
    print(f"filters train: {len(stream)} keys in {len(errs)} rounds (error "
          f"{errs[0]:.4f} -> {errs[-1]:.4f}), layers {n_before} -> "
          f"{fcascade.n_layers}, served through {how}: labels and host "
          "MATCH", flush=True)

    # -- 8. times at each path's shapes -----------------------------------------
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
            + sum(chain_ops(c, n, p) for c, p in zip(gen.chains, passes)), n),
        "lsm_chain_probe": (
            lambda: lsm_chain_probe(gen.tables_dev, hi, lo, chain=chain0),
            lambda: lsm_chain_probe_ref(gen.tables_dev, hi, lo, chain=chain0),
            16 * n + 4 * lay0.width,
            OPS_KEY * n + chain_ops(chain0, n, passes[0]), n),
        "bloom_probe": (
            lambda: (bloom_probe(bstate.tables, hi, lo, **bargs),),
            lambda: (bloom_probe_ref(bstate.tables, hi, lo, **bargs),),
            12 * n + 4 * ((blay.m_bits + 31) // 32),
            OPS_KEY * n + OPS_BLOOM_PROBE * bloom_probes, n),
    }
    print(f"work: stage 1 passes {sum(passes) / n:.6f} tables per key over "
          f"{gen.n_tables} tables ({passes[0] / n:.6f} on table 0); bloom "
          f"probes {bloom_probes / n:.6f} per key of k = {blay.k}", flush=True)

    # the filter bank's kernels at its shapes: 4,000,000 queries over the
    # bank as built (fstate), counting the work these keys need
    fhi, flo = common.key_lanes(queries, dev)
    fn = fhi.numel()
    fwords, flays = fstate.tables, fstate.bank.layouts
    lx, le, lc, ls = flays[1:]
    xargs = dict(mode=lx.mode, seed=lx.seed, seg_len=lx.seg_len,
                 n_seg=lx.n_seg, alpha=lx.alpha, fp_seed=lx.fp_seed,
                 offset=lx.offset)
    eargs = dict(mode=le.mode, seed=le.seed, seg_len=le.seg_len,
                 n_seg=le.n_seg, strategy=le.strategy, bit_seed=le.bit_seed,
                 offset=le.offset)
    cargs = ops.chained_and_params(lc)
    layers, cdesc = ls.probe_params(), fstate.descs[4]
    # the planes the service packed for this bank (FilterService.prepare)
    xplane, eplane = fstate.planes[1][0], fstate.planes[2][0]
    cplanes = fstate.planes[3]
    c_pass = (int((chained_probe(fwords, fhi, flo, **cargs)[1] == 2).sum())
              if lc.xor is not None else fn)
    reach = cascade_probe(fwords, fhi, flo, cdesc, layers=layers)[1]
    c_layers = c_hashes = 0
    for t, (m_bits, k, seed, offset) in enumerate(layers):
        at = reach > t                       # keys that reach layer t
        c_layers += int(at.sum())
        c_hashes += sum(int((at & ref.bloom_probe_ref(
            fwords, fhi, flo, m_bits=m_bits, k=j, seed=seed,
            offset=offset)).sum()) for j in range(k))
    s1_ops = 0 if lc.xor is None else bloomier_ops(lc.xor.mode, True) * fn
    runs.update({
        "xor_probe": (
            lambda: (xor_probe(fwords, fhi, flo, **xargs, plane=xplane),),
            lambda: (xor_probe_ref(fwords, fhi, flo, **xargs),),
            12 * fn + 4 * lx.width,
            (OPS_KEY + bloomier_ops(lx.mode, True)) * fn, fn),
        "exact_probe": (
            lambda: (exact_probe(fwords, fhi, flo, **eargs, plane=eplane),),
            lambda: (exact_probe_ref(fwords, fhi, flo, **eargs),),
            12 * fn + 4 * le.width,
            (OPS_KEY + bloomier_ops(le.mode, le.strategy == "a")) * fn, fn),
        "chained_probe": (
            lambda: chained_probe(fwords, fhi, flo, **cargs, planes=cplanes),
            lambda: chained_probe_ref(fwords, fhi, flo, **cargs),
            16 * fn + 4 * lc.width,
            OPS_KEY * fn + s1_ops
            + bloomier_ops(lc.exact.mode, lc.exact.strategy == "a") * c_pass,
            fn),
        "cascade_probe": (
            lambda: cascade_probe(fwords, fhi, flo, cdesc, layers=layers),
            lambda: cascade_probe_ref(fwords, fhi, flo, layers=layers),
            16 * fn + 4 * ls.width + 16 * len(layers),
            OPS_KEY * fn + OPS_TABLE * c_layers + OPS_BLOOM_PROBE * c_hashes,
            fn),
    })
    # bloom_probe at the filters bank's shape: its Bloom filter under the
    # 4,000,000 queries, the work counted as for grid table 0
    lb = flays[0]
    fbargs = dict(m_bits=lb.m_bits, k=lb.k, seed=lb.seed, offset=lb.offset)
    f_bloom_probes = sum(int(bloom_probe_ref(fwords, fhi, flo,
                                             **dict(fbargs, k=j)).sum())
                         for j in range(lb.k))
    print(f"work: chained stage 1 passes {c_pass / fn:.6f} of {fn} queries; "
          f"cascade layers reached {c_layers / fn:.6f} and Bloom probes "
          f"{c_hashes / fn:.6f} per key over {len(layers)} layers; the "
          f"filters bank's Bloom probes {f_bloom_probes / fn:.6f} per key "
          f"of k = {lb.k}", flush=True)
    # bloom_probe's and cascade_probe's two paths, each timed beside the
    # other, and the layer sets onchip_reason decides by
    def bloom_rule(layer_set, words):
        return lambda m: bloom_onchip.onchip_reason(
            layer_set, m, words.numel(), words.data_ptr())

    def bloomier_why(name):
        return lambda m: bloomier_onchip.onchip_reason(f_geos[name], m)

    # each path as a function of the first m keys
    bloomier_paths = {
        "xor_probe": (
            lambda m: (xor_probe_gather(fwords, fhi[:m], flo[:m], **xargs),),
            lambda m: (xor_probe_onchip(fwords, fhi[:m], flo[:m], **xargs,
                                        plane=xplane),)),
        "exact_probe": (
            lambda m: (exact_probe_gather(fwords, fhi[:m], flo[:m],
                                          **eargs),),
            lambda m: (exact_probe_onchip(fwords, fhi[:m], flo[:m], **eargs,
                                          plane=eplane),)),
        "chained_probe": (
            lambda m: chained_probe_gather(fwords, fhi[:m], flo[:m], **cargs),
            lambda m: chained_probe_onchip(fwords, fhi[:m], flo[:m], **cargs,
                                           planes=cplanes)),
    }
    onchip_runs = {
        "bloom_probe": (
            lambda: (bloom_probe_gather(bstate.tables, hi, lo, **bargs),),
            lambda: (bloom_probe_onchip(bstate.tables, hi, lo, **bargs),),
            bloom_rule(((blay.m_bits, blay.k, blay.seed, blay.offset),),
                       bstate.tables)),
        "cascade_probe": (
            lambda: cascade_probe_gather(fwords, fhi, flo, cdesc,
                                         layers=layers),
            lambda: cascade_probe_onchip(fwords, fhi, flo, cdesc,
                                         layers=layers),
            bloom_rule(layers, fwords)),
        # the on-chip path only where the bank's planes fit one block
        **{k: (functools.partial(g, fn),
               None if f_plans[k] is None else functools.partial(o, fn),
               bloomier_why(k)) for k, (g, o) in bloomier_paths.items()},
    }
    # lsm_probe's gather path, timed beside the window path that the main
    # path takes
    gather_runs = {"lsm_probe": lambda: lsm_probe_gather(
        gen.tables_dev, hi, lo, gen.desc_dev, chains=gen.chains)}
    card_bytes = lsm_window.device_bytes(dev)

    def max_err(got, want) -> int:
        return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(got, want))

    def paths_in_turns(gather, onchip, want) -> tuple[dict, str]:
        """Both paths against the plain outputs ``want``, then timed in
        turns (gather, on-chip, on-chip, gather) on one card."""
        errs = (max_err(gather(), want), max_err(onchip(), want))
        check(errs == (0, 0), f"a path != plain version: {errs}")
        g1, o1 = graph_ms(gather)[0], graph_ms(onchip)[0]
        o2, g2 = graph_ms(onchip)[0], graph_ms(gather)[0]
        return ({"gather_ms": (g1 + g2) / 2, "onchip_ms": (o1 + o2) / 2},
                f"gather path {g1:.4f} / {g2:.4f} ms, on-chip path "
                f"{o1:.4f} / {o2:.4f} ms in turns (gather, on-chip, on-chip, "
                f"gather); device us per call: gather "
                f"{window_kernels_us(gather)}; on-chip "
                f"{window_kernels_us(onchip)}")

    def window_kernels_us(fn, calls: int = 5) -> str:
        """Device us per call of each kernel that ``fn`` launches
        (torch.profiler), or why not measured."""
        from torch.profiler import ProfilerActivity, profile
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / calls)
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0]
        except Exception as exc:          # the profiler is optional here
            return f"not measured ({exc})"
        def short(key: str) -> str:
            key = key.replace("(anonymous namespace)::", "")
            return key.split("(")[0].split("<")[0].split("::")[-1][:40]
        return ", ".join(f"{short(k)} {us:.1f}"
                         for k, us in sorted(rows, key=lambda r: -r[1]))
    sources = {"lsm_probe": ("src/repro_torch/csrc/lsm_window.cu",
                             "src/repro/kernels/lsm_probe.py:270"),
               "lsm_chain_probe": ("src/repro_torch/csrc/lsm_probe.cu",
                                   "src/repro/kernels/lsm_probe.py:328"),
               "bloom_probe": ("src/repro_torch/csrc/bloom_onchip.cu",
                               "src/repro/kernels/bloom_probe.py:32"),
               "xor_probe": ("src/repro_torch/csrc/xor_probe.cu",
                             "src/repro/kernels/xor_probe.py:65"),
               "exact_probe": ("src/repro_torch/csrc/xor_probe.cu",
                               "src/repro/kernels/xor_probe.py:77"),
               "chained_probe": ("src/repro_torch/csrc/chained_probe.cu",
                                 "src/repro/kernels/chained_probe.py:58"),
               "cascade_probe": ("src/repro_torch/csrc/bloom_onchip.cu",
                                 "src/repro/kernels/cascade_probe.py:49")}
    gather_sources = {"bloom_probe": "src/repro_torch/csrc/bloom_probe.cu",
                      "cascade_probe": "src/repro_torch/csrc/cascade_probe.cu",
                      "xor_probe": "src/repro_torch/csrc/xor_probe.cu",
                      "exact_probe": "src/repro_torch/csrc/xor_probe.cu",
                      "chained_probe": "src/repro_torch/csrc/chained_probe.cu"}
    # each path's launches on the driven paths: the bloom grid's bank probe
    # and the filters bank's probe
    path_launches = {k: {p: grid_paths.get(p, 0) * (k == "bloom_probe")
                         + filter_paths[k][p] for p in ("onchip", "gather")}
                     for k in ("bloom_probe", "cascade_probe")
                     + bloomier_kernels}
    # launches on the paths that were driven: the main path's get_batch and
    # bank probe, the bloom grid's bank probe, the filter bank's probe
    launches = {k: main_launches.get(k, 0) + filter_launches.get(k, 0)
                for k in kernels}
    records = []
    for name, (kern, plain, n_bytes, n_ops, n_keys) in runs.items():
        src, replaces = sources[name]
        got, want = kern(), plain()
        err = max_err(got, want)
        check(err == 0, f"{name}: kernel != plain version at the main shapes")
        extra, note = {}, ""
        if name in gather_runs:
            gather = gather_runs[name]
            why = lsm_window.path_reason(gen.chains, n_keys,
                                         gen.tables_dev.data_ptr(), card_bytes)
            check(why is None, f"{name}: the main shapes left the window "
                  f"path ({why})")
            g_err = max_err(gather(), want)
            check(g_err == 0, f"{name}: gather path != plain version")
            # in turns on one card: gather, window, window, gather
            g1, g_per1 = graph_ms(gather)
            w1, per1 = graph_ms(kern)
            w2, per2 = graph_ms(kern)
            g2, g_per2 = graph_ms(gather)
            ms, per = (w1 + w2) / 2, per1 + per2
            # the scratch as the allocator counts it: the call's peak over
            # what was held before it, less its outputs
            del got
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = kern()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            scratch = peak - held - sum(t.numel() * t.element_size()
                                        for t in out)
            del out
            counted = lsm_window.scratch_bytes(gen.chains, n_keys)
            check(counted <= scratch < 1.01 * counted,
                  f"{name}: scratch {scratch} B, lsm_window.scratch_bytes "
                  f"counts {counted} B")
            part_ms, _ = graph_ms(lambda: lsm_window.partition(
                hi, lo, gen.desc_dev, chains=gen.chains))
            breakdown = window_kernels_us(kern)
            extra = {"gather_ms": (g1 + g2) / 2, "gather_max_abs_err": g_err,
                     "partition_ms": part_ms, "scratch_bytes": scratch,
                     "peak_bytes": peak}
            note = (f" | gather path {g1:.4f} / {g2:.4f} ms, window path "
                    f"{w1:.4f} / {w2:.4f} ms in turns (gather, window, "
                    f"window, gather), gather max_abs_err {g_err} | window "
                    f"scratch {scratch} B measured ({counted} B counted by "
                    f"lsm_window.scratch_bytes), peak device memory {peak} B "
                    f"over {held} B held before the call "
                    f"({(peak - held) / 1e6:.1f} MB for the call, outputs "
                    f"included; the card has {card_bytes} B) | "
                    f"window path: partition alone {part_ms:.4f} ms; per "
                    f"kernel, device us per call: {breakdown}")
        elif name in onchip_runs:
            gather, onchip, why_at = onchip_runs[name]
            why = why_at(n_keys)
            if onchip is not None:
                extra, note = paths_in_turns(gather, onchip, want)
            else:
                check(max_err(gather(), want) == 0,
                      f"{name}: gather path != plain version")
                extra = {"gather_ms": graph_ms(gather)[0], "onchip_ms": None}
                note = f"no on-chip path here: {why}"
            ms, per = graph_ms(kern)
            extra.update({"gather_source": gather_sources[name],
                          "path": "onchip" if why is None else "gather",
                          **{f"{p}_launches": c
                             for p, c in path_launches[name].items()}})
            if name in bloomier_kernels:
                fp = f_plans[name]
                planes = {"xor_probe": (xplane,), "exact_probe": (eplane,),
                          "chained_probe": cplanes}[name]
                extra["plane_bytes"] = sum(4 * p.words.numel()
                                           for p in planes)
                if why is None:
                    src = "src/repro_torch/csrc/bloomier_onchip.cu"
                note = (f"planes {extra['plane_bytes']} B ("
                        f"{'one block holds them' if fp else 'over one block'}"
                        f") | {note}")
            note = (f" | the wrapper takes the "
                    f"{'on-chip path' if why is None else f'gather path ({why})'}"
                    f" | {note}")
            if name == "bloom_probe":
                # the grid's bank probe: 200,000 keys over table 0
                ghi, glo = common.key_lanes(exist_b, dev)
                g_extra, g_note = paths_in_turns(
                    lambda: (bloom_probe_gather(bstate.tables, ghi, glo,
                                                **bargs),),
                    lambda: (bloom_probe_onchip(bstate.tables, ghi, glo,
                                                **bargs),),
                    (bloom_probe_ref(bstate.tables, ghi, glo, **bargs),))
                extra.update({"grid_keys": len(exist_b),
                              "grid_gather_ms": g_extra["gather_ms"],
                              "grid_onchip_ms": g_extra["onchip_ms"]})
                note += f" | at the grid's {len(exist_b)} keys: {g_note}"
                # the filters bank's shape, the other that launches it
                fwant = (bloom_probe_ref(fwords, fhi, flo, **fbargs),)
                f_extra, f_note = paths_in_turns(
                    lambda: (bloom_probe_gather(fwords, fhi, flo, **fbargs),),
                    lambda: (bloom_probe_onchip(fwords, fhi, flo, **fbargs),),
                    fwant)
                f_run = lambda: bloom_probe(fwords, fhi, flo, **fbargs)
                check(max_err((f_run(),), fwant) == 0,
                      "bloom_probe != plain version at the filters shape")
                f_ms = graph_ms(f_run)[0]
                f_plain, _ = cuda_ms(lambda: bloom_probe_ref(
                    fwords, fhi, flo, **fbargs), windows=1)
                f_bound, f_by = bound(
                    12 * fn + 4 * ((lb.m_bits + 31) // 32),
                    OPS_KEY * fn + OPS_BLOOM_PROBE * f_bloom_probes,
                    int32_per_s)
                extra.update({"filters_keys": fn, "filters_ms": f_ms,
                              "filters_gather_ms": f_extra["gather_ms"],
                              "filters_onchip_ms": f_extra["onchip_ms"],
                              "filters_plain_ms": f_plain,
                              "filters_bound_ms": f_bound,
                              "filters_bound_by": f_by,
                              "filters_launches": filter_launches[name]})
                note += (f" | at the filters bank's shape ({fn} queries, "
                         f"{lb.m_bits} bits, k = {lb.k}): {f_ms:.4f} ms, "
                         f"{filter_launches[name]} launch per probe, bound "
                         f"{f_bound:.4f} ms ({f_by}), plain {f_plain:.3f} ms; "
                         f"{f_note}")
        else:
            ms, per = graph_ms(kern)
        eager_ms, _ = cuda_ms(kern)
        plain_ms, _ = cuda_ms(plain, windows=1)
        bound_ms, bound_by = bound(n_bytes, n_ops, int32_per_s)
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, **extra})
        print(f"time {name}: {ms:.4f} ms kernel on the device (graph "
              f"replay, median of windows "
              f"{', '.join(f'{t:.4f}' for t in per)}), {eager_ms:.4f} ms "
              f"per eager call (host launch path included), {plain_ms:.3f} "
              f"ms plain, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} G int ops) at "
              f"{n_keys} keys{note} | {card}", flush=True)
    gathers = 3 * gen.n_tables * n + 2 * sum(passes)
    gather_gb = 32 * gathers / 1e9
    print(f"time lsm_probe gather path sectors: {gather_gb:.2f} GB (32 B x "
          f"{gathers / n:.3f} gathers per key: 3 per table, 2 per stage-1 "
          f"pass) = {gather_gb / (records[0]['gather_ms'] / 1e3):.0f} GB/s "
          f"achieved | window path: {64 * sum(passes) / 1e9:.3f} GB of "
          f"stage-2 sectors (2 per stage-1 pass), "
          f"{24 * n * gen.n_tables / 1e9:.3f} GB of scratch written and "
          f"read (12 B per key-table), window copies of at least "
          f"{sum(12 * c[1][2] * (c[1][3] - 2) for c in gen.chains) / 1e9:.3f}"
          f" GB (one per bucket)", flush=True)

    # where the window path starts to pay: both paths of lsm_probe over the
    # bank's first T tables and the first m of 2,097,152 keys (the existing
    # keys, then the missing ones), in turns (gather, window)
    hi2, lo2 = common.key_lanes(np.concatenate([exist, miss]), dev)

    def both_paths(m: int, t: int) -> tuple[float, float]:
        args = (gen.tables_dev, hi2[:m], lo2[:m], gen.desc_dev[:t])
        return (graph_ms(lambda: lsm_probe_gather(
                    *args, chains=gen.chains[:t]))[0],
                graph_ms(lambda: lsm_probe_window(
                    *args, chains=gen.chains[:t]))[0])

    for label, points in (
            ("over the first T tables at 1048576 keys",
             [(t, both_paths(n, t)) for t in (1, 2, 4, 8, 12, 14, 16)]),
            ("over the first T tables at 2097152 keys",
             [(t, both_paths(2 * n, t)) for t in (4, 8, 12, 16)]),
            (f"over {gen.n_tables} tables at m keys",
             [(m, both_paths(m, gen.n_tables)) for m in
              (n // 4, n // 2, 3 * n // 4, n, 3 * n // 2, 2 * n)])):
        pays = [x for x, _ in points
                if all(w < g for u, (g, w) in points if u >= x)]
        print(f"time lsm_probe crossover {label}, device ms (gather, "
              f"window): " + ", ".join(f"{x} {g:.4f} {w:.4f}"
                                       for x, (g, w) in points)
              + f" | the window path is faster from "
              f"{min(pays) if pays else 'none'} on; the rule: MIN_TABLES "
              f"{lsm_window.MIN_TABLES}, MIN_KEYS {lsm_window.MIN_KEYS} | "
              f"{card}", flush=True)

    # where the on-chip path pays: both paths over the first m of the
    # 4,000,000 queries, in turns (gather, on-chip), for grid table 0's
    # bitmap (staged), the filters bank's Bloom and its cascade (in L2)
    sizes = (1 << 10, 1 << 13, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19,
             1 << 20, 1 << 21, fn)
    inner = layers[2:]      # the cascade's layers 3.. : a span that is staged
    inner_desc = cdesc[2:].contiguous()
    for label, mk, layer_set, words in (
            (f"bloom_probe over grid table 0 ({4 * ((blay.m_bits + 31) // 32)}"
             f" B, k = {blay.k})",
             lambda p, m: (lambda: p(bstate.tables, fhi[:m], flo[:m],
                                     **bargs)),
             ((blay.m_bits, blay.k, blay.seed, blay.offset),), bstate.tables),
            (f"bloom_probe over the filters bank's Bloom "
             f"({4 * ((lb.m_bits + 31) // 32)} B, k = {lb.k})",
             lambda p, m: (lambda: p(fwords, fhi[:m], flo[:m], **fbargs)),
             ((lb.m_bits, lb.k, lb.seed, lb.offset),), fwords),
            (f"cascade_probe over the filters bank's {len(layers)} layers",
             lambda p, m: (lambda: p(fwords, fhi[:m], flo[:m], cdesc,
                                     layers=layers)),
             layers, fwords),
            (f"cascade_probe over its layers 3-{len(layers)} "
             f"({4 * (bloom_onchip.span(inner)[1] - bloom_onchip.span(inner)[0])}"
             f" B)",
             lambda p, m: (lambda: p(fwords, fhi[:m], flo[:m], inner_desc,
                                     layers=inner)),
             inner, fwords)):
        gather_fn, onchip_fn = ((bloom_probe_gather, bloom_probe_onchip)
                                if "bloom" in label else
                                (cascade_probe_gather, cascade_probe_onchip))
        points = [(m, graph_ms(mk(gather_fn, m))[0],
                   graph_ms(mk(onchip_fn, m))[0]) for m in sizes]
        faster = [m for m, g, o in points if o < g]
        rule = [m for m, _, _ in points if bloom_onchip.onchip_reason(
            layer_set, m, words.numel(), words.data_ptr()) is None]
        print(f"time on-chip crossover, {label}, device ms (gather, on-chip) "
              f"over m keys: " + ", ".join(f"{m} {g:.4f} {o:.4f}"
                                           for m, g, o in points)
              + f" | the on-chip path is faster at {faster}; the rule "
              f"(bloom_onchip.onchip_reason) takes it at {rule} | {card}",
              flush=True)

    # what bounds a Bloom probe at large batches: the on-chip kernel over a
    # synthetic bitmap of grid table 0's size at 2^20 keys: k = 1 (one probe
    # a key), k = 8 with every bit set (8 probes a key, no lane waits on
    # another) and k = 8 half set (a key stops at its first zero bit; its
    # warp runs until its slowest lane stops)
    n_diag, words_d = min(1 << 20, fn), (blay.m_bits + 31) // 32
    diag, needed = {}, 0.0
    for label, k_d, full in (("k=1", 1, False), ("k=8 full", 8, True),
                             ("k=8 half full", 8, False)):
        tables_d, (off_d,) = selfcheck.bitmap_bank((words_d,), seed=5, ors=1)
        if full:
            tables_d[:] = 0xFFFFFFFF
        bank_d = common.to_device(tables_d, dev)
        args_d = dict(m_bits=32 * words_d, k=k_d, seed=2**31 + 77,
                      offset=off_d)
        diag[label] = graph_ms(lambda: bloom_probe_onchip(
            bank_d, fhi[:n_diag], flo[:n_diag], **args_d))[0]
        if label == "k=8 half full":      # probes these keys need
            needed = sum(int(bloom_probe_ref(
                bank_d, fhi[:n_diag], flo[:n_diag],
                **dict(args_d, k=j)).sum()) for j in range(k_d)) / n_diag
    per_probe = (diag["k=8 full"] - diag["k=1"]) / 7
    run = 1 + (diag["k=8 half full"] - diag["k=1"]) / per_probe
    print(f"time what bounds bloom_probe at {n_diag} keys (on-chip path, "
          f"{4 * words_d} B bitmap), device ms: " + ", ".join(
              f"{k} {v:.4f}" for k, v in diag.items())
          + f" | {per_probe * 1e3:.2f} us per probe of all keys; half full "
          f"costs {run:.2f} probes a key where the keys need {needed:.3f} "
          f"({run / needed:.2f}x) | {card}", flush=True)

    # what bounds the Bloomier gather kernels: xor_probe's gather kernel
    # (alpha 8, fuse) over synthetic tables from 96 B (every gather hits one
    # line: the hash-and-issue floor) to 67 MB (past the L2), at the
    # filters cell's 4,000,000 queries, 3 gathers a key
    foot = []
    for seg_len, n_seg in ((8, 3), (512, 12), (1024, 53), (1024, 140),
                           (2048, 140), (8192, 140), (16384, 221),
                           (16384, 1024)):
        bank_s, a_s = selfcheck.synthetic_bloomier(
            "xor_probe", ((seg_len, n_seg, 8),))
        words_s = common.to_device(bank_s, dev)
        foot.append((4 * seg_len * n_seg, graph_ms(lambda: xor_probe_gather(
            words_s, fhi, flo, **a_s))[0]))
        del words_s
    print(f"time gather rate against the table's footprint (xor_probe's "
          f"gather kernel, alpha 8, {fn} keys), bytes, device ms, G "
          f"gathers/s: " + ", ".join(f"{b} {ms:.4f} {3 * fn / ms / 1e6:.1f}"
                                     for b, ms in foot) + f" | {card}",
          flush=True)
    # chained_probe's gather kernel (the path the filters bank takes) over
    # three pass mixes: every key passes stage 1 (positives), ~1/2^alpha
    # do (unseen keys), the cell's mix: what stage 2 and its early exit
    # cost
    mixes = {"positives": np.random.default_rng(1).choice(pos, fn),
             "unseen": fkeys[F_POS * (F_LAMBDA + 1):],
             "cell mix": queries}
    for label, q in mixes.items():
        qh, ql = common.key_lanes(q, dev)
        c_g = lambda: chained_probe_gather(fwords, qh, ql, **cargs)
        want = chained_probe_ref(fwords, qh, ql, **cargs)
        check(max_err(c_g(), want) == 0,
              f"chained_probe ({label}): gather path != plain version")
        q_pass = int((want[1] == 2).sum())
        c_ms = graph_ms(c_g)[0]
        print(f"time chained_probe gather kernel over {label}: stage-1 "
              f"passes {q_pass / fn:.4f}, {c_ms:.4f} ms, "
              f"{(3 * fn + 3 * q_pass) / c_ms / 1e6:.1f} G gathers/s | {card}",
              flush=True)
    # the gather rate each gather row achieves at its main shapes
    rec = {r["name"]: r for r in records}
    achieved = {
        "xor_probe": 3 * fn / rec["xor_probe"]["gather_ms"],
        "exact_probe": 3 * fn / rec["exact_probe"]["gather_ms"],
        "chained_probe": (3 * fn + 3 * c_pass)
        / rec["chained_probe"]["gather_ms"],
        "lsm_chain_probe": (3 * n + 2 * passes[0])
        / rec["lsm_chain_probe"]["ms"],
        "lsm_probe gather path": gathers / rec["lsm_probe"]["gather_ms"]}
    print("time gather rows, achieved G gathers/s (3 a Bloomier match, 2 an "
          "Othello stage 2): " + ", ".join(f"{k} {v / 1e6:.1f}"
                                          for k, v in achieved.items())
          + f" | {card}", flush=True)
    # what a published bank's planes cost to pack (FilterService.prepare
    # and refresh_tables; kernels/ops.py's one-shot queries pack per call)
    pack_ms = {name: graph_ms(lambda: layout_planes((lay_k,), fwords))[0]
               for name, lay_k in (("xor_probe", flx), ("exact_probe", fle),
                                   ("chained_probe", flc))}
    print("time pack_plane at the filters cell, device ms per bank: "
          + ", ".join(f"{k} {v:.4f}" for k, v in pack_ms.items())
          + f" | {card}", flush=True)
    # where the Bloomier on-chip path pays: both paths over the first m of
    # the 4,000,000 queries, in turns (gather, on-chip): the filters cell's
    # exact table, and an Xor plane and two chained planes that fit one
    # block (the cell's own Xor and ChainedFilterAnd planes do not)
    sweeps = [("exact_probe at the filters cell", *bloomier_paths[
        "exact_probe"], f_geos["exact_probe"])]
    for kernel, label, tables_s in (
            ("xor_probe", "xor_probe, alpha 8, 1024 x 226 slots (231424 B "
             "plane)", ((1024, 226, 8),)),
            ("chained_probe", "chained_probe, alpha 3, 2048 x 100 and 8192 x "
             "100 slots (204800 B of planes)",
             ((2048, 100, 3), (8192, 100, 1)))):
        bank_s, a_s = selfcheck.synthetic_bloomier(kernel, tables_s)
        words_s = common.to_device(bank_s, dev)
        geos_s = selfcheck.bloomier_geometries(kernel, tables_s)
        # the planes packed once, as FilterService holds them
        lays_s = ((a_s["l1"], a_s["alpha"]), (a_s["l2"], 1)) \
            if kernel == "chained_probe" else (
                (tuple(a_s[k] for k in ("mode", "seed", "seg_len", "n_seg",
                                        "offset")), a_s["alpha"]),)
        planes_s = tuple(bloomier_onchip.pack_plane(words_s, lay_s, al)
                         for lay_s, al in lays_s)
        g_s = selfcheck.bloomier_calls(kernel, a_s, words_s, "gather")[0]
        o_s = selfcheck.bloomier_calls(
            kernel, dict(a_s, **({"planes": planes_s}
                                 if kernel == "chained_probe"
                                 else {"plane": planes_s[0]})),
            words_s, "onchip")[0]
        sweeps.append((label,
                       functools.partial(lambda g, m: g(fhi[:m], flo[:m]), g_s),
                       functools.partial(lambda o, m: o(fhi[:m], flo[:m]), o_s),
                       geos_s))
    for label, g_at, o_at, geos_s in sweeps:
        points = [(m, graph_ms(functools.partial(g_at, m))[0],
                   graph_ms(functools.partial(o_at, m))[0]) for m in sizes]
        faster = [m for m, g, o in points if o < g]
        rule = [m for m, _, _ in points
                if bloomier_onchip.onchip_reason(geos_s, m) is None]
        print(f"time on-chip crossover, {label}, device ms (gather, on-chip) "
              f"over m keys: " + ", ".join(f"{m} {g:.4f} {o:.4f}"
                                           for m, g, o in points)
              + f" | the on-chip path is faster at {faster}; the rule "
              f"(bloomier_onchip.onchip_reason) takes it at {rule} | {card}",
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
          f"device busy {100 * kern_ms / get_ms:.1f}% | {card}", flush=True)
    # the LSM bank's FilterService.probe: one lsm_chain_probe per table
    lsm_bank_ms = host_ms(lambda: store.service.probe(exist))
    chain_ms = n_fl * records[1]["ms"]
    print(f"time LSM bank FilterService.probe: {nq / (lsm_bank_ms / 1e3):.0f} "
          f"keys/s ({lsm_bank_ms:.1f} ms per {nq}-key probe over {n_fl} "
          f"filters, host clock) | {n_fl} lsm_chain_probe launches, "
          f"{chain_ms:.3f} ms on the device, device busy "
          f"{100 * chain_ms / lsm_bank_ms:.1f}% | {card}", flush=True)

    # where a FilterService.probe goes: key split + upload, the five
    # launches on device lanes (outputs left on the card), the whole call
    # (+ the download of member and probes, and the stats)
    bank_ms = next(r["filters_ms"] for r in records
                   if r["name"] == "bloom_probe") + sum(
        r["ms"] for r in records
        if r["name"] in bank_kernels and r["name"] != "bloom_probe")
    f_lanes_ms = host_ms(lambda: common.key_lanes(queries, dev))
    f_launch_ms = host_ms(lambda: bank_probe(fwords, fhi, flo, layouts=flays,
                                             descs=fstate.descs))
    f_probe_ms = host_ms(lambda: svc.probe(queries, state=fstate))
    print(f"time FilterService.probe: {fn / (f_probe_ms / 1e3):.0f} "
          f"queries/s ({f_probe_ms:.1f} ms per {fn}-query batch over 5 "
          f"filters, host clock) | split+upload {f_lanes_ms:.1f} ms, five "
          f"launches {f_launch_ms:.1f} ms (kernels {bank_ms:.3f} ms on the "
          f"device), download+stats "
          f"{f_probe_ms - f_lanes_ms - f_launch_ms:.1f} ms, device busy "
          f"{100 * bank_ms / f_probe_ms:.1f}% | {card} | total "
          f"{time.monotonic() - t_start:.0f} s", flush=True)

    # -- 9. query: the query layer and the prefix cache --------------------
    def device_profile(fn):
        """(device ms, device operations: kernels and copies) of one call
        of ``fn`` (torch.profiler), or why not measured."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            rows = [(e.self_device_time_total, e.count)
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0]
        except Exception as exc:          # the profiler is optional here
            return f"not measured ({exc})"
        return sum(us for us, _ in rows) / 1e3, sum(c for _, c in rows)

    def busy(prof, call_ms: float) -> str:
        """The device's share of a call of ``call_ms`` host ms (timed
        without the profiler)."""
        if isinstance(prof, str):
            return prof
        dev_ms, ops = prof
        return (f"{dev_ms:.3f} ms of device time in {ops} device "
                f"operations (kernels and copies), device busy "
                f"{100 * dev_ms / call_ms:.1f}% of a {call_ms:.1f} ms call")

    def lsm_launches() -> dict:
        return {"lsm_probe": lsm_probe.launches, **path_counts()}

    def bloom_launches() -> dict:
        return {"bloom_probe": bloom_probe.launches,
                **bloom_paths(bloom_probe)}

    q9 = {"lsm_probe": 0, "bloom_probe": 0, "bloom_gather": 0}
    # the query cell at the repo's full scale: the fused plan's Member
    # stage is one lsm_probe launch; the semijoin's are three (the base
    # plan's resolution, the bank prune of orders, its materialization);
    # 4 tables take the gather path. Tag banks are Othello planes that
    # FilterService serves with torch ops (othello_hit), no kernel.
    q = query_cell(*Q_FULL, dev, repeat=5, reset=reset_counts,
                   read=lsm_launches, profile=device_profile)
    check(q["naive_equal"], "query cell: the fused plan != the naive plan")
    check(q["model_match"], "query cell: the fused plan != the dict model")
    check(q["fused_launches"] == {"lsm_probe": 1, "window": 0, "gather": 1},
          f"query cell: the fused plan launched {q['fused_launches']}")
    check(q["semijoin_launches"] == {"lsm_probe": 3, "window": 0,
                                     "gather": 3},
          f"query cell: the semijoin launched {q['semijoin_launches']}")
    q9["lsm_probe"] += 4
    sp = q["split_ms"]
    print(f"query: events {Q_FULL[0]} keys in 4 flushes, host build "
          f"{q['build_s']:.1f} s (chained bank {q['bank_bytes']} B packed, "
          f"{q['filter_bits'] / Q_FULL[0]:.2f} filter bits a key; "
          f"{Q_TAG_BITS} tag planes {q['tag_bank_bytes']} B: a path check, "
          f"not a load test) | {Q_FULL[1]} candidates through "
          f"{[s for s, _ in q['stage_survivors']]}, survivors "
          f"{[n for _, n in q['stage_survivors']]}: fused == naive == dict "
          f"model | counts {json.dumps(q['counts'])} | lsm_probe launches "
          f"by path: fused plan {q['fused_launches']}, semijoin "
          f"{q['semijoin_launches']} | host clock, median of 5: fused "
          f"{q['fused_ms']:.1f} ms, naive {q['naive_ms']:.1f} ms "
          f"({q['naive_ms'] / q['fused_ms']:.2f}x) | one fused run "
          f"{sp['total']:.1f} ms: memtable overlay {sp['overlay']:.2f}, "
          f"tag-bank probes (FilterService.probe) {sp['tag_bank_probe']:.1f}"
          f", get_batch {sp['get_batch']:.1f}, numpy gathers "
          f"{sp['numpy']:.1f} | one more, profiled: "
          f"{busy(q['profile'], q['fused_ms'])} | {card}", flush=True)
    # the same cell at CI scale: BENCH_baseline.json's counts, exactly
    with open(os.path.join(ROOT, "BENCH_baseline.json")) as fh:
        base = json.load(fh)[Q_BASELINE[0]]["metrics"]
    want = {k: base[k] for k in Q_BASELINE[1]}
    qc = query_cell(*Q_CI, dev, repeat=1)
    check(qc["counts"] == want, f"query cell at CI scale: counts "
          f"{qc['counts']}, BENCH_baseline.json {want}")
    check(qc["naive_equal"] and qc["model_match"],
          "query cell at CI scale: fused != naive or the dict model")
    print(f"query CI scale: {Q_CI[0]} keys, {Q_CI[1]} candidates: counts "
          f"{json.dumps(qc['counts'])} == BENCH_baseline.json", flush=True)
    # a Member plan over the main cell's store, wrapped as it stands
    published = store.stats.generations_published
    main_cat = Catalog()
    mcoll = main_cat.create_collection("main", store=store)
    check(store.generation is gen
          and store.stats.generations_published == published,
          "wrapping the main store published a generation")
    plan = Pipeline(mcoll, (Member(),))
    reset_counts()
    res = plan.run(exist)
    m_launch = lsm_launches()
    f_x, v_x, r_x = store.get_batch(exist)
    check(m_launch == {"lsm_probe": 1, "window": 1, "gather": 0},
          f"the main store's Member plan launched {m_launch}")
    check(np.array_equal(res.keys, exist[f_x])
          and np.array_equal(res.vals, v_x[f_x])
          and np.array_equal(res.reads, r_x),
          "the main store's Member plan != get_batch")
    ss = np.sort(stored)
    lo_k, hi_k = int(ss[len(ss) // 2]), int(ss[len(ss) // 2 + 10_000])
    reset_counts()
    sres = Pipeline(mcoll, (RangeFence(lo_k, hi_k), Member())).run()
    s_launch = lsm_launches()
    with store.snapshot() as snap:
        sk, sv = snap.scan(lo_k, hi_k)
    check(np.array_equal(sres.keys, sk) and np.array_equal(sres.vals, sv)
          and len(sk) == 10_000 and bool((sres.reads == 1).all()),
          "the scan-driven plan != the snapshot's scan")
    check(s_launch == {"lsm_probe": 1, "window": 0, "gather": 1},
          f"the scan-driven plan launched {s_launch}")
    q9["lsm_probe"] += 2
    plan_ms = host_ms(lambda: plan.run(exist))
    get2_ms = host_ms(lambda: store.get_batch(exist))
    plan_prof = device_profile(lambda: plan.run(exist))
    main_cat.drop_collection("main")
    print(f"query main store: Member plan over {len(exist)} keys of the "
          f"{n_fl}-table store == get_batch (keys, vals, reads), lsm_probe "
          f"by path {m_launch}; host clock {plan_ms:.1f} ms against "
          f"get_batch {get2_ms:.1f} ms; one plan, profiled: "
          f"{busy(plan_prof, plan_ms)} | "
          f"(RangeFence, Member) over "
          f"{len(sk)} keys == the snapshot's scan, reads 1 each, lsm_probe "
          f"by path {s_launch} | {card}", flush=True)
    # the prefix cache at the engine's default tiers
    pc = prefix_cache_cell(dev, reset=reset_counts, read=bloom_launches)
    pstate = pc["service"].state
    pc_rule = rule_paths([((lay.m_bits, lay.k, lay.seed, lay.offset),)
                          for lay in pstate.bank.layouts],
                         pc["n_lookups"] // 2, pstate.tables)
    check(pc["equal"], "prefix cache: lookup_batch != lookup")
    check(pc["stats_equal"], "prefix cache: stats differ from the twin's")
    check(pc["overflowed"] and pc["versions"] == [0, 1],
          "prefix cache: a tier never filled or refresh_tables not taken")
    check(all(p is None for p in pstate.planes),
          "prefix cache: a Bloom-only bank packed planes")
    check(pc["stats"]["wasted_probes"] <= pc["stats"]["lookups"],
          "prefix cache: more than 1 wasted probe a lookup")
    check(all(l == {"bloom_probe": len(PC_TIERS), **pc_rule}
              for l in pc["launches"]),
          f"prefix cache: bloom_probe launched {pc['launches']}, the rule "
          f"says {pc_rule} a batch")
    q9["bloom_probe"] += sum(l["bloom_probe"] for l in pc["launches"])
    q9["bloom_gather"] += sum(l["gather"] for l in pc["launches"])
    print(f"prefix cache: tiers {[t[1] for t in PC_TIERS]} entries, "
          f"{pc['n_inserts']} inserts (every tier full), {pc['n_lookups']} "
          f"lookups in 2 batches around the second half of the inserts "
          f"(the second through refresh_tables; no planes packed): "
          f"lookup_batch == lookup on every key, stats == the twin's "
          f"{json.dumps(pc['stats'])}, hits {pc['hits']} | bloom_probe "
          f"launches by path per batch {pc['launches']} (rule {pc_rule}) | "
          f"host ms: inserts {pc['insert_ms']:.0f} (both caches), "
          f"lookup_batch {pc['lookup_batch_ms']:.1f} (a path check, not a "
          f"load test) | {card} | total {time.monotonic() - t_start:.0f} s",
          flush=True)
    for r in records:
        r["launches"] += q9.get(r["name"], 0)
        if r["name"] == "bloom_probe":
            r["gather_launches"] += q9["bloom_gather"]

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
