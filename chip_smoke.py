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
             ChainedFilterCascade; built on the host in five processes
             started after phase 2, beside phases 3-6, by
             ``start_filter_builds``) packed into one ~28.5 MB bank, and
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
10. serve    the LM server and the §5.5 learned filter (``serve_cell``,
             ``learned_cell``): a ``ServeEngine`` over llama3.2-1b FULL
             (f32 weights from a seed on the card, bf16 compute, the
             default tiers 8 / 32 / 128, max_len 256) runs 16 requests
             over 4 distinct 64-token prompts twice, then a fresh engine
             one request a prompt: equal outputs per prompt, across runs
             (lossless hits) and to the fresh engine's; ``stats()`` equal
             to a CPU twin engine's over the same stream; 3
             ``bloom_probe`` launches a run, by the path the rule names;
             decode equal to teacher forcing within TF_REL_BF16; host
             times of prefill, decode (bf16 copy and f32 weights), the
             payload's host copy and upload, the device profile of one
             step, peak memory and the decode bound; the model cut to 2
             layers at f32 (TF32 off), the card against the CPU from the
             same numpy weights within CARD_CPU_REL; the learned filter
             at n = 30,000 (``benchmarks/learned_filter.py``'s four train
             fractions, three backups) held to the JAX package's figures,
             then a 1,000,000-key build with the chained and bloom
             backups (training and query times, bits, fpr, 0 false
             negatives)
11. train    the training path (``train_run``, ``train_step_parts``,
             ``supervised_run``): ``launch/train.build_trainer`` over
             llama3.2-1b FULL (bf16 compute, f32 master weights and AdamW
             state, remat) at seq 4,096, batch 2, 8 calls of its
             ``step_fn``: the loss finite and falling, host ms a step,
             tokens/s, peak memory, the device profile of one step beside
             its FLOP and AdamW-byte bounds; the widths cut to 2 layers at
             f32 (TF32 off), one train step on the card against the CPU
             from the same numpy params and AdamW state (loss, every
             gradient leaf, every param after AdamW); ``ft.Supervisor``
             over the smoke trainer on the card, 12 steps, a checkpoint
             every 4, a failure injected at step 6: the resumed losses
             equal an uninterrupted run's bit for bit (torch's
             deterministic algorithms on), the checkpoint's Bloom filter
             skips stats, the pipeline drops what a fresh host pipeline
             drops; no kernel launched
12. moe      MoE and MLA: a ``ServeEngine`` over deepseek-v2-lite-16b FULL
             (27 layers, 64 routed experts top-6 + 2 shared, MLA over a
             512 + 64 latent cache; bf16 weights drawn leaf by leaf on the
             card, the leaf count and the engine's aliasing checked) runs
             phase 10's ``serve_cell`` and ``serve_faults`` (a CPU twin's
             stats, bloom_probe by the route rule); the 64-token
             prefill's routing (experts used, pairs dropped past
             capacity); decode against teacher forcing over 16 prompt
             tokens (no prefill over 31 tokens, so no drop) within
             TF_REL_BF16 on the steps routed alike (a near-tie flip
             counted, not held), and at f32 (TF32 off, 62.8 GB of f32
             weights) within TF_REL_F32 on every step, none routed
             otherwise; host ms of prefill and decode, one
             decode step profiled, the MLA cache bytes, peak memory and
             two decode bounds (every expert's weights, the active
             ones); FULL widths cut to 2 layers at f32 (TF32 off), card
             against CPU: prefill and a decode step within CARD_CPU_REL,
             the MoE layer's routing equal, the loss and its gradients
             at seq 64; then
             deepseek-7b, qwen3-14b, deepseek-67b, llama4-scout-17b-a16e
             and internvl2-26b (256 seeded patch embeddings) at FULL
             widths cut to 2 layers, bf16: a 64-token prefill, 8 decode
             steps against teacher forcing, host ms, peak memory
13. ssm      the SSM hybrid, RWKV6 and the encoder-decoder: zamba2-2.7b
             (54 Mamba2 layers, a shared attention block after every 6th
             with a 4,096-token ring), rwkv6-7b (32 layers) and
             whisper-tiny (4 + 4 layers, 1,500 seeded frame embeddings)
             at FULL width and depth, bf16 weights drawn leaf by leaf
             (the zero- and one-initialised leaves as a trained model
             holds them: ``draw_state_leaves``):
             phase 10's ``serve_cell`` and ``serve_faults`` (8 requests
             each over the same 4 prompts; a
             CPU twin's stats, bloom_probe by the route rule), decode
             against teacher forcing over 16 prompt tokens (every teacher
             prefill one chunk) at bf16 within TF_REL_BF16 (RWKV6 its
             own, SSM_TF_REL_BF16), each cache leaf's lost-state control
             above that bound, and at f32 (TF32 off) within TF_REL_F32; host ms of prefill and decode, one decode step
             profiled, the prefix-cache payload's bytes, peak memory, the
             decode bound; the card against the CPU at f32 (zamba2 cut to
             6 layers, rwkv6 to 2, whisper whole): prefill and a decode
             step within CARD_CPU_REL, the loss and its gradients at seq
             64 (whisper's gradients within SSM_GRAD_REL)
14. mesh     the row split over a ``DeviceMesh`` and the dry-run census: a
             1-rank NCCL group (``launch.mesh.start_group``, a FileStore,
             a timeout), ``FilterService(mesh=make_mesh((1,), ('data',)))``
             over phase 7's five filters as built: member, probes and
             stats equal to phase 7's one-device service on all 4,000,000
             queries, one launch of each bank kernel by the path the rule
             names at a rank's padded share, host ms of ``probe`` (median
             of 5 after a warm call) in turns with a one-device service,
             the all-gather's device time (``torch.profiler``, and the
             gather alone at the probe's shape by CUDA events); then
             ``launch.dryrun.run_cell`` for every (arch, shape) of
             ``applicable_shapes`` at 16x16, 2x16x16 and the card's own
             (1, 1) ``DeviceMesh``, on meta tensors (no device memory):
             per-device argument GB and whether they fit the card, and
             the (1, 1) llama3.2-1b ``train_4k`` params and AdamW bytes
             equal to what phase 11 allocated
15. sharded  the LM steps run sharded over the card's (1, 1)
             ``DeviceMesh`` (``build_cell(mesh=)``, ``make_*_step(mesh=)``),
             in phase 14's process group: llama3.2-1b FULL, a train step
             at seq 4,096 x batch 2 from the trainer's fresh state (bf16
             compute over f32 master weights, deterministic algorithms),
             a 64-token prefill into a 256-token cache and 16 decode
             steps; deepseek-v2-lite-16b at FULL widths cut to 2 layers,
             a train step at batch 2 x seq 64, a 16-token prefill and 8
             decode steps: the loss, every param and AdamW leaf, the
             logits and the cache equal to the one-device steps' bit for
             bit; the placed bytes == ``Cell.arg_local_bytes`` == the
             census's (1, 1) row; host ms of a train step and a decode
             token on the mesh and on one device in turns; one decode
             step's device operations on each; no kernel launched
16. trace    the step trace (``launch/op_trace.py``) beside the card's
             real step, on the host in a subprocess started after phase
             2 and run beside phases 3-15 (``start_traces``; a fake
             process group cannot share phase 14's process): llama3.2-1b
             FULL at
             phase 11's train shape (2 x 4,096) and phase 10's decode (a
             256-token cache) on (1, 1), and train_4k and decode_32k at
             16x16 (two cells the grouped-query repair opened); the
             traced (1, 1) params and AdamW bytes equal to phase 11's
             allocation, the modelled peak (args + liveness) beside
             phase 11's measured peak and their ratio; no kernel launched
17. remat    each layer recomputed in the loss's backward
             (``torch.utils.checkpoint``, the reference's remat of its
             scanned FULL cells): zamba2-2.7b FULL (54 Mamba2 layers, the
             shared block after every 6th) through
             ``launch/train.build_trainer``, which builds it with remat,
             3 steps at phase 11's shape (2 x 4,096, bf16 compute over
             f32 master weights, AdamW): every loss finite, the loss of
             step 0's batch after the third step below step 0's, host ms
             a step, peak memory; beside them the step trace of the same
             step on (1, 1) with remat and without
             (``remat_traces``, on the host in a subprocess started after
             phase 2 beside phase 16's, within REMAT_TRACE_LIMIT_S; the
             step without remat is not run on the card): the traced
             params and AdamW bytes equal to the trainer's allocation,
             the modelled peak beside the measured one and their ratio;
             then rwkv6-7b at FULL widths cut to 2 layers (the depth at
             which its step without remat fits the card): a train step's
             loss and gradients at 2 x 4,096 with remat, without, and with
             it again, under deterministic algorithms, equal bit for bit,
             each remat step's peak below the plain one's
             (``remat_pair``); no kernel launched

Then one JSON line of kernel records, the card line and the result line.
Launch counts are set to 0 just before each path is driven and read just
after; launches made to compare a kernel with its plain version or to
time it are not counted.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from dataclasses import asdict, replace

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


# -- phase 10: the LM server (llama3.2-1b) and the §5.5 learned filter ------
LM_ARCH = "llama3.2-1b"
# 16 requests over 4 distinct 64-token prompts, 16 new tokens each
LM_PROMPTS, LM_PROMPT_LEN, LM_REQUESTS, LM_MAX_NEW, LM_MAX_LEN = \
    4, 64, 16, 16, 256
# decode against teacher forcing at bf16: ||decode - prefill|| / ||prefill||
# of each step's logits. bf16 keeps 8 significant bits (2^-9 relative
# rounding); a decode step and a prefill round the same values after
# different accumulation orders, ~10 roundings a layer over 16 layers
# compound to ~0.025, and 0.05 is twice that
TF_REL_BF16 = 0.05
# the card against the CPU at f32, TF32 off: max |card - cpu| / max |cpu|
CARD_CPU_REL = 1e-3
# the JAX package's §5.5 figures (benchmarks/learned_filter.py's recipe:
# synth_url_dataset(n/2, n/2, seed=5), model_fpr 0.01, seed 11), backup
# bits of (bloom, chained) at (n, train_frac); on the CPU, 0 false
# negatives and a chained fpr of 0.0100-0.0101 in every row
LEARNED_REF = {(3000, 0.1): (13487, 4096), (3000, 1.0): (5338, 3328),
               (30000, 0.1): (128044, 34816), (30000, 0.3): (125364, 34816),
               (30000, 0.5): (126213, 34816), (30000, 1.0): (118527, 33792)}
# the port's model is trained from other initial weights (a torch
# generator, not jax.random), so its threshold and below-threshold sets
# differ; the chained backup is exact, so its fpr is the model's target
# (0.01) plus the quantile's rounding, and its bits follow the positives
# below the threshold, here within 15% of the reference's
LEARNED_FPR_MAX, LEARNED_BITS_REL = 0.012, 0.15
LEARNED_KINDS = ("bloom", "bloomier", "chained")


def lm_requests(vocab: int, n_requests: int, *, max_new: int = LM_MAX_NEW,
                n_prompts: int = LM_PROMPTS, prompt_len: int = LM_PROMPT_LEN,
                seed: int = 3):
    """(prompts, requests): ``n_prompts`` seeded prompts of ``prompt_len``
    tokens below ``vocab``, request i asking prompt i mod ``n_prompts``."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, (n_prompts, prompt_len)).astype(np.int32)
    return prompts, [Request(rid=i, prompt=prompts[i % n_prompts].copy(),
                             max_new=max_new) for i in range(n_requests)]


def serve_cell(model, params, device, *, n_requests: int = LM_REQUESTS,
               max_len: int = LM_MAX_LEN, reset=lambda: None, read=dict,
               extra=None, **req_kw) -> dict:
    """One ``ServeEngine`` on ``device`` runs the same request stream twice
    (the second run all prefix-cache hits); a fresh engine then runs one
    request per prompt. ``extra`` joins every prefill's batch (whisper's
    frame embeddings). ``reset()`` / ``read()`` around each run; each
    run's outputs, cumulative ``stats()``, launches and host seconds."""
    from repro_torch.serving import ServeEngine
    vocab = model.cfg.vocab
    eng = ServeEngine(model, params, max_len=max_len, device=device)
    runs = []
    for _ in range(2):
        prompts, reqs = lm_requests(vocab, n_requests, **req_kw)
        reset()
        t = time.perf_counter()
        eng.run(reqs, extra_inputs=extra)
        runs.append({"s": time.perf_counter() - t, "launches": read(),
                     "outputs": [r.output for r in reqs],
                     "stats": eng.stats(),
                     "tokens": sum(len(r.output) for r in reqs)})
    fresh = ServeEngine(model, params, max_len=max_len, device=device)
    _, reqs = lm_requests(vocab, len(prompts), **req_kw)
    reset()
    fresh.run(reqs, extra_inputs=extra)
    return {"runs": runs, "fresh": [r.output for r in reqs],
            "fresh_launches": read(), "prompts": prompts, "engine": eng}


def serve_faults(cell: dict, twin: dict | None = None) -> list[str]:
    """What ``serve_cell``'s result gets wrong: outputs that differ for
    one prompt, across the two runs (a cache hit must be lossless) or from
    a fresh engine; the prefix cache's accounting (0.75 of the prefill
    tokens saved after run 1, 0.875 after run 2 for 16 requests over 4
    prompts; at most one wasted probe a lookup); stats other than the
    twin's (another engine given the same stream)."""
    (r1, r2), n = cell["runs"], len(cell["fresh"])
    n_req = len(r1["outputs"])
    faults = []
    if any(o != r1["outputs"][i % n] for i, o in enumerate(r1["outputs"])):
        faults.append("requests with one prompt gave different outputs")
    if r2["outputs"] != r1["outputs"]:
        faults.append("the second run (prefix-cache hits) != the first")
    if cell["fresh"] != r1["outputs"][:n]:
        faults.append("a fresh engine's outputs != the first run's")
    saved = [r["stats"]["prefill_tokens_saved_frac"] for r in (r1, r2)]
    if saved != [(n_req - n) / n_req, (2 * n_req - n) / (2 * n_req)]:
        faults.append(f"prefill tokens saved {saved}")
    if any(r["stats"]["wasted_probes"] > r["stats"]["lookups"]
           for r in (r1, r2)):
        faults.append("more than one wasted probe a lookup")
    if twin is not None and [r["stats"] for r in twin["runs"]] != \
            [r["stats"] for r in (r1, r2)]:
        faults.append("stats() != the twin's")
    return faults


@contextlib.contextmanager
def recorded_routes():
    """The routing of every MoE layer's forward pass made inside, in call
    order: numpy [T, k] expert ids, -1 where the pair was dropped past the
    expert's capacity. The model looks ``moe_slots`` up in its module at
    each call, so the recorder wraps it there for the duration."""
    from repro_torch.models import common as MC
    routed, slots = [], MC.moe_slots

    def record(gidx, *args):
        pos, keep = slots(gidx, *args)
        routed.append(np.where(keep.cpu().numpy(), gidx.cpu().numpy(), -1))
        return pos, keep
    MC.moe_slots = record
    try:
        yield routed
    finally:
        MC.moe_slots = slots


def teacher_forcing(model, params, prompt, n_steps: int, max_len: int,
                    device, extra=None) -> tuple[list, list, list]:
    """Greedy decode of ``n_steps`` tokens after ``prompt`` (the engine's
    loop; ``extra`` joins every prefill's batch, e.g. a VLM's patch
    embeddings), and for each decode step t the relative L2 distance and
    max |difference| of its logits over the vocabulary (a padded
    vocabulary's -1e30 rows would overflow the norm) from a prefill over
    the prompt and the first t generated tokens. Returns (tokens,
    [(rel, max_abs)], flips):
    ``flips[t]`` is True where a MoE layer sent step t's token to other
    experts in the decode than in the prefill: a near-tie in the router
    rounded the other way, or the prefill dropped the token past an
    expert's capacity (a one-token decode drops none). Either is a
    discrete jump, not rounding. Never for a dense model."""
    import torch
    vocab = getattr(model.cfg, "lm", model.cfg).vocab

    def fill(tokens):
        t = torch.from_numpy(np.asarray(tokens, np.int32)[None]).to(device)
        return model.prefill(params, {"tokens": t, **(extra or {})},
                             max_len)

    with torch.inference_mode(), recorded_routes() as routed:
        logits, cache = fill(prompt)
        gen = [int(torch.argmax(logits[0, -1]))]
        errs, flips = [], []
        for _ in range(n_steps - 1):
            step = torch.tensor([[gen[-1]]], dtype=torch.int32, device=device)
            routed.clear()
            lg, cache = model.decode_step(params, cache, step)
            decoded = [set(r[-1]) - {-1} for r in routed]
            routed.clear()
            ref, _ = fill(np.concatenate([prompt, gen]))
            flips.append(decoded != [set(r[-1]) - {-1} for r in routed])
            lg, ref = lg[..., :vocab].float(), ref[..., :vocab].float()
            d = lg - ref
            errs.append((float(d.norm() / ref.norm()), float(d.abs().max())))
            gen.append(int(torch.argmax(lg[0, -1])))
    return gen, errs, flips


def numpy_params(specs, seed: int):
    """Numpy weights for a ParamSpec tree: ones and zeros as specified,
    uniform of std ``scale / sqrt(fan_in)`` elsewhere (numpy's uniform
    draws are twice as fast as its normal ones at 0.6 G values)."""
    from repro_torch.models.common import tree_map
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale / math.sqrt(max(1, spec.shape[0]))
        a = rng.random(spec.shape, dtype=np.float32)
        a -= np.float32(0.5)
        a *= np.float32(std * math.sqrt(12.0))
        return a
    return tree_map(one, specs)


def forced_logits(model, params, prompt, tokens, max_len: int,
                  device, extra=None) -> list:
    """The logits (numpy f32) of a prefill over ``prompt`` (``extra``
    joins its batch) and of one decode step for each of ``tokens``."""
    import torch
    with torch.inference_mode():
        t = torch.from_numpy(np.asarray(prompt, np.int32)[None]).to(device)
        lg, cache = model.prefill(params, {"tokens": t, **(extra or {})},
                                  max_len)
        out = [lg.float().cpu().numpy()]
        for tok in tokens:
            step = torch.tensor([[tok]], dtype=torch.int32, device=device)
            lg, cache = model.decode_step(params, cache, step)
            out.append(lg.float().cpu().numpy())
    return out


def learned_cell(n: int, fracs, device, kinds=LEARNED_KINDS) -> list[dict]:
    """``benchmarks/learned_filter.py``'s cell with the port: for each
    train fraction and backup, the backup's bits, the fpr over the
    negatives, the false negatives and the build's host seconds."""
    from repro_torch.core.learned import LearnedFilter, synth_url_dataset
    keys, feats, labels = synth_url_dataset(n // 2, n // 2, seed=5)
    rows = []
    for frac in fracs:
        for kind in kinds:
            t = time.perf_counter()
            lf = LearnedFilter.build(keys, feats, labels, backup_kind=kind,
                                     model_fpr=0.01, seed=11,
                                     train_frac=frac, device=device)
            build_s = time.perf_counter() - t
            got = lf.query(keys, feats)
            rows.append({"n": n, "frac": frac, "kind": kind,
                         "bits": lf.filter_bits,
                         "fpr": float(got[~labels].mean()),
                         "fn": int((~got[labels]).sum()),
                         "model_bits": lf.model_bits, "build_s": build_s})
    return rows


def learned_faults(rows: list[dict]) -> list[str]:
    """Rows of ``learned_cell`` that miss the §5.5 figures: any false
    negative; a chained fpr over LEARNED_FPR_MAX; chained bits not below
    the bloom bits, or over LEARNED_BITS_REL from the reference's."""
    faults = [f"{r['kind']} at n {r['n']}, frac {r['frac']}: {r['fn']} "
              f"false negatives" for r in rows if r["fn"]]
    cells = {(r["n"], r["frac"], r["kind"]): r for r in rows}
    for (n, frac, kind), r in cells.items():
        if kind != "chained":
            continue
        if r["fpr"] > LEARNED_FPR_MAX:
            faults.append(f"chained fpr {r['fpr']} at n {n}, frac {frac}")
        bloom = cells.get((n, frac, "bloom"))
        if bloom is not None and r["bits"] >= bloom["bits"]:
            faults.append(f"chained bits {r['bits']} >= bloom "
                          f"{bloom['bits']} at n {n}, frac {frac}")
        ref = LEARNED_REF.get((n, frac))
        if ref is not None and abs(r["bits"] / ref[1] - 1) > LEARNED_BITS_REL:
            faults.append(f"chained bits {r['bits']} against the "
                          f"reference's {ref[1]} at n {n}, frac {frac}")
    return faults


# -- phase 11: the training path (llama3.2-1b) -----------------------------
# the full-width run: train_4k's sequence, its global batch of 256 cut to
# 2 (at 256 x 4,096 the f32 logits alone would be 537 GB)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 8
# one train step, the card against the CPU at f32 (TF32 off), FULL widths
# cut to 2 layers, batch 1, seq 128: loss (relative), each gradient leaf
# (relative L2), each param leaf after AdamW (relative L2)
TRAIN_CPU_SEQ, TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_PARAM_REL = \
    128, 1e-5, 1e-4, 1e-5
# the supervisor at smoke width: 12 steps, a save every 4, a failure at 6
SUP_STEPS, SUP_SAVE_EVERY, SUP_FAIL_AT = 12, 4, (6,)
BF16_FLOPS_PER_S = 989e12          # H100 SXM data sheet, dense
F32_FLOPS_PER_S = 67e12            # outside the tensor cores


def train_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(matmul, attention) FLOPs of one forward pass of a dense config
    over batch x seq tokens: 2 per weight of each projection, MLP and the
    LM head a token; scores and the probabilities' product 2 x 2 x seq x
    heads x head_dim a token and layer (the q-chunked attention computes
    every score and masks the future)."""
    D, dh, H, Hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    per_layer = D * H * dh * 2 + D * Hkv * dh * 2 + 3 * D * cfg.d_ff
    tokens = batch * seq
    mm = 2.0 * tokens * (cfg.n_layers * per_layer + D * cfg.padded_vocab)
    attn = 4.0 * tokens * seq * H * dh * cfg.n_layers
    return mm, attn


def train_run(device, *, smoke: bool, seq_len: int, batch: int,
              n_steps: int, arch: str = LM_ARCH) -> dict:
    """``launch/train.build_trainer`` for ``arch`` (llama3.2-1b), then
    ``n_steps`` calls of its ``step_fn`` from a fresh state: losses, host
    ms a step (``float(loss)`` waits for the device), the last state, the
    model and the pipeline."""
    from repro_torch.launch.train import build_trainer
    init_state, step_fn, model = build_trainer(
        arch, smoke=smoke, device=device, seq_len=seq_len, batch=batch)
    state = init_state()
    losses, ms = [], []
    for step in range(n_steps):
        t = time.perf_counter()
        state, loss = step_fn(state, step)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
    return {"losses": losses, "ms": ms, "state": state, "model": model,
            "data": step_fn.data}


def train_faults(losses: list) -> list[str]:
    faults = []
    if not all(math.isfinite(x) for x in losses):
        faults.append(f"a loss is not finite: {losses}")
    elif not losses[-1] < losses[0]:
        faults.append(f"the loss did not fall: {losses}")
    return faults


def carried_opt_state(np_params, step: int) -> dict:
    """A numpy AdamW state to continue from: m = 0.01 p, v = 1e-6 + m^2,
    ``step`` int32. With v > 0 the update is a smooth function of the
    gradient; from zero moments the first update is lr * sign(g), which a
    gradient element near 0 can flip between two summation orders."""
    from repro_torch.models.common import tree_map
    m = tree_map(lambda p: np.float32(0.01) * p, np_params)
    return {"m": m, "v": tree_map(lambda a: np.float32(1e-6) + a * a, m),
            "step": np.int32(step)}


def train_step_parts(model, np_params, np_opt, tokens, device):
    """One train step of ``model`` on ``device`` from numpy params and
    AdamW state, next-token labels of ``tokens`` [B, S+1]: (loss, each
    gradient leaf, each param leaf after AdamW) as numpy."""
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.common import params_from_numpy, tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, adamw_step
    params = params_from_numpy(np_params, device)
    opt = params_from_numpy(np_opt, device)
    t = torch.from_numpy(np.asarray(tokens, np.int32)).to(device)
    loss, grads = loss_and_grads(model, params,
                                 {"tokens": t[:, :-1], "labels": t[:, 1:]})
    with torch.no_grad():
        new_p, _, _ = adamw_step(AdamWConfig(), params, grads, opt)
    return (float(loss), [g.cpu().numpy() for g in tree_leaves(grads)],
            [p.cpu().numpy() for p in tree_leaves(new_p)])


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| (0 where both are 0)."""
    d = float(np.linalg.norm((a - b).ravel()))
    n = float(np.linalg.norm(b.ravel()))
    return d / n if n else d


def supervised_run(device, ckpt_dir: str, *, fail_at=()) -> dict:
    """The smoke trainer under ``ft.Supervisor``: SUP_STEPS steps, a
    checkpoint every SUP_SAVE_EVERY, failures injected at ``fail_at``."""
    from repro_torch.ft.supervisor import FailureInjector, Supervisor
    from repro_torch.launch.train import build_trainer
    init_state, step_fn, _ = build_trainer(LM_ARCH, smoke=True, device=device)
    sup = Supervisor(ckpt_dir, save_every=SUP_SAVE_EVERY)
    res = sup.run(init_state=init_state, step_fn=step_fn, n_steps=SUP_STEPS,
                  injector=FailureInjector(tuple(fail_at)))
    return {"res": res, "stat_skipped": sup.store.stat_skipped,
            "stat_calls": sup.store.stat_calls,
            "n_dropped": step_fn.data.n_dropped, "data": step_fn.data}


def supervisor_faults(failed: dict, clean: dict) -> list[str]:
    """What a run with one injected failure gets wrong against an
    uninterrupted one: restarts other than 1 and 0; losses other than the
    clean run's up to the failure, then again from the last checkpoint
    before it (bit for bit); no chunk stat skipped by the Bloom filter;
    documents dropped other than a fresh pipeline drops over the same
    steps on the host."""
    from repro_torch.data.pipeline import SyntheticLMData
    fail = SUP_FAIL_AT[0]
    resume = fail // SUP_SAVE_EVERY * SUP_SAVE_EVERY
    want = clean["res"].losses[:fail] + clean["res"].losses[resume:]
    faults = []
    if (failed["res"].n_restarts, clean["res"].n_restarts) != (1, 0):
        faults.append(f"restarts {failed['res'].n_restarts} and "
                      f"{clean['res'].n_restarts}, not 1 and 0")
    if failed["res"].losses != want:
        faults.append(f"losses {failed['res'].losses} != the uninterrupted "
                      f"run's, resumed at step {resume}: {want}")
    if not failed["stat_skipped"] > 0:
        faults.append("the chunk filter skipped no existence check")
    host = SyntheticLMData(failed["data"].cfg)
    for step in range(SUP_STEPS):
        host.batch(step)
    if not failed["n_dropped"] == clean["n_dropped"] == host.n_dropped:
        faults.append(f"documents dropped {failed['n_dropped']} (failed), "
                      f"{clean['n_dropped']} (clean), {host.n_dropped} "
                      f"(host pipeline)")
    return faults


# -- phase 12: MoE and MLA (deepseek-v2-lite-16b) and the other archs --------
MOE_ARCH = "deepseek-v2-lite-16b"
# FULL widths cut to 2 layers (deepseek-v2-lite: one dense, one MoE)
CUT_ARCHS = ("deepseek-7b", "qwen3-14b", "deepseek-67b",
             "llama4-scout-17b-a16e", "internvl2-26b")
CUT_LAYERS, CUT_PROMPT, CUT_STEPS = 2, 64, 8
# decode against teacher forcing at deepseek-v2-lite FULL over the first
# 16 tokens of the engine's first prompt: every prefill then holds at most
# 16 + 15 = 31 tokens, under the 32 slots an expert always has, so no
# pair is dropped past capacity whatever the routing (a 64-token prefill
# drops the pairs of tokens that crowd an expert, which a one-token decode
# never does). At bf16 a step's token is often routed otherwise: the two
# paths round differently, and over 26 MoE layers a near-tie between the
# 6th and 7th expert flips in most steps. At f32 (TF32 off) they round
# alike to ~1e-7, and every step is held to TF_REL_F32: f32 arithmetic
# in other summation orders over 27 layers.
MOE_TF_PROMPT, TF_REL_F32 = 16, 1e-4
# the loss and its gradients, card against CPU at f32: batch 1, seq 64;
# the same f32 arithmetic in other summation orders, as phase 11's
MOE_CPU_SEQ, MOE_LOSS_REL, MOE_GRAD_REL = 64, 1e-5, 1e-4


def cut_model(arch_id: str, n_layers: int = CUT_LAYERS):
    """The arch's FULL config cut to ``n_layers`` (a VLM: its backbone's),
    every width as published."""
    from repro_torch.configs import get_arch
    m = get_arch(arch_id).model()
    if hasattr(m.cfg, "lm"):
        return type(m)(replace(m.cfg, lm=replace(m.cfg.lm, n_layers=n_layers)))
    return type(m)(replace(m.cfg, n_layers=n_layers))


def bf16_params(model, device, seed: int = 0):
    """bf16 weights from a seed on ``device``, drawn leaf by leaf (each
    leaf's f32 draw is freed before the next): the whole of
    deepseek-v2-lite is 31.4 GB this way, 94 GB as f32 plus a bf16 copy."""
    import torch
    from repro_torch.models import common as MC
    return MC.init_from_specs(model.param_specs(),
                              torch.Generator(device).manual_seed(seed),
                              device, dtype=torch.bfloat16)


def tf_faults(errs: list, flips: list, bound: float) -> list[str]:
    """Decode steps off teacher forcing by more than ``bound`` (relative
    L2) among those routed alike on both paths, and any step whose
    distance is not finite."""
    return [f"step {i}: relative L2 {rel} > {bound}"
            for i, ((rel, _), flip) in enumerate(zip(errs, flips))
            if not math.isfinite(rel) or (not flip and rel > bound)]


def cut_cell(arch_id: str, device, *, prompt_len: int = CUT_PROMPT,
             n_steps: int = CUT_STEPS, seed: int = 0) -> dict:
    """The arch at FULL widths cut to CUT_LAYERS, bf16 weights from a seed
    on ``device``: a ``prompt_len``-token prefill, ``n_steps`` decode
    steps against teacher forcing (a VLM: after 256 seeded patch
    embeddings), host ms of a prefill and a decode step (a warm call
    first)."""
    import torch
    from repro_torch.models.common import tree_leaves
    m = cut_model(arch_id)
    lm = getattr(m.cfg, "lm", m.cfg)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, lm.vocab, prompt_len).astype(np.int32)
    extra, n_vis = {}, getattr(m.cfg, "n_patches", 0)
    if n_vis:
        extra = {"patch_embeds": torch.from_numpy(rng.normal(
            size=(1, n_vis, lm.d_model)) * 0.25).to(device, torch.float32)}
    max_len = n_vis + prompt_len + n_steps + 1
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    params = bf16_params(m, device, seed)
    gen, errs, flips = teacher_forcing(m, params, prompt, n_steps + 1,
                                       max_len, device, extra)
    t = torch.from_numpy(prompt[None]).to(device)
    with torch.inference_mode():
        def prefill():
            return m.prefill(params, {"tokens": t, **extra}, max_len)
        _, cache = prefill()
        step = torch.tensor([[gen[0]]], dtype=torch.int32, device=device)
        ms = {}
        for name, fn in (("prefill", prefill),
                         ("decode", lambda: m.decode_step(params, cache,
                                                          step))):
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
                sync()
            ms[name] = (time.perf_counter() - t0) * 1e3 / 3
    n_params = sum(a.numel() for a in tree_leaves(params))
    return {"arch": arch_id, "layers": lm.n_layers, "params": n_params,
            "errs": errs, "flips": flips, "prefill_ms": ms["prefill"],
            "decode_ms": ms["decode"], "patches": n_vis}


def loss_grad_parts(model, np_params, tokens, device, extra=None) -> tuple:
    """The model's loss (float) on ``tokens`` [B, S + 1] (``extra``
    joins the batch, moved to ``device``) and its gradient leaves (numpy
    f32, ``tree_leaves`` order), from numpy params on ``device``."""
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import common as MC
    params = MC.params_from_numpy(np_params, device)
    t = torch.from_numpy(np.asarray(tokens, np.int32)).to(device)
    loss, grads = loss_and_grads(model, params, {
        "tokens": t[:, :-1], "labels": t[:, 1:],
        **{k: v.to(device) for k, v in (extra or {}).items()}})
    return float(loss), [g.float().cpu().numpy()
                         for g in MC.tree_leaves(grads)]


# -- phase 13: the SSM hybrid, RWKV6 and the encoder-decoder ----------------
SSM_ARCHS = ("zamba2-2.7b", "rwkv6-7b", "whisper-tiny")
# card against CPU at f32 (TF32 off): zamba2 at FULL widths cut to 6
# layers (cut to 2 it has no shared block, which sits after layer 5 of
# each 6), rwkv6 cut to 2, whisper whole (None)
SSM_CPU_LAYERS = {"zamba2-2.7b": 6, "rwkv6-7b": 2, "whisper-tiny": None}
# teacher forcing over the first 16 prompt tokens: every teacher prefill
# (16 + 15 tokens at most) is one chunk below 64, which the chunk assert
# of _ssd_chunk / _chunk_wkv admits (65-79 tokens would be refused)
SSM_TF_PROMPT = 16
# requests of the serve cells: with 16 for all three the whole run took
# 917 s (NVIDIA H100 80GB HBM3, 700 W), past the 900 s kept under the
# 1,200 s limit, so rwkv6 and whisper serve 8 over the same 4 prompts
# (0.5 and 0.75 of the prefill tokens saved); with phase 17 added, a run
# on a slow host took 1,053 s with zamba2 at 16 (~100 s of its serve
# runs), so zamba2 serves 8 too
SSM_REQUESTS = 8
# the decode bound's extra bytes for an encoder-decoder: each decode
# step recomputes every decoder layer's cross-attention K/V over the
# encoder output, as the reference does: memory read once (2 B a value),
# K and V written and read back by the attention
ENCDEC_KV_PASSES = 5


# decode against teacher forcing at bf16: TF_REL_BF16 but for rwkv6-7b.
# Its 32 layers read 0.146-0.228 on the card over the 15 steps with the
# zero-initialised leaves at zero, 0.2155-0.236 with draw_state_leaves'
# (NVIDIA H100 80GB HBM3, 700 W), while the same steps at f32 agree to
# TF_REL_F32: the two paths compute the same function and the stack
# multiplies each layer's bf16 roundings (the WKV state sums r.k over the
# history unnormalised; the channel mix squares its ReLU). The bound is
# twice the largest step, rounded up. A decode that lost its whole state
# (lost_state_rels' "all", 1.416) must read above it; one that lost a
# single kind of leaf can read below a bf16 bound (rwkv6's xc 0.286,
# zamba2's s 0.016, whisper's k 0.033), and is held by the f32 check,
# where every kind reads above TF_REL_F32.
SSM_TF_REL_BF16 = {"rwkv6-7b": 0.5}
# the card against the CPU at f32: each gradient leaf's relative L2, as
# phase 12 holds it (MOE_GRAD_REL), but for whisper-tiny: its decoder's
# cross-attention wq / wk gradients sum over 1,500 frames whose softmax
# weights are near-uniform at random init, small differences of large
# terms, and the card measured 1.0075e-4 against the CPU on one of them
# (NVIDIA H100 80GB HBM3, 700 W); three times that
SSM_GRAD_REL = {"whisper-tiny": 3e-4}
SSM_STATE_SEED = 3
# phase 13's weights hold the zero-initialised leaves as a trained model
# holds them, so that the decay, the bonus, the token shift and the skip
# carry state on the card: drawn uniform over the ranges of the published
# inits (RWKV6's w0 in [-6, -1], per-token decays exp(-exp(w0)) of 0.69
# to 0.9975; its bonus u in [-0.1, 1]; its lerps mu_* in [0, 1]; Mamba2's
# A in [1, 16] and dt log-uniform in [1e-3, 0.1] through the softplus's
# inverse); the ones-initialised gains 1 + U(-0.1, 0.1)
STATE_LEAVES = {
    "w0": lambda rng, n: rng.uniform(-6.0, -1.0, n),
    "u": lambda rng, n: rng.uniform(-0.1, 1.0, n),
    "mu": lambda rng, n: rng.uniform(0.0, 1.0, n),
    "a_log": lambda rng, n: np.log(rng.uniform(1.0, 16.0, n)),
    "dt_bias": lambda rng, n: (lambda dt: dt + np.log(-np.expm1(-dt)))(
        np.exp(rng.uniform(math.log(1e-3), math.log(0.1), n))),
    "ones": lambda rng, n: 1.0 + rng.uniform(-0.1, 0.1, n),
}


def draw_state_leaves(specs, params, seed: int):
    """Replace in place the zero- and one-initialised leaves of ``params``
    (numpy arrays or tensors, ``specs`` its ParamSpec tree) by
    STATE_LEAVES' draws from a seed; the same seed gives the same values
    in either form. Returns ``params``."""
    import torch
    rng = np.random.default_rng(seed)

    def walk(spec, tree):
        for k, sp in (spec.items() if isinstance(spec, dict)
                      else enumerate(spec)):
            if isinstance(sp, (dict, list)):
                walk(sp, tree[k])
            elif sp.init in ("zeros", "ones"):
                name = ("ones" if sp.init == "ones" else
                        "mu" if k.startswith("mu_") else k)
                a = STATE_LEAVES[name](rng, sp.shape).astype(np.float32)
                leaf = tree[k]
                tree[k] = a if isinstance(leaf, np.ndarray) else \
                    torch.from_numpy(a).to(leaf.device, leaf.dtype)
    walk(specs, params)
    return params


def lost_state_rels(model, params, prompt, tok: int, max_len: int,
                    device, extra=None) -> dict:
    """The control of decode against teacher forcing: for each kind of
    cache leaf (its dict key: ``s``, ``conv``, ``xt``, ``k``,
    ``memory``...) and for all of them (``all``), the relative L2 of the
    logits of a decode step of ``tok`` from the prompt's cache with every
    leaf of that kind zeroed, against a prefill over the prompt and
    ``tok``. A decode that lost that state reads this; a bound it does
    not exceed could not tell."""
    import torch
    vocab = getattr(model.cfg, "lm", model.cfg).vocab

    def kinds(tree):
        if isinstance(tree, dict):
            return {k for k, v in tree.items() if isinstance(v, torch.Tensor)
                    } | {n for v in tree.values() for n in kinds(v)}
        if isinstance(tree, list):
            return {n for v in tree for n in kinds(v)}
        return set()

    def zeroed(tree, names):
        if isinstance(tree, dict):
            return {k: torch.zeros_like(v) if k in names else
                    zeroed(v, names) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeroed(v, names) for v in tree]
        return tree

    def fill(tokens):
        t = torch.from_numpy(np.asarray(tokens, np.int32)[None]).to(device)
        return model.prefill(params, {"tokens": t, **(extra or {})},
                             max_len)

    with torch.inference_mode():
        _, cache = fill(prompt)
        ref = fill(np.append(prompt, tok))[0][..., :vocab].float()
        step = torch.tensor([[tok]], dtype=torch.int32, device=device)
        names = sorted(kinds(cache))
        out = {}
        for kind, zero in [(n, {n}) for n in names] + [("all", set(names))]:
            lg = model.decode_step(params, zeroed(cache, zero), step)[0]
            out[kind] = float((lg[..., :vocab].float() - ref).norm()
                              / ref.norm())
    return out


def payload_bytes(cache) -> int:
    """Bytes of a decode cache's tensors: what the prefix cache copies to
    the host on an insert and uploads on a hit (beside the logits)."""
    from repro_torch.models.common import tree_leaves
    return sum(a.numel() * a.element_size() for a in tree_leaves(cache)
               if hasattr(a, "numel"))


def decode_bound_bytes(model) -> int:
    """Bytes one bf16 decode step must move at least: every weight but the
    embedding table (one row of it is read a token) once; an
    encoder-decoder adds its decoder layers' cross-attention K/V
    recomputed over the encoder output (ENCDEC_KV_PASSES passes of
    n_frames x d_model bf16 values a layer)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.encdec import EncDecLM
    specs = model.param_specs()
    n = sum(math.prod(s.shape) for s in tree_leaves(specs))
    out = 2 * (n - math.prod(specs["embed"].shape))
    if isinstance(model, EncDecLM):
        c = model.cfg
        out += c.n_layers * ENCDEC_KV_PASSES * c.n_frames * c.d_model * 2
    return out



# -- device timing, shared by the phases ------------------------------------
def cuda_ms(fn, windows: int = TIME_WINDOWS) -> tuple[float, list]:
    """Median ms per call over ``windows`` CUDA-event windows, each of
    enough warm calls to cover WINDOW_MS; also every window's ms."""
    import torch
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


def device_rows(fn):
    """(device µs, count, name) of each device operation (kernels and
    copies: the profiler's device-side events) in one call of ``fn``,
    or why not measured. The CPU ops that launch them report the same
    time as their own and are not counted again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type != DeviceType.CPU
                and e.self_device_time_total > 0]
    except Exception as exc:          # the profiler is optional here
        return f"not measured ({exc})"
    return rows or "not measured (no device-side events)"


def device_totals(rows):
    """(device ms, device operations) of ``device_rows``' rows."""
    if isinstance(rows, str):
        return rows
    return sum(us for us, _, _ in rows) / 1e3, sum(c for _, c, _ in rows)


def busy(prof, call_ms: float) -> str:
    """The device's share of a call of ``call_ms`` host ms (timed
    without the profiler)."""
    if isinstance(prof, str):
        return prof
    dev_ms, ops = prof
    return (f"{dev_ms:.3f} ms of device time in {ops} device "
            f"operations (kernels and copies), device busy "
            f"{100 * dev_ms / call_ms:.1f}% of a {call_ms:.1f} ms call")


# -- phase 14: the row split over a DeviceMesh and the dry-run census -------
MESH_TIMEOUT_S = 120.0             # the NCCL group's collective timeout
MESH_REPEATS = 5                   # host-clock probes a median is taken of
# the census's meshes: the production ones as data, and the card's own
CENSUS_MESHES = ("single_pod_16x16", "multi_pod_2x16x16", "host_1x1")


def host_median_ms(fn) -> float:
    """Median host ms of MESH_REPEATS calls of ``fn`` after a warm call,
    each ending in a device synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(MESH_REPEATS):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def mesh_faults(member, probes, stats: dict, want) -> list[str]:
    """Where a mesh service's probe differs from the one-device service's
    ``want`` = (member, probes, stats as_dict)."""
    faults = []
    if member.shape != want[0].shape or not (member == want[0]).all():
        faults.append("member rows differ")
    if probes.shape != want[1].shape or not (probes == want[1]).all():
        faults.append("probes rows differ")
    if stats != want[2]:
        faults.append(f"stats {stats} != {want[2]}")
    return faults


def gather_rows(rows):
    """The collective's rows of ``device_rows``' rows (NCCL kernels), or
    why there are none."""
    if isinstance(rows, str):
        return rows
    out = [r for r in rows if "nccl" in r[2].lower()
           or "allgather" in r[2].lower().replace("_", "")]
    return out or "not seen (no NCCL kernel among the call's device operations)"


def census_rows(meshes: dict, archs=None) -> dict:
    """``launch.dryrun.run_cell`` of every (arch, applicable shape) at
    each of ``meshes`` ({name: mesh}) -> {(arch, shape): {mesh name:
    record}}."""
    from repro_torch.configs import REGISTRY, applicable_shapes
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for aid in sorted(REGISTRY) if archs is None else archs:
        for sn in applicable_shapes(REGISTRY[aid]):
            out[(aid, sn)] = {name: run_cell(aid, sn, mesh, name,
                                             verbose=False)
                              for name, mesh in meshes.items()}
    return out


def census_lines(cells: dict, device_bytes: int) -> list[str]:
    """One line a cell: per-device argument GB at each mesh, and whether
    the arguments alone fit a card of ``device_bytes``."""
    lines = []
    for (aid, sn), recs in cells.items():
        parts = []
        for name, rec in recs.items():
            args = sum(rec["memory_model"]["args"].values())
            parts.append(f"{name} {args / 1e9:.3f} GB "
                         f"({'fits' if args <= device_bytes else 'over'})")
        lines.append(f"census {aid} {sn}: args per device " + ", ".join(parts))
    return lines


def mesh_phase(bank, queries, want, train_arg_bytes: dict, counters, *,
               device="cuda", card: str = "", then=None) -> tuple[dict, dict]:
    """Phase 14 in a 1-rank process group (NCCL on the card, gloo on the
    CPU; any failure to start it fails the run): ``mesh_probe_cell`` over
    the filters of ``bank`` on a (1,) 'data' mesh, then ``census_cell`` with
    the (1, 1) host mesh; then ``then(host_mesh, census (1, 1) train
    bytes)`` (phase 15) in the same group, destroyed in one ``finally``.
    -> the mesh probe's (launches, paths)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, start_group
    with tempfile.TemporaryDirectory() as group_dir:
        try:
            start_group(group_dir, 0, 1, device=device,
                        timeout_s=MESH_TIMEOUT_S)
            mesh = make_mesh((1,), ("data",), device=device)
            host_mesh = make_host_mesh(device=device)
        except Exception as exc:
            fail(f"the 1-rank process group or its meshes did not start: "
                 f"{exc!r}")
        try:
            out = mesh_probe_cell(bank, queries, want, mesh, counters,
                                  card=card)
            census = census_cell(host_mesh, train_arg_bytes, card=card)
            if then is not None:
                then(host_mesh, census)
        finally:
            dist.destroy_process_group()
    return out


def mesh_probe_cell(bank, queries, want, mesh, counters, *, card: str = ""
                    ) -> tuple[dict, dict]:
    """``FilterService(mesh=mesh)`` over the filters of ``bank`` (as
    built) against ``want`` = the one-device service's (member, probes,
    stats as_dict) on ``queries``, bit for bit; one launch of each bank
    kernel, by the path ``counters.rule`` gives at one rank's share of
    the keys; host times in turns with the one-device service, the
    profiled device time and the all-gather alone. ``counters`` reads the
    kernels' launch counts: ``reset()``, ``launches()``, ``paths()`` and
    ``rule(n_keys, words)``. -> (launches, paths)."""
    import torch
    import torch.distributed as dist
    from repro_torch.serving.filter_service import FilterService, row_share
    device = torch.device(mesh.device_type)
    built = bank.unpack()
    msvc = FilterService(built, device=device, mesh=mesh)
    one = FilterService(built, device=device)
    check(msvc.bank.tables.tobytes() == bank.tables.tobytes(),
          "the mesh service's bank differs from the one it was built from")
    n = len(queries)
    share = row_share(n, mesh.size())
    counters.reset()
    member, probes = msvc.probe(queries)
    torch.cuda.synchronize()
    launches, paths = counters.launches(), counters.paths()
    faults = mesh_faults(member, probes, msvc.stats.as_dict(), want)
    check(not faults, f"mesh FilterService != the one-device service on "
          f"{n} queries: {faults}")
    check(all(v == 1 for v in launches.values()),
          f"the mesh probe launched {launches}, not one each")
    rule = counters.rule(share, msvc.state.tables)
    check(paths == rule, f"the mesh probe took paths {paths}, the rule at "
          f"{share} keys a rank says {rule}")
    # host times in turns (one device, mesh, mesh, one device)
    one_ms = [host_median_ms(lambda: one.probe(queries))]
    mesh_ms = [host_median_ms(lambda: msvc.probe(queries)),
               host_median_ms(lambda: msvc.probe(queries))]
    one_ms.append(host_median_ms(lambda: one.probe(queries)))
    rows = device_rows(lambda: msvc.probe(queries))
    gather = device_totals(gather_rows(rows))
    # the all-gather alone at the probe's shape, by CUDA events:
    # [2 x F, share] int32 rows read once and written once
    g_in = torch.zeros(2 * len(built) * share, dtype=torch.int32,
                       device=device)
    g_out = torch.empty_like(g_in)
    g_ms, _ = cuda_ms(lambda: dist.all_gather_into_tensor(
        g_out, g_in, group=mesh.get_group("data")))
    g_bound = 2 * g_in.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"mesh FilterService: a 1-rank process group (FileStore, "
          f"timeout {MESH_TIMEOUT_S:.0f} s), make_mesh((1,), ('data',)) over "
          f"phase 7's {len(built)} filters as built ({msvc.bank.nbytes / 1e6:.1f}"
          f" MB): member, probes and stats == phase 7's one-device service on "
          f"all {n} queries ({share} keys a rank after padding) | launches "
          f"{launches}, by path {paths} (the rule at {share} keys) | probe "
          f"host ms, median of {MESH_REPEATS} after a warm call, in turns: "
          f"one device {one_ms[0]:.1f}, mesh {mesh_ms[0]:.1f}, mesh "
          f"{mesh_ms[1]:.1f}, one device {one_ms[1]:.1f} | one mesh probe "
          f"profiled: {busy(device_totals(rows), mesh_ms[0])}; its all-gather "
          + (gather if isinstance(gather, str) else
             f"{gather[0]:.3f} ms of device time in {gather[1]} operations")
          + f" | the all-gather alone ({2 * len(built)} x {share} int32, "
          f"{8 * len(built) * share / 1e6:.1f} MB; CUDA events, median of "
          f"windows): {g_ms:.4f} ms, bound {g_bound:.4f} ms (read and written "
          f"once at 3.35 TB/s) | {card}", flush=True)
    return launches, paths


def census_cell(host_mesh, train_arg_bytes: dict, *, card: str = "") -> dict:
    """The dry-run census on meta tensors at 16x16, 2x16x16 and
    ``host_mesh``: no device memory allocated, each cell's per-device
    argument GB beside the card's memory, and the (1, 1) LM_ARCH
    ``train_4k`` params and AdamW state equal to ``train_arg_bytes``,
    what phase 11 allocated. -> those (1, 1) bytes."""
    import torch
    from repro_torch.launch.mesh import make_production_mesh
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cells = census_rows(dict(zip(CENSUS_MESHES, (
        make_production_mesh(), make_production_mesh(multi_pod=True),
        host_mesh))))
    census_s = time.perf_counter() - t
    check(torch.cuda.max_memory_allocated() == held,
          f"the census allocated device memory: peak "
          f"{torch.cuda.max_memory_allocated()} B over {held} B held")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    for line in census_lines(cells, total_mem):
        print(line, flush=True)
    host_train = cells[(LM_ARCH, "train_4k")]["host_1x1"]
    got = {k: host_train["memory_model"]["args"][k] for k in ("params", "opt")}
    check(got == train_arg_bytes,
          f"census {LM_ARCH} train_4k on (1, 1): {got} B, phase 11 "
          f"allocated {train_arg_bytes} B")
    n_fit = {name: sum(sum(r[name]["memory_model"]["args"].values())
                       <= total_mem for r in cells.values())
             for name in CENSUS_MESHES}
    print(f"census: {len(cells)} (arch, shape) cells x {len(CENSUS_MESHES)} "
          f"meshes in {census_s:.1f} s on meta tensors (peak device memory "
          f"over the census == the {held} B held before it); arguments that "
          f"fit one card of {total_mem / 1e9:.1f} GB: {n_fit} | {LM_ARCH} "
          f"train_4k on (1, 1): params {got['params']} B and AdamW state "
          f"{got['opt']} B == phase 11's allocation | {card}", flush=True)
    return got


# -- phase 15: the LM steps run sharded over the card's (1, 1) DeviceMesh ---
# llama3.2-1b FULL: a train step at phase 11's seq 4,096 x batch 2, then a
# prefill of phase 10's 64-token prompt into a 256-token cache and 16
# decode steps; deepseek-v2-lite-16b at FULL widths cut to 2 layers (one
# dense, one MoE layer, MLA): a train step at batch 2 x seq 64, then a
# 16-token prefill and 8 decode steps. On one rank every spec is () and
# each DTensor is replicated, so the steps run the one-device kernels on
# the same values: any difference fails the run.
SHARD_DECODE, SHARD_MOE_DECODE = 16, 8
SHARD_MOE_BATCH, SHARD_MOE_SEQ, SHARD_MOE_PROMPT = 2, 64, 16
SHARD_TIMED = 8                    # decode steps timed a turn


def worse(a: float, b: float) -> float:
    """The larger of two differences; nan if either is (``max`` would
    drop a nan that comes second)."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def tree_max_diff(a, b) -> float:
    """The largest |a - b| over the leaves of two trees of one structure
    (DTensors read whole, host ints compared): 0.0 when every leaf is
    equal bit for bit; inf where shapes, dtypes or ints differ; nan where
    a leaf holds a nan (in either tree, even at the same place)."""
    import torch
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding.rules import full_tree
    worst = 0.0
    for x, y in zip(tree_leaves(full_tree(a)), tree_leaves(full_tree(b)),
                    strict=True):
        if not isinstance(x, torch.Tensor):
            worst = worst if x == y else worse(worst, math.inf)
        elif x.shape != y.shape or x.dtype != y.dtype:
            worst = worse(worst, math.inf)
        elif not torch.equal(x, y):
            worst = worse(worst, float((x.float() - y.float()).abs().max()))
    return worst


def timed_ms(fn) -> tuple:
    """(fn's result, host ms of the call, the device synchronised)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def sharded_train_case(model, mesh, args: tuple, placed=None) -> dict:
    """One train step of ``model`` on one device from ``args`` = (params,
    AdamW state, batch) and over ``mesh`` from the same values (as
    ``placed`` there, else placed by the step), under torch's
    deterministic algorithms:
    the largest difference of each result tree, then host ms of both in
    turns (one device, mesh, mesh, one device: each step's new state
    freed before the next)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    one = make_train_step(model, AdamWConfig())
    sharded = make_train_step(model, AdamWConfig(), mesh=mesh)
    run = {"one": lambda: one(*args),
           "mesh": lambda: sharded(*(placed or args))}
    ms = {"one": [], "mesh": []}
    torch.use_deterministic_algorithms(True)
    try:
        (p1, o1, m1), t1 = timed_ms(run["one"])
        (p2, o2, m2), t2 = timed_ms(run["mesh"])
        ms["one"].append(t1)
        ms["mesh"].append(t2)
        diffs = {"loss": tree_max_diff(m1["loss"], m2["loss"]),
                 "grad_norm": tree_max_diff(m1["grad_norm"],
                                            m2["grad_norm"]),
                 "params": tree_max_diff(p1, p2),
                 "m": tree_max_diff(o1["m"], o2["m"]),
                 "v": tree_max_diff(o1["v"], o2["v"]),
                 "step": tree_max_diff(o1["step"], o2["step"])}
        loss = float(m1["loss"])
        out_dtensors = all(hasattr(t, "placements") for t in
                           tree_leaves((p2, o2)))
        del p1, o1, m1, p2, o2, m2
        for name in ("mesh", "one"):
            res, t = timed_ms(run[name])
            ms[name].append(t)
            del res
    finally:
        torch.use_deterministic_algorithms(False)
    return {"diffs": diffs, "loss": loss, "ms": ms,
            "out_dtensors": out_dtensors}


def sharded_serve_case(model, mesh, params, prompt, n_steps: int,
                       max_len: int) -> dict:
    """A prefill of ``prompt`` [B, S] into a ``max_len`` cache and
    ``n_steps`` greedy decode steps (the one-device path's tokens fed to
    both), on one device and over ``mesh``: the largest difference of
    the prefill's logits, of each decode step's and of the last cache;
    then SHARD_TIMED decode steps a turn from the prefilled caches (one
    device, mesh, mesh, one device), host ms a token; the device
    operations of one decode step on each path."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    pre = {"one": make_prefill_step(model, max_len),
           "mesh": make_prefill_step(model, max_len, mesh=mesh)}
    dec = {"one": make_serve_step(model),
           "mesh": make_serve_step(model, mesh=mesh)}
    out, diffs = {}, {"prefill": 0.0, "decode": 0.0}
    for name in ("one", "mesh"):
        out[name] = [pre[name](params, {"tokens": prompt})]
    caches = {name: out[name][0][1] for name in out}
    diffs["prefill"] = tree_max_diff(out["one"][0][0], out["mesh"][0][0])
    first = dict(caches)
    for _ in range(n_steps):
        tok = out["one"][-1][0][:, -1].argmax(-1)[:, None].to(torch.int32)
        for name in ("one", "mesh"):
            out[name].append(dec[name](params, caches[name], tok))
            caches[name] = out[name][-1][1]
        diffs["decode"] = worse(diffs["decode"], tree_max_diff(
            out["one"][-1][0], out["mesh"][-1][0]))
    diffs["cache"] = tree_max_diff(caches["one"], caches["mesh"])
    tok = out["one"][-1][0][:, -1].argmax(-1)[:, None].to(torch.int32)
    del out, caches
    ms = {"one": [], "mesh": []}
    for name in ("one", "mesh", "mesh", "one"):
        def steps_(name=name):
            c = first[name]
            for _ in range(SHARD_TIMED):
                _, c = dec[name](params, c, tok)
        _, t = timed_ms(steps_)
        ms[name].append(t / SHARD_TIMED)
    rows = {name: device_rows(lambda name=name: dec[name](
        params, first[name], tok)) for name in ("one", "mesh")}
    return {"diffs": diffs, "ms": ms, "rows": rows}


def sharded_faults(diffs: dict) -> list[str]:
    """Each result tree of a sharded step that differs from the
    one-device step's."""
    return [f"{k} differs by {v}" for k, v in diffs.items() if v != 0.0]


def sharded_phase(mesh, census_bytes: dict, *, device="cuda",
                  card: str = "", smoke: bool = False) -> None:
    """Phase 15 on the card's (1, 1) DeviceMesh (inside phase 14's
    process group): llama3.2-1b FULL and deepseek-v2-lite-16b cut to 2
    layers, their sharded train, prefill and decode steps held to the
    one-device steps bit for bit, with the placed bytes (== the census's
    ``census_bytes``), host ms in turns and device operations. ``smoke``:
    both archs' smoke configs (the CPU tests)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import common as MC
    from repro_torch.sharding.rules import local_bytes
    t15 = time.monotonic()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    # (a) llama3.2-1b FULL: the trainer's fresh state (phase 11's step 0)
    init_state, step_fn, model = build_trainer(
        LM_ARCH, smoke=smoke, device=device,
        seq_len=None if smoke else TRAIN_SEQ,
        batch=None if smoke else TRAIN_BATCH)
    state = init_state()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in step_fn.data.batch(0).items()}
    cell = build_cell(get_arch(LM_ARCH), "train_4k", device=device,
                      mesh=mesh, smoke=smoke)
    placed = cell.place((state["params"], state["opt"], batch))
    got = {k: local_bytes(t) for k, t in zip(("params", "opt"), placed)}
    want = {k: cell.arg_local_bytes()[k] for k in ("params", "opt")}
    check(got == want == census_bytes,
          f"sharded {LM_ARCH} train_4k on (1, 1): placed {got} B, "
          f"Cell.arg_local_bytes {want} B, the census {census_bytes} B")
    train = sharded_train_case(model, mesh, (state["params"], state["opt"],
                                             batch), placed)
    check(train["out_dtensors"], "the sharded train step returned a "
          "plain tensor in its params or AdamW state")
    faults = sharded_faults(train["diffs"])
    check(not faults, f"sharded {LM_ARCH} train step != the one-device "
          f"step: {faults}")
    tokens_shape = tuple(batch["tokens"].shape)
    del placed, cell, batch, step_fn
    # the serving weights: bf16 copies of the state's params
    params = MC.tree_map(lambda t: t.to(torch.bfloat16), state["params"])
    del state
    rng = np.random.default_rng(15)
    prompt = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, (1, LM_PROMPT_LEN)).astype(np.int32)).to(device)
    serve = sharded_serve_case(model, mesh, params, prompt, SHARD_DECODE,
                               LM_MAX_LEN)
    faults = sharded_faults(serve["diffs"])
    check(not faults, f"sharded {LM_ARCH} prefill / decode != the "
          f"one-device steps: {faults}")
    del params
    ops = {k: device_totals(r) for k, r in serve["rows"].items()}
    per_op = {k: (statistics.median(serve["ms"][k]) / v[1] * 1e3
                  if not isinstance(v, str) and v[1] else None)
              for k, v in ops.items()}
    print(f"sharded {LM_ARCH}: {model.cfg.name} on the (1, 1) DeviceMesh "
          f"{tuple(mesh.mesh_dim_names)} (every spec (), every DTensor "
          f"replicated), {str(MC.COMPUTE_DTYPE)[6:]} compute | train step at "
          f"{tokens_shape} tokens from the trainer's fresh "
          f"state (f32 master "
          f"weights, deterministic algorithms): loss {train['loss']:.6f}, "
          f"largest difference from the one-device step {train['diffs']} | "
          f"placed bytes {got} == Cell.arg_local_bytes == the census's "
          f"(1, 1) row | train host ms, one device, mesh, mesh, one device:"
          f" {train['ms']['one'][0]:.1f}, {train['ms']['mesh'][0]:.1f}, "
          f"{train['ms']['mesh'][1]:.1f}, {train['ms']['one'][1]:.1f} | "
          f"prefill {LM_PROMPT_LEN} tokens (max_len {LM_MAX_LEN}) and "
          f"{SHARD_DECODE} decode steps, bf16 weights: largest difference "
          f"{serve['diffs']} | decode host ms a token ({SHARD_TIMED} steps a "
          f"turn), one device, mesh, mesh, one device: "
          f"{serve['ms']['one'][0]:.2f}, {serve['ms']['mesh'][0]:.2f}, "
          f"{serve['ms']['mesh'][1]:.2f}, {serve['ms']['one'][1]:.2f} | one "
          f"decode step profiled: one device {busy(ops['one'], serve['ms']['one'][0])}"
          f", mesh {busy(ops['mesh'], serve['ms']['mesh'][0])} | host us a "
          f"device operation, one device {per_op['one']}, mesh "
          f"{per_op['mesh']} | {card}", flush=True)
    # (b) deepseek-v2-lite-16b at FULL widths cut to 2 layers (MoE, MLA)
    m = get_arch(MOE_ARCH).model(smoke=True) if smoke else cut_model(MOE_ARCH)
    m.remat, m.q_chunk = True, 512
    mp = MC.init_from_specs(m.param_specs(),
                            torch.Generator(device).manual_seed(0), device)
    from repro_torch.optim.adamw import adamw_init
    mo = adamw_init(mp)
    toks = torch.from_numpy(rng.integers(
        0, m.cfg.vocab, (SHARD_MOE_BATCH, SHARD_MOE_SEQ + 1)).astype(
            np.int32)).to(device)
    train_moe = sharded_train_case(m, mesh, (mp, mo, {
        "tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    faults = sharded_faults(train_moe["diffs"])
    check(not faults, f"sharded {MOE_ARCH} (2 layers) train step != the "
          f"one-device step: {faults}")
    del mo
    bp = MC.tree_map(lambda t: t.to(torch.bfloat16), mp)
    del mp
    serve_moe = sharded_serve_case(
        m, mesh, bp, toks[:1, :SHARD_MOE_PROMPT], SHARD_MOE_DECODE,
        SHARD_MOE_PROMPT + SHARD_MOE_DECODE + 1)
    faults = sharded_faults(serve_moe["diffs"])
    check(not faults, f"sharded {MOE_ARCH} (2 layers) prefill / decode != "
          f"the one-device steps: {faults}")
    del bp
    ops = {k: device_totals(r) for k, r in serve_moe["rows"].items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"sharded {MOE_ARCH}: {m.cfg.name} cut to {m.cfg.n_layers} layers "
          f"(one dense, one MoE layer of {m.cfg.n_experts} experts top-"
          f"{m.cfg.top_k}, "
          f"MLA) on the (1, 1) DeviceMesh, {str(MC.COMPUTE_DTYPE)[6:]} "
          f"compute | train step at "
          f"batch {SHARD_MOE_BATCH} x seq {SHARD_MOE_SEQ} (f32 master "
          f"weights, deterministic algorithms): loss "
          f"{train_moe['loss']:.6f}, largest difference {train_moe['diffs']}"
          f" | train host ms in turns {train_moe['ms']} | prefill "
          f"{SHARD_MOE_PROMPT} tokens and {SHARD_MOE_DECODE} decode steps: "
          f"largest difference {serve_moe['diffs']} | decode host ms a token"
          f" in turns {serve_moe['ms']} | one decode step profiled: one "
          f"device {busy(ops['one'], serve_moe['ms']['one'][0])}, mesh "
          f"{busy(ops['mesh'], serve_moe['ms']['mesh'][0])} | held before "
          f"the phase {held:.2f} GB, peak over it {peak:.2f} GB | phase 15 "
          f"{time.monotonic() - t15:.0f} s | {card}", flush=True)


# -- phase 7's filters, built on the host beside phases 3-6 -----------------
F_BUILDS = ("bloom", "xor", "exact", "chained", "cascade")


def build_bank_filter(name: str) -> tuple:
    """One filter of phase 7's bank (``benchmarks/filter_service.py``'s
    recipe, phase 7's seeded keys) -> (the filter, its build's host
    seconds, ``time.monotonic()`` at its end: one clock for every process
    of the host)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import hashing as H
    from repro_torch.core.bloom import BloomFilter
    from repro_torch.core.bloomier import ExactBloomier, XorFilter
    from repro_torch.core.chained import ChainedFilterAnd, ChainedFilterCascade
    fkeys = H.random_keys(F_POS * (F_LAMBDA + 1) + F_QUERIES, seed=42)
    pos, neg = fkeys[:F_POS], fkeys[F_POS:F_POS * (F_LAMBDA + 1)]
    t = time.monotonic()
    f = {"bloom": lambda: BloomFilter.build(pos, 0.01, seed=11),
         "xor": lambda: XorFilter.build(pos, 8, seed=12),
         "exact": lambda: ExactBloomier.build(pos[:F_POS // 2], neg[:F_POS],
                                              seed=13),
         "chained": lambda: ChainedFilterAnd.build(pos, neg, seed=14),
         "cascade": lambda: ChainedFilterCascade.build(pos, neg, seed=3),
         }[name]()
    return f, time.monotonic() - t, time.monotonic()


def start_filter_builds() -> tuple:
    """``build_bank_filter`` of each of F_BUILDS in a process of its own
    (spawned: no CUDA state is inherited) -> (the pool, {name: future})."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        len(F_BUILDS), mp_context=multiprocessing.get_context("spawn"))
    return pool, {n: pool.submit(build_bank_filter, n) for n in F_BUILDS}


# -- phase 16: the step trace beside the card's real step -----------------
# the cells traced in a subprocess of their own (a fake process group and
# phase 14's NCCL group cannot share one process): llama3.2-1b FULL on
# (1, 1) at phase 11's train shape and phase 10's decode (one request, a
# 256-token cache), then its train_4k and decode_32k at 16x16; the
# subprocess must end within TRACE_LIMIT_S of its start
TRACE_LIMIT_S = 120
TRACE_CELLS = (("train_1x1", "train_4k", (1, 1), TRAIN_BATCH, TRAIN_SEQ),
               ("decode_1x1", "decode_32k", (1, 1), 1, LM_MAX_LEN),
               ("train_4k_16x16", "train_4k", (16, 16), None, None),
               ("decode_32k_16x16", "decode_32k", (16, 16), None, None))


def resized_cell(cell, batch: int, seq: int):
    """``cell`` (a train or decode cell) at ``batch`` x ``seq``: its
    batch's tokens and labels, or its cache (``seq`` long) and tokens,
    made again with their specs; params and AdamW state as they are."""
    import torch
    from repro_torch.configs.base import Shape
    from repro_torch.launch import steps as S
    from repro_torch.sharding.rules import DEFAULT_RULES, tree_specs
    mesh, m = cell.mesh, cell.model

    def tok(b, t):
        return torch.empty((b, t), dtype=torch.int32, device="meta")
    if cell.kind == "train":
        batch_tree = {"tokens": tok(batch, seq), "labels": tok(batch, seq)}
        args = cell.abstract_args[:2] + (batch_tree,)
        specs = cell.arg_specs[:2] + (S.batch_specs(mesh, DEFAULT_RULES,
                                                    batch_tree),)
    else:
        cache, tokens = m.cache_specs(batch, seq), tok(batch, 1)
        args = (cell.abstract_args[0], cache, tokens)
        specs = (cell.arg_specs[0],
                 tree_specs(mesh, DEFAULT_RULES, m.cache_axes(), cache),
                 S.batch_specs(mesh, DEFAULT_RULES, tokens))
    return replace(cell, abstract_args=args, arg_specs=specs,
                   shape=Shape(cell.shape_name, cell.kind, seq, batch))


def trace_cells() -> list[dict]:
    """Phase 16's traces (``TRACE_CELLS``), on the host: each cell's
    step traced over a fake group of its mesh's size (``launch.dryrun.
    traced_cell``, its (1, 1) cells resized by ``resized_cell``) -> one
    record a cell: argument bytes by group, the liveness peak, flops and
    bytes per device, collective bytes by kind, ops, seconds."""
    from repro_torch.launch import dryrun, hbm_model, op_trace
    from repro_torch.launch.mesh import MeshShape
    out = []
    for tag, shape_name, dims, batch, seq in TRACE_CELLS:
        mesh = MeshShape(dims, ("data", "model"))
        wrap = None if batch is None else (
            lambda c, b=batch, t=seq: resized_cell(c, b, t))
        cell, tr = dryrun.traced_cell(LM_ARCH, shape_name, mesh, wrap=wrap)
        out.append({"tag": tag, "shape": shape_name, "mesh": list(dims),
                    "batch": batch or cell.shape.batch,
                    "seq": seq or cell.shape.seq,
                    "arg_bytes": tr.arg_bytes,
                    "liveness": hbm_model.peak_hbm_bytes(tr),
                    "top": [list(r) for r in hbm_model.peak_report(tr, 3)],
                    "flops": tr.flops, "bytes": tr.bytes_accessed,
                    "collectives": op_trace.collective_summary(tr),
                    "ops": tr.n_ops, "trace_s": tr.seconds})
    return out


def start_traces(fn: str = "trace_cells") -> subprocess.Popen:
    """Start ``chip_smoke.<fn>()`` (``trace_cells``, or phase 17's
    ``remat_traces``) in a subprocess (a fake process group cannot share
    phase 14's process), its output in temporary files; it runs on the
    host while the card's phases run, and is killed at exit if it has not
    ended."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")]
                                       if p])
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, time, chip_smoke; print(json."
         f"dumps({{'cells': chip_smoke.{fn}(), 't_end': time."
         "monotonic()}))"],
        cwd=ROOT, env=env, stdout=out, stderr=err, text=True)
    proc.files = (out, err)
    proc.t0 = time.monotonic()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def trace_results(proc: subprocess.Popen, limit: float, what: str) -> tuple:
    """The result of a ``start_traces`` subprocess, which must have ended
    within ``limit`` s of its start (by its own end time; one still
    running is waited for up to that deadline, then killed; any failure
    fails the run) -> (its JSON result, its seconds, the seconds waited
    here)."""
    t = time.monotonic()
    try:
        proc.wait(timeout=max(1.0, limit - (t - proc.t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"{what} did not end in {limit} s")
    waited = time.monotonic() - t
    out, err = (f.seek(0) or f.read() for f in proc.files)
    check(proc.returncode == 0,
          f"{what} failed (exit {proc.returncode}): {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    took = res["t_end"] - proc.t0
    check(took <= limit, f"{what} took {took:.1f} s, over {limit} s")
    return res, took, waited


def trace_phase(proc: subprocess.Popen, train_arg_bytes: dict,
                train_peak_gb: float, *, card: str = "",
                t_start: float | None = None) -> list[dict]:
    """Phase 16: the records of ``start_traces``' subprocess, which must
    have ended within TRACE_LIMIT_S of its start (by its own end time; a
    subprocess still running is waited for up to that deadline, then
    killed; any failure fails the run); the (1, 1) train trace's params
    and AdamW bytes held to ``train_arg_bytes`` (phase 11's allocation)
    exactly; its modelled peak (args + liveness) printed beside phase
    11's measured peak ``train_peak_gb``, with their ratio. ``t_start``:
    the run's start, to print when the traces ran. -> the records."""
    res, took, waited = trace_results(proc, TRACE_LIMIT_S, "the step traces")
    recs = res["cells"]
    t_start = proc.t0 if t_start is None else t_start
    for r in recs:
        coll = r["collectives"]
        args = sum(r["arg_bytes"].values())
        print(f"trace: {LM_ARCH} FULL {r['shape']} on {tuple(r['mesh'])} "
              f"at batch {r['batch']} x seq {r['seq']}: {r['ops']} ops "
              f"traced in {r['trace_s']:.1f} s, flops/dev {r['flops']:.4g}, "
              f"bytes/dev {r['bytes']:.4g}, collectives {coll['count']} "
              f"moving {sum(coll[k] for k in coll if k != 'count')} B "
              f"({', '.join(f'{k} {v}' for k, v in coll.items() if v and k != 'count')}), "
              f"args {args} B + liveness {r['liveness']} B = "
              f"{(args + r['liveness']) / 1e9:.3f} GB; largest live at the "
              f"peak {[(b, n) for b, n, _ in r['top']]} | {card}", flush=True)
    one = recs[0]
    got = {k: one["arg_bytes"][k] for k in ("params", "opt")}
    check(got == train_arg_bytes,
          f"traced (1, 1) train args {got} B != phase 11's allocation "
          f"{train_arg_bytes} B")
    modelled = (sum(one["arg_bytes"].values()) + one["liveness"]) / 1e9
    print(f"trace: the (1, 1) train step's params {got['params']} B and "
          f"AdamW {got['opt']} B == phase 11's allocation; modelled peak "
          f"(args + liveness) {modelled:.2f} GB beside phase 11's measured "
          f"peak {train_peak_gb:.2f} GB (max_memory_allocated over its 8 "
          f"steps): ratio {modelled / train_peak_gb:.3f} | the traces' "
          f"process ran from {proc.t0 - t_start:.1f} s to "
          f"{res['t_end'] - t_start:.1f} s of the run ({took:.1f} s, limit "
          f"{TRACE_LIMIT_S} s), phase 16 waited {waited:.1f} s for it | "
          f"{card}", flush=True)
    return recs


# -- phase 17: remat, each layer recomputed in the loss's backward --------
# zamba2-2.7b FULL (54 Mamba2 layers, the shared block after every 6th)
# trained at phase 11's shape: build_trainer builds it with remat, as the
# reference's build_cell builds its FULL cells; and rwkv6-7b at FULL widths
# cut to REMAT_RWKV_LAYERS, the depth at which its step without remat still
# fits the card (the step trace models 66.3 GB for 2 layers without remat,
# some 27 GB more a layer), one step with remat and one without
REMAT_ARCH, REMAT_STEPS = "zamba2-2.7b", 3
REMAT_RWKV, REMAT_RWKV_LAYERS = "rwkv6-7b", 2
# zamba2's train step traced on the host with remat and without, in a
# subprocess of its own started beside phase 16's (the two trace ~1.2M
# and ~0.8M ops, 283-393 s on the card's host: over phase 16's
# TRACE_LIMIT_S), which must end within REMAT_TRACE_LIMIT_S of its start
# (phase 17 starts 700-950 s into the run)
REMAT_TRACE_LIMIT_S = 900


def remat_traces(*, smoke: bool = False, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> list[dict]:
    """Phase 17's traces, on the host: zamba2-2.7b FULL's (with ``smoke``,
    its smoke config's) train step as ``build_trainer`` builds it, on
    (1, 1) at ``batch`` x ``seq``, with remat and without, each traced
    over a fake group (``launch.dryrun.traced_cell``, resized by
    ``resized_cell``) -> one record each: remat, argument bytes by group,
    the liveness peak, its largest values, ops, seconds."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, hbm_model
    from repro_torch.launch.mesh import MeshShape
    out = []
    for remat in (True, False):
        m = get_arch(REMAT_ARCH).model(smoke=smoke, remat=remat,
                                       q_chunk=512)
        _, tr = dryrun.traced_cell(
            REMAT_ARCH, "train_4k", MeshShape((1, 1), ("data", "model")),
            smoke=smoke, model=m, wrap=lambda c: resized_cell(c, batch, seq))
        out.append({"remat": remat, "arg_bytes": tr.arg_bytes,
                    "liveness": hbm_model.peak_hbm_bytes(tr),
                    "top": [list(r) for r in hbm_model.peak_report(tr, 3)],
                    "ops": tr.n_ops, "trace_s": tr.seconds})
    return out


def remat_pair(device, *, n_layers: int = REMAT_RWKV_LAYERS,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
               smoke: bool = False, seed: int = 0) -> dict:
    """rwkv6-7b at its FULL widths cut to ``n_layers`` (the smoke config
    with ``smoke``), f32 weights from a seed on ``device`` (the zero- and
    one-initialised leaves drawn as phase 13 draws them), one batch of
    ``batch`` x ``seq`` seeded tokens: a train step's loss and gradients
    (forward and backward at the compute dtype) with remat, without it,
    and with it again (its host time warm), under torch's deterministic
    algorithms -> the losses, whether the plain step's and the second
    remat step's loss and every gradient leaf equal the first remat
    step's bit for bit (the leaves that differ, the largest difference),
    host ms of each step, and on the card the peak memory each step
    allocated above what was allocated before it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import common as MC
    base = get_arch(REMAT_RWKV).model(smoke=smoke)
    cfg = replace(base.cfg, n_layers=n_layers)
    specs = type(base)(cfg).param_specs()
    params = draw_state_leaves(specs, MC.init_from_specs(
        specs, torch.Generator(device).manual_seed(seed), device),
        SSM_STATE_SEED)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq + 1)).astype(np.int32)).to(device)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cuda = torch.device(device).type == "cuda"
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (True, False, True):
            m = type(base)(cfg, chunk=base.chunk, remat=remat)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            t = time.perf_counter()
            loss, grads = loss_and_grads(m, params, b)
            if cuda:
                torch.cuda.synchronize()
            runs.append({
                "loss": loss, "grads": MC.tree_leaves(grads),
                "ms": (time.perf_counter() - t) * 1e3,
                "peak_gb": ((torch.cuda.max_memory_allocated() - held) / 1e9
                            if cuda else None)})
    finally:
        torch.use_deterministic_algorithms(was)
    first = runs[0]
    differ = [(j, i) for j, r in enumerate(runs[1:], 1)
              for i, (a, g) in enumerate(zip(first["grads"], r["grads"]))
              if not torch.equal(a, g)]
    return {"layers": n_layers, "batch": batch, "seq": seq,
            "losses": [float(r["loss"]) for r in runs],
            "loss_equal": all(torch.equal(first["loss"], r["loss"])
                              for r in runs[1:]),
            "leaves": len(first["grads"]), "differ": differ,
            "max_diff": max((float((first["grads"][i] - runs[j]["grads"][i])
                                   .abs().max()) for j, i in differ),
                            default=0.0),
            "ms": [r["ms"] for r in runs],
            "peak_gb": [r["peak_gb"] for r in runs]}


def remat_train_faults(losses: list, again: float) -> list[str]:
    """Phase 17's train run: every loss finite, and the loss of step 0's
    batch after the last step (``again``) below step 0's."""
    if not all(math.isfinite(x) for x in losses + [again]):
        return [f"a loss is not finite: {losses}, then {again}"]
    if not again < losses[0]:
        return [f"the loss of step 0's batch did not fall: {losses[0]} -> "
                f"{again}"]
    return []


def remat_faults(pair: dict) -> list[str]:
    """What phase 17 holds ``remat_pair``'s result to: the losses and
    every gradient leaf equal bit for bit, and (on the card) each remat
    step's peak below the plain step's."""
    faults = []
    if not pair["loss_equal"]:
        faults.append(f"losses {pair['losses']} differ")
    if pair["differ"]:
        faults.append(f"gradient leaves (step, leaf) {pair['differ']} of "
                      f"{pair['leaves']} differ, by up to "
                      f"{pair['max_diff']}")
    on, off, again = pair["peak_gb"]
    if on is not None and not max(on, again) < off:
        faults.append(f"the remat steps' peaks {on:.2f}, {again:.2f} GB "
                      f"are not below the plain step's {off:.2f} GB")
    return faults


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script runs only on a GPU")
    # cuBLAS is deterministic on one stream with a fixed workspace; phase
    # 11 turns on torch's deterministic algorithms, which ask for it to be
    # named before the first cuBLAS call (32 MiB, torch's default on sm_90)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import hashing as H, theory
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
        from repro_torch.configs import get_arch
        from repro_torch.configs.base import draw_modality_inputs
        from repro_torch.core.learned import (LearnedFilter,
                                              synth_url_dataset,
                                              train_score_model)
        from repro_torch.data.pipeline import SyntheticLMData
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.models import common as MC
        from repro_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
        from repro_torch.query import Catalog, Member, Pipeline, RangeFence
        from repro_torch.serving.engine import (payload_to_device,
                                                payload_to_host)
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
    # the host work of phases 7, 16 and 17, started now beside the card's
    # phases: phase 7's five filter builds, phase 16's step traces and
    # phase 17's traces of zamba2's train step
    t_fstart = time.monotonic() - t_start
    f_pool, f_builds = start_filter_builds()
    traces = start_traces()
    remat_proc = start_traces("remat_traces")

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
    # the five builds ran in processes of their own beside phases 3-6
    # (start_filter_builds): the host wait here is what is left of them
    t0 = time.monotonic()
    fkeys = H.random_keys(F_POS * (F_LAMBDA + 1) + F_QUERIES, seed=42)
    pos, neg = fkeys[:F_POS], fkeys[F_POS:F_POS * (F_LAMBDA + 1)]
    queries = np.random.default_rng(7).choice(fkeys, size=F_QUERIES,
                                              replace=True)
    built = {n: f.result() for n, f in f_builds.items()}
    f_pool.shutdown()
    t_fwait = time.monotonic() - t0
    builds = {n: s for n, (_, s, _) in built.items()}
    t_fend = max(e for _, _, e in built.values()) - t_start
    filters = [built[n][0] for n in F_BUILDS]
    fbloom, fxor, fexact, fchained, fcascade = filters
    t = time.monotonic()
    svc = FilterService(filters, device=dev)
    fstate = svc.state                      # the bank as built, for times
    t_fsvc = time.monotonic() - t
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

    def bank_rule(n_keys: int, words) -> dict:
        """The paths the filters bank's probe of ``n_keys`` keys over the
        bank ``words`` takes, by each kernel's ``onchip_reason``."""
        return {
            "bloom_probe": rule_paths([((flay0.m_bits, flay0.k, flay0.seed,
                                         flay0.offset),)], n_keys, words),
            "cascade_probe": rule_paths([flay4.probe_params()], n_keys,
                                        words),
            **{k: bloomier_rule(g, n_keys) for k, g in f_geos.items()}}
    filter_rule = bank_rule(F_QUERIES, fstate.tables)
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
          f"{fchained.n_false_pos} stage-2 whitelists | host build in five "
          f"processes from {t_fstart:.1f} s to {t_fend:.1f} s of the run, "
          f"beside phases 3-6 (which ended at {t0 - t_start:.1f} s), on "
          f"{len(os.sched_getaffinity(0))} of the host's {os.cpu_count()} "
          f"cores: seconds each (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                             builds.items())
          + f"); phase 7 waited {t_fwait:.1f} s for them, then packed the "
          f"bank in {t_fsvc:.1f} s | probe of {F_QUERIES} queries: launches {filter_launches}, "
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
        return device_totals(device_rows(fn))

    def device_top(rows, k: int = 6) -> str:
        """The ``k`` of ``device_rows``' rows with the most device time."""
        if isinstance(rows, str):
            return rows
        return "; ".join(f"{name[:48]} {us / 1e3:.3f} ms x{n}"
                         for us, n, name in sorted(rows, reverse=True)[:k])

    def lsm_launches() -> dict:
        return {"lsm_probe": lsm_probe.launches, **path_counts()}

    def bloom_launches() -> dict:
        return {"bloom_probe": bloom_probe.launches,
                **bloom_paths(bloom_probe)}

    def serve_launches(cell) -> list[dict]:
        """Each run of ``serve_cell``'s ``bloom_probe`` launches, checked:
        one a tier, by the path ``bloom_onchip.onchip_reason`` names for
        the run's keys over the engine's tier bank."""
        pstate = cell["engine"].prefix_cache._service.state
        tier_layouts = [((lay.m_bits, lay.k, lay.seed, lay.offset),)
                        for lay in pstate.bank.layouts]
        out = []
        for launches, n_keys in ([(r["launches"], len(r["outputs"]))
                                  for r in cell["runs"]]
                                 + [(cell["fresh_launches"], LM_PROMPTS)]):
            rule = rule_paths(tier_layouts, n_keys, pstate.tables)
            check(launches == {"bloom_probe": len(PC_TIERS), **rule},
                  f"serve cell: bloom_probe launched {launches} in a run, "
                  f"the rule says {rule}")
            out.append(launches)
        return out

    def twin_cell(vocab: int, n_requests: int = LM_REQUESTS) -> dict:
        """``serve_cell`` on the CPU with a 1-layer, 64-wide dense model of
        ``vocab``: the same request stream, so the same prefix-cache
        stats."""
        twin_model = TransformerLM(TransformerConfig(
            name="twin", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=vocab, head_dim=16))
        was = MC.COMPUTE_DTYPE
        MC.set_compute_dtype(torch.float32)
        try:
            return serve_cell(twin_model, MC.init_from_specs(
                twin_model.param_specs(), torch.Generator().manual_seed(0),
                "cpu"), "cpu", n_requests=n_requests)
        finally:
            MC.set_compute_dtype(was)

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

    # -- 10. the LM server at full width and the §5.5 learned filter ---------
    # (a) ServeEngine over llama3.2-1b FULL: f32 weights from a seed on
    # the card, bf16 compute, the prefix cache's tier bank on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = get_arch(LM_ARCH).model()
    cfg = model.cfg
    t = time.perf_counter()
    params = MC.init_from_specs(model.param_specs(),
                                torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(a.numel() for a in MC.tree_leaves(params))
    # the reference's param_count leaves out the final norm's gains
    check(n_params == cfg.param_count() + cfg.d_model,
          f"llama3.2-1b FULL has {n_params} parameters")
    cell = serve_cell(model, params, dev, reset=reset_counts,
                      read=bloom_launches)
    eng = cell["engine"]
    twin = twin_cell(cfg.vocab)
    faults = serve_faults(cell, twin)
    check(not faults, f"serve cell: {faults}")
    pc10 = serve_launches(cell)
    # decode against teacher forcing, over the engine's first prompt
    cp = eng.compute_params
    prompt0 = cell["prompts"][0]
    gen, tf_errs, _ = teacher_forcing(model, cp, prompt0, LM_MAX_NEW,
                                   LM_MAX_LEN, dev)
    check(gen == cell["runs"][0]["outputs"][0],
          "teacher forcing's greedy tokens != the engine's")
    tf_rel = max(e for e, _ in tf_errs)
    check(tf_rel <= TF_REL_BF16, f"decode != teacher forcing at bf16: "
          f"relative L2 {tf_rel} > {TF_REL_BF16}")
    # host-clock times, a warm call first: prefill of one 64-token
    # prompt, one decode step over the bf16 copy the engine holds and over
    # the f32 weights (the reference's per-einsum casts, run eagerly)
    tok0 = torch.from_numpy(prompt0[None]).to(dev)
    step = torch.tensor([[gen[0]]], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: model.prefill(cp, {"tokens": tok0},
                                                   LM_MAX_LEN), reps=5)
        out0 = model.prefill(cp, {"tokens": tok0}, LM_MAX_LEN)
        cache0 = out0[1]
        decode_ms = host_ms(lambda: model.decode_step(cp, cache0, step),
                            reps=20)
        decode_f32_ms = host_ms(lambda: model.decode_step(params, cache0,
                                                          step), reps=20)
        decode_rows = device_rows(lambda: model.decode_step(cp, cache0,
                                                            step))
        decode_f32_prof = device_profile(
            lambda: model.decode_step(params, cache0, step))
        prefill_prof = device_profile(lambda: model.prefill(
            cp, {"tokens": tok0}, LM_MAX_LEN))
        to_host_ms = host_ms(lambda: payload_to_host(out0), reps=5)
        host0 = payload_to_host(out0)
        upload_ms = host_ms(lambda: payload_to_device(host0, dev), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kv_bytes = sum(a.numel() * a.element_size() for layer in cache0["layers"]
                   for a in layer.values())
    weights = n_params - params["embed"].numel()
    bound_f32_ms = 4 * weights / HBM_BYTES_PER_S * 1e3
    bound_bf16_ms = 2 * weights / HBM_BYTES_PER_S * 1e3
    r1, r2 = cell["runs"]
    print(f"serve: {LM_ARCH} FULL ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} f32 parameters from "
          f"a seed on the card in {init_s:.1f} s), bf16 compute, max_len "
          f"{LM_MAX_LEN}, tiers {[t[1] for t in PC_TIERS]} | {LM_REQUESTS} "
          f"requests over {LM_PROMPTS} {LM_PROMPT_LEN}-token prompts, "
          f"max_new {LM_MAX_NEW}, twice, then a fresh engine: outputs equal "
          f"per prompt, across runs and to the fresh engine's; stats == the "
          f"CPU twin's: run 1 {json.dumps(r1['stats'])}, run 2 "
          f"{json.dumps(r2['stats'])} | bloom_probe launches a run {pc10} | "
          f"decode == teacher forcing over {len(tf_errs)} steps: relative "
          f"L2 max {tf_rel:.4g} (<= {TF_REL_BF16}), max |diff| "
          f"{max(e for _, e in tf_errs):.4g} | {card}", flush=True)
    print(f"serve times (host clock, a warm call first): prefill "
          f"{prefill_ms:.2f} ms per {LM_PROMPT_LEN}-token request; decode "
          f"{decode_ms:.3f} ms per token over the engine's bf16 weights, "
          f"{decode_f32_ms:.3f} ms over the f32 weights cast in every "
          f"matmul; one step profiled: bf16 weights "
          f"{busy(device_totals(decode_rows), decode_ms)}; f32 weights "
          f"{busy(decode_f32_prof, decode_f32_ms)}; the bf16 step's top "
          f"device operations: {device_top(decode_rows)}; prefill "
          f"{busy(prefill_prof, prefill_ms)}; decode bound "
          f"{bound_f32_ms:.3f} ms (f32 weights but the "
          f"embedding table, {4 * weights / 1e9:.3f} GB at 3.35 TB/s), "
          f"{bound_bf16_ms:.3f} ms at bf16 | run 1 {r1['tokens']} tokens in "
          f"{r1['s'] * 1e3:.0f} ms ({r1['tokens'] / r1['s']:.1f} tokens/s), "
          f"run 2 (all hits) {r2['tokens']} in {r2['s'] * 1e3:.0f} ms "
          f"({r2['tokens'] / r2['s']:.1f} tokens/s) | KV cache "
          f"{kv_bytes} B a request ({kv_bytes // LM_MAX_LEN} B a token at "
          f"bf16) | payload host copy {to_host_ms:.2f} ms an insert, upload "
          f"{upload_ms:.2f} ms a hit | peak device memory allocated in "
          f"this phase {peak_gb:.2f} GB (earlier phases' buffers included) "
          f"| {card}", flush=True)
    del params, cp, eng, cell, out0, cache0
    # (b) the same model cut to 2 layers at f32 (TF32 off): the card
    # against the port on the CPU, from the same numpy weights
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    small = TransformerLM(replace(cfg, n_layers=2))
    t = time.perf_counter()
    np_params = numpy_params(small.param_specs(), seed=1)
    np_s = time.perf_counter() - t
    forced = np.random.default_rng(9).integers(0, cfg.vocab, 4).tolist()
    t = time.perf_counter()
    on_card = forced_logits(small, MC.params_from_numpy(np_params, dev),
                            prompt0, forced, LM_MAX_LEN, dev)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    on_cpu = forced_logits(small, MC.params_from_numpy(np_params, "cpu"),
                           prompt0, forced, LM_MAX_LEN, "cpu")
    cpu_s = time.perf_counter() - t
    MC.set_compute_dtype(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del np_params
    rel = [float(np.abs(a - b).max() / np.abs(b).max())
           for a, b in zip(on_card, on_cpu)]
    check(max(rel) <= CARD_CPU_REL, f"card != CPU at 2 layers, f32: "
          f"relative {rel} > {CARD_CPU_REL}")
    print(f"serve card vs CPU: {LM_ARCH} FULL widths cut to 2 layers, f32, "
          f"TF32 off, numpy weights ({np_s:.1f} s to make): prefill + "
          f"{len(forced)} decode steps, max |card - cpu| / max |cpu| per "
          f"step {[f'{r:.3g}' for r in rel]} (<= {CARD_CPU_REL}) | card "
          f"{card_s:.1f} s, CPU {cpu_s:.1f} s (uploads included) | {card}",
          flush=True)
    # (c) the §5.5 learned filter: benchmarks/learned_filter.py's
    # full-scale recipe, then one build of 1,000,000 keys
    rows = learned_cell(30_000, (0.1, 0.3, 0.5, 1.0), dev)
    faults = learned_faults(rows)
    check(not faults, f"learned filter: {faults}")
    cells10 = {}
    for r in rows:
        cells10.setdefault(r["frac"], {})[r["kind"]] = (r["bits"],
                                                        round(r["fpr"], 4))
    print(f"learned n 30000 (seed 5 / 11, model_fpr 0.01), backup bits / "
          f"fpr by train frac: {json.dumps(cells10)}; 0 false negatives; "
          f"chained fpr <= {LEARNED_FPR_MAX}, bits within "
          f"{LEARNED_BITS_REL:.0%} of the reference's "
          f"{ {k[1]: v[1] for k, v in LEARNED_REF.items() if k[0] == 30000} } "
          f"and below bloom | builds {sum(r['build_s'] for r in rows):.1f} s "
          f"host clock for {len(rows)} | {card}", flush=True)
    keys1m, feats1m, labels1m = synth_url_dataset(500_000, 500_000, seed=5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    train_score_model(feats1m, labels1m, seed=11, device=dev)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t) * 1e3
    big = {}
    for kind in ("chained", "bloom"):
        t = time.perf_counter()
        lf = LearnedFilter.build(keys1m, feats1m, labels1m, backup_kind=kind,
                                 model_fpr=0.01, seed=11, device=dev)
        build_s = time.perf_counter() - t
        lf.query(keys1m[:1024], feats1m[:1024])              # warm
        t = time.perf_counter()
        got = lf.query(keys1m, feats1m)
        query_ms = (time.perf_counter() - t) * 1e3
        fn = int((~got[labels1m]).sum())
        check(fn == 0, f"learned 1M {kind}: {fn} false negatives")
        big[kind] = {"bits": lf.filter_bits,
                     "fpr": float(got[~labels1m].mean()),
                     "build_s": round(build_s, 2),
                     "query_ms": round(query_ms, 1)}
    check(big["chained"]["fpr"] <= LEARNED_FPR_MAX
          and big["chained"]["bits"] < big["bloom"]["bits"],
          f"learned 1M: {big}")
    print(f"learned 1M keys (500k / 500k, dim 16, "
          f"{feats1m.nbytes / 2 ** 20:.0f} MiB of features): training "
          f"{train_ms:.0f} ms on the card (400 full-batch Adam steps) | "
          f"{json.dumps(big)} | chained saves "
          f"{1 - big['chained']['bits'] / big['bloom']['bits']:.1%} of the "
          f"bloom backup's bits; 0 false negatives | {card} | total "
          f"{time.monotonic() - t_start:.0f} s", flush=True)

    # -- 11. the training path: llama3.2-1b FULL trains on the card --------
    # (a) build_trainer at full width, bf16 compute over f32 master
    # weights, seq 4,096, batch 2: 8 calls of its step_fn
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run = train_run(dev, smoke=False, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                    n_steps=TRAIN_STEPS)
    train_s = time.perf_counter() - t
    faults = train_faults(run["losses"])
    check(not faults, f"train at full width: {faults}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_peak_gb = peak_gb                # phase 16 models this peak
    model, state = run["model"], run["state"]
    cfg = model.cfg
    # what the params and AdamW state hold on the card (phase 14's census
    # of this cell on a (1, 1) mesh must count the same bytes)
    train_arg_bytes = {k: sum(a.numel() * a.element_size()
                              for a in MC.tree_leaves(state[k]))
                       for k in ("params", "opt")}
    n_params = sum(a.numel() for a in MC.tree_leaves(state["params"]))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    step_ms = statistics.median(run["ms"][1:])
    mm_flops, attn_flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    flop_ms = 3 * (mm_flops + attn_flops) / BF16_FLOPS_PER_S * 1e3
    attn_f32_ms = 3 * attn_flops / F32_FLOPS_PER_S * 1e3
    adamw_ms = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    b0 = SyntheticLMData(run["data"].cfg).batch(0)
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in b0.items()}
    train_step = make_train_step(model, AdamWConfig())
    rows = device_rows(lambda: train_step(state["params"], state["opt"], b0))
    print(f"train: {LM_ARCH} FULL ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} f32 parameters from a "
          f"seed on the card) through launch/train.build_trainer, remat, "
          f"q_chunk 512, bf16 compute, AdamW f32 | seq {TRAIN_SEQ}, batch "
          f"{TRAIN_BATCH} (train_4k's 256 cut to {TRAIN_BATCH}), "
          f"{TRAIN_STEPS} steps in {train_s:.1f} s: loss "
          f"{[round(x, 4) for x in run['losses']]} | host ms a step "
          f"{[round(x, 1) for x in run['ms']]} (step 0 warms up), median of "
          f"steps 1-{TRAIN_STEPS - 1} {step_ms:.1f} ms = "
          f"{tokens / step_ms * 1e3:.0f} tokens/s | peak device memory "
          f"allocated {peak_gb:.2f} GB | {card}", flush=True)
    print(f"train step profiled: {busy(device_totals(rows), step_ms)}; top "
          f"device operations: {device_top(rows, 8)} | bound: "
          f"{3 * (mm_flops + attn_flops) / 1e12:.1f} TFLOP a step (forward "
          f"and backward, the remat recompute not counted; attention "
          f"{3 * attn_flops / 1e12:.1f} of it) over {BF16_FLOPS_PER_S / 1e12:.0f}"
          f" TFLOP/s bf16 = {flop_ms:.1f} ms; the attention's f32 products "
          f"alone over {F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s = "
          f"{attn_f32_ms:.1f} ms; AdamW reads p, g, m, v and writes p, m, v "
          f"(28 B a parameter, {28 * n_params / 1e9:.1f} GB) over 3.35 TB/s "
          f"= {adamw_ms:.2f} ms | {card}", flush=True)
    del run, state, train_step, rows, b0
    # (b) the same widths cut to 2 layers at f32 (TF32 off): one train
    # step on the card against the port on the CPU, from the same numpy
    # params and a carried AdamW state
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    small = TransformerLM(replace(cfg, n_layers=2), remat=True, q_chunk=512)
    np_params = numpy_params(small.param_specs(), seed=1)
    np_opt = carried_opt_state(np_params, step=10)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, (1, TRAIN_CPU_SEQ + 1))
    t = time.perf_counter()
    on_card = train_step_parts(small, np_params, np_opt, toks, dev)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    on_cpu = train_step_parts(small, np_params, np_opt, toks, "cpu")
    cpu_s = time.perf_counter() - t
    MC.set_compute_dtype(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del np_params, np_opt
    loss_rel = abs(on_card[0] - on_cpu[0]) / abs(on_cpu[0])
    grad_rel = max(rel_l2(a, b) for a, b in zip(on_card[1], on_cpu[1]))
    param_rel = max(rel_l2(a, b) for a, b in zip(on_card[2], on_cpu[2]))
    check(loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL
          and param_rel <= TRAIN_PARAM_REL,
          f"train step, card != CPU at 2 layers, f32: loss {loss_rel}, "
          f"gradients {grad_rel}, params {param_rel}")
    print(f"train card vs CPU: {LM_ARCH} FULL widths cut to 2 layers, f32, "
          f"TF32 off, numpy params and AdamW state (step 10), batch 1, seq "
          f"{TRAIN_CPU_SEQ}: loss {on_card[0]:.6f} vs {on_cpu[0]:.6f} "
          f"(relative {loss_rel:.3g} <= {TRAIN_LOSS_REL}), gradient leaves "
          f"relative L2 max {grad_rel:.3g} (<= {TRAIN_GRAD_REL}), params "
          f"after AdamW max {param_rel:.3g} (<= {TRAIN_PARAM_REL}) over "
          f"{len(on_cpu[1])} leaves | card {card_s:.1f} s, CPU {cpu_s:.1f} s "
          f"(uploads included) | {card}", flush=True)
    del on_card, on_cpu, small
    # (c) the supervisor at smoke width on the card (bf16, as main runs
    # there): an injected failure resumes bit for bit, under torch's
    # deterministic algorithms (the embedding's scatter sorts its indices)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            clean = supervised_run(dev, os.path.join(tmp, "clean"))
            failed = supervised_run(dev, os.path.join(tmp, "failed"),
                                    fail_at=SUP_FAIL_AT)
            sup_s = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(False)
    faults = supervisor_faults(failed, clean)
    check(not faults, f"supervisor: {faults}")
    print(f"train supervisor: {LM_ARCH} smoke, bf16 on the card, "
          f"{SUP_STEPS} steps, a checkpoint every {SUP_SAVE_EVERY}, a "
          f"failure injected at step {SUP_FAIL_AT[0]}: restarts "
          f"{failed['res'].n_restarts}, losses after the restart == the "
          f"uninterrupted run's bit for bit ({len(failed['res'].losses)} "
          f"steps run, {clean['res'].losses[-1]:.6f} at the last) | chunk "
          f"stats skipped by the Bloom filter {failed['stat_skipped']}, "
          f"made {failed['stat_calls']} | documents dropped "
          f"{failed['n_dropped']} == a host pipeline's over the same steps "
          f"| both runs {sup_s:.1f} s | {card}", flush=True)
    # (d) the training path launches none of the seven kernels
    train_launches = {name: fn.launches for name, fn in kernels.items()}
    check(not any(train_launches.values()),
          f"the training path launched {train_launches}")
    print(f"train kernels: launches over phase 11 {json.dumps(train_launches)}"
          f" (the dedup and checkpoint filters are host numpy Bloom queries) "
          f"| {card} | total {time.monotonic() - t_start:.0f} s", flush=True)

    # -- 12. MoE and MLA: deepseek-v2-lite-16b FULL served; the other archs
    # (a) ServeEngine over deepseek-v2-lite FULL (27 layers: one dense, 26
    # of 64 routed experts top-6 plus 2 shared; MLA over a 512 + 64 latent
    # cache): bf16 weights from a seed drawn leaf by leaf on the card
    t12 = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_arch(MOE_ARCH).model()
    cfg = model.cfg
    t = time.perf_counter()
    params = bf16_params(model, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    leaves = MC.tree_leaves(params)
    n_params = sum(a.numel() for a in leaves)
    check(n_params == cfg.param_count() + cfg.d_model
          and all(a.dtype == torch.bfloat16 for a in leaves),
          f"{MOE_ARCH} FULL has {n_params} parameters "
          f"({ {str(a.dtype) for a in leaves} })")
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    cell = serve_cell(model, params, dev, reset=reset_counts,
                      read=bloom_launches)
    eng = cell["engine"]
    check(all(a is b for a, b in zip(leaves,
                                     MC.tree_leaves(eng.compute_params))),
          "the engine made a second copy of the bf16 weights")
    faults = serve_faults(cell, twin_cell(cfg.vocab))
    check(not faults, f"{MOE_ARCH} serve cell: {faults}")
    pc12 = serve_launches(cell)
    prompt0 = cell["prompts"][0]
    tok0 = torch.from_numpy(prompt0[None]).to(dev)
    with torch.inference_mode(), recorded_routes() as routed:
        model.prefill(params, {"tokens": tok0}, LM_MAX_LEN)
    used = sorted(len(set(r[r >= 0].tolist())) for r in routed)
    dropped = [int((r < 0).sum()) for r in routed]
    _, tf_errs, tf_flips = teacher_forcing(
        model, params, prompt0[:MOE_TF_PROMPT], LM_MAX_NEW, LM_MAX_LEN, dev)
    faults = tf_faults(tf_errs, tf_flips, TF_REL_BF16)
    check(not faults, f"{MOE_ARCH} decode != teacher forcing: {faults}")
    tf_rel = max([e for (e, _), f in zip(tf_errs, tf_flips) if not f],
                 default=float("nan"))
    step = torch.tensor([[cell["runs"][0]["outputs"][0][0]]],
                        dtype=torch.int32, device=dev)
    with torch.inference_mode():
        prefill_ms = host_ms(lambda: model.prefill(params, {"tokens": tok0},
                                                   LM_MAX_LEN), reps=5)
        cache0 = model.prefill(params, {"tokens": tok0}, LM_MAX_LEN)[1]
        decode_ms = host_ms(lambda: model.decode_step(params, cache0, step),
                            reps=20)
        decode_rows = device_rows(lambda: model.decode_step(params, cache0,
                                                            step))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mla_bytes = sum(a.numel() * a.element_size()
                    for layer in cache0["layers"] for a in layer.values())
    check(mla_bytes == cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim)
          * LM_MAX_LEN * 2, f"MLA cache of {mla_bytes} B")
    table = cfg.vocab * cfg.d_model        # one row of it is read a token
    bound_all_ms = 2 * (cfg.param_count() - table) / HBM_BYTES_PER_S * 1e3
    bound_active_ms = 2 * (cfg.active_param_count() - table) \
        / HBM_BYTES_PER_S * 1e3
    r1, r2 = cell["runs"]
    print(f"moe serve: {MOE_ARCH} FULL ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA kv_lora {cfg.kv_lora_rank}"
          f" + rope {cfg.qk_rope_dim}, {cfg.n_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared of d_ff "
          f"{cfg.moe_d_ff}, first {cfg.first_k_dense} dense of d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} bf16 parameters drawn "
          f"leaf by leaf on the card in {init_s:.1f} s, peak {init_gb:.2f} "
          f"GB; {cfg.active_param_count()} active a token), max_len "
          f"{LM_MAX_LEN} | {LM_REQUESTS} requests over {LM_PROMPTS} "
          f"{LM_PROMPT_LEN}-token prompts, max_new {LM_MAX_NEW}, twice, then "
          f"a fresh engine: no fault; stats == the CPU twin's: run 1 "
          f"{json.dumps(r1['stats'])}, run 2 {json.dumps(r2['stats'])} | "
          f"bloom_probe launches a run {pc12} | a {LM_PROMPT_LEN}-token "
          f"prefill's routing over {len(routed)} MoE layers: distinct "
          f"experts a layer min {used[0]}, median {used[len(used) // 2]}, max "
          f"{used[-1]} of {cfg.n_experts}; (token, choice) pairs dropped past "
          f"capacity a layer max {max(dropped)} of "
          f"{LM_PROMPT_LEN * cfg.top_k}, {sum(dropped)} in all | decode == "
          f"teacher forcing over the first {MOE_TF_PROMPT} prompt tokens, "
          f"{len(tf_errs)} steps, {sum(tf_flips)} routed otherwise (a flip "
          f"in the router); relative L2 max {tf_rel:.4g} over the others (<= "
          f"{TF_REL_BF16}), all steps {[round(e, 4) for e, _ in tf_errs]} | "
          f"{card}", flush=True)
    print(f"moe serve times (host clock, a warm call first): prefill "
          f"{prefill_ms:.2f} ms per {LM_PROMPT_LEN}-token request; decode "
          f"{decode_ms:.3f} ms a token; one step profiled: "
          f"{busy(device_totals(decode_rows), decode_ms)}; top device "
          f"operations: {device_top(decode_rows)} | decode bounds, the "
          f"weights but the embedding table read once at bf16 over 3.35 "
          f"TB/s: every expert (the reference's [E, cap] layout) "
          f"{bound_all_ms:.3f} ms, the active experts only "
          f"{bound_active_ms:.3f} ms | run 1 {r1['tokens']} tokens in "
          f"{r1['s'] * 1e3:.0f} ms ({r1['tokens'] / r1['s']:.1f} tokens/s), "
          f"run 2 (all hits) {r2['tokens']} in {r2['s'] * 1e3:.0f} ms | MLA "
          f"cache {mla_bytes} B a request ({cfg.n_layers} x ("
          f"{cfg.kv_lora_rank} + {cfg.qk_rope_dim}) x {LM_MAX_LEN} x 2 B) | "
          f"peak device memory allocated {peak_gb:.2f} GB | {card}",
          flush=True)
    del params, leaves, eng, cell, cache0
    torch.cuda.empty_cache()
    # decode against teacher forcing at f32 (TF32 off), all 27 layers:
    # f32 weights drawn from the same seed (62.8 GB, the bf16 ones freed)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    params = MC.init_from_specs(model.param_specs(),
                                torch.Generator(dev).manual_seed(0), dev)
    _, f32_errs, f32_flips = teacher_forcing(
        model, params, prompt0[:MOE_TF_PROMPT], LM_MAX_NEW, LM_MAX_LEN, dev)
    f32_gb = torch.cuda.max_memory_allocated() / 1e9
    MC.set_compute_dtype(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del params, model
    torch.cuda.empty_cache()
    faults = tf_faults(f32_errs, f32_flips, TF_REL_F32)
    check(not faults and not any(f32_flips),
          f"{MOE_ARCH} decode != teacher forcing at f32: {faults}, "
          f"{sum(f32_flips)} steps routed otherwise")
    print(f"moe teacher forcing at f32: {MOE_ARCH} FULL, TF32 off, f32 "
          f"weights from the same seed: {len(f32_errs)} decode steps over "
          f"the first {MOE_TF_PROMPT} prompt tokens, {sum(f32_flips)} routed "
          f"otherwise, relative L2 max {max(e for e, _ in f32_errs):.4g} (<= "
          f"{TF_REL_F32}), max |diff| {max(e for _, e in f32_errs):.4g} | "
          f"peak device memory allocated {f32_gb:.2f} GB | {card}",
          flush=True)
    # (b) FULL widths cut to 2 layers (one dense, one MoE) at f32, TF32
    # off: prefill and one decode step, the MoE layer's routing, and the
    # loss with its gradients (the backward through the dispatch), the
    # card against the CPU from the same numpy weights
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    small = cut_model(MOE_ARCH)
    np_params = numpy_params(small.param_specs(), seed=1)
    forced = np.random.default_rng(9).integers(0, cfg.vocab, 1).tolist()
    toks = np.random.default_rng(12).integers(0, cfg.vocab,
                                              (1, MOE_CPU_SEQ + 1))
    parts = []
    for where in (dev, "cpu"):
        t = time.perf_counter()
        with recorded_routes() as routed:
            logits = forced_logits(small, MC.params_from_numpy(
                np_params, where), prompt0, forced, LM_MAX_LEN, where)
        parts.append((logits, routed,
                      loss_grad_parts(small, np_params, toks, where),
                      time.perf_counter() - t))
    MC.set_compute_dtype(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del np_params
    (lg_card, rt_card, (loss_card, g_card), card_s), \
        (lg_cpu, rt_cpu, (loss_cpu, g_cpu), cpu_s) = parts
    rel = [float(np.abs(a - b).max() / np.abs(b).max())
           for a, b in zip(lg_card, lg_cpu)]
    routes_equal = len(rt_card) == len(rt_cpu) == 2 and all(
        np.array_equal(a, b) for a, b in zip(rt_card, rt_cpu))
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_rel = max(rel_l2(a, b) for a, b in zip(g_card, g_cpu))
    check(max(rel) <= CARD_CPU_REL and routes_equal
          and loss_rel <= MOE_LOSS_REL and grad_rel <= MOE_GRAD_REL,
          f"{MOE_ARCH} card != CPU at 2 layers, f32: logits {rel}, routes "
          f"equal {routes_equal}, loss {loss_rel}, gradients {grad_rel}")
    print(f"moe card vs CPU: {MOE_ARCH} FULL widths cut to 2 layers (one "
          f"dense, one MoE), f32, TF32 off, numpy weights: prefill + "
          f"{len(forced)} decode step, max |card - cpu| / max |cpu| "
          f"{[f'{r:.3g}' for r in rel]} (<= {CARD_CPU_REL}); the MoE "
          f"layer's expert ids and dropped pairs equal on both "
          f"({sum(r.shape[0] for r in rt_cpu)} tokens routed); loss at batch 1, seq {MOE_CPU_SEQ} {loss_card:.6f}"
          f" vs {loss_cpu:.6f} (relative {loss_rel:.3g} <= {MOE_LOSS_REL}), "
          f"gradient leaves relative L2 max {grad_rel:.3g} (<= "
          f"{MOE_GRAD_REL}) over {len(g_cpu)} leaves | card {card_s:.1f} s, "
          f"CPU {cpu_s:.1f} s | {card}", flush=True)
    del parts, g_card, g_cpu, small
    # (c) the other archs at FULL widths cut to 2 layers, bf16 on the card
    for arch_id in CUT_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = cut_cell(arch_id, dev)
        faults = tf_faults(r["errs"], r["flips"], TF_REL_BF16)
        check(not faults, f"{arch_id} decode != teacher forcing: {faults}")
        rels = [e for (e, _), f in zip(r["errs"], r["flips"]) if not f]
        print(f"cut {arch_id}: FULL widths, {r['layers']} layers, "
              f"{r['params']} bf16 parameters"
              + (f", {r['patches']} seeded patch embeddings" if r["patches"]
                 else "")
              + f" | {CUT_PROMPT}-token prefill {r['prefill_ms']:.2f} ms, "
              f"decode {r['decode_ms']:.3f} ms a token (host clock) | "
              f"{len(r['errs'])} decode steps == teacher forcing, "
              f"{sum(r['flips'])} routed otherwise, relative L2 max "
              f"{max(rels, default=float('nan')):.4g} over the others (<= "
              f"{TF_REL_BF16}) | peak device memory allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}",
              flush=True)
    print(f"moe phase: {time.monotonic() - t12:.0f} s | {card} | total "
          f"{time.monotonic() - t_start:.0f} s", flush=True)

    # -- 13. the SSM hybrid, RWKV6 and the encoder-decoder at full width ----
    # each served at FULL width and depth (bf16 weights drawn leaf by leaf)
    # by phase 10's serve_cell and serve_faults; decode against teacher
    # forcing at bf16 and at f32 (TF32 off) at full depth; the card
    # against the CPU at f32 from the same numpy weights
    t13 = time.monotonic()
    pc13 = []
    for arch_id in SSM_ARCHS:
        ta = time.monotonic()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        arch = get_arch(arch_id)
        model = arch.model()
        cfg = model.cfg
        # whisper's 1,500 frame embeddings, drawn as launch/serve.py draws
        # them (normal x 0.25 from a seed); {} for the other two
        extra = draw_modality_inputs(arch, cfg, 1, False,
                                     np.random.default_rng(5), dev)
        t = time.perf_counter()
        params = draw_state_leaves(model.param_specs(),
                                   bf16_params(model, dev), SSM_STATE_SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        leaves = MC.tree_leaves(params)
        n_params = sum(a.numel() for a in leaves)
        n_spec = sum(math.prod(sp.shape)
                     for sp in MC.tree_leaves(model.param_specs()))
        check(n_params == n_spec
              and all(a.dtype == torch.bfloat16 for a in leaves),
              f"{arch_id} FULL has {n_params} parameters, its specs "
              f"{n_spec} ({ {str(a.dtype) for a in leaves} })")
        init_gb = torch.cuda.max_memory_allocated() / 1e9
        n_req = SSM_REQUESTS
        cell = serve_cell(model, params, dev, n_requests=n_req,
                          reset=reset_counts, read=bloom_launches,
                          extra=extra)
        eng = cell["engine"]
        check(all(a is b for a, b in zip(
            leaves, MC.tree_leaves(eng.compute_params))),
            f"{arch_id}: the engine made a second copy of the bf16 weights")
        faults = serve_faults(cell, twin_cell(cfg.vocab, n_req))
        check(not faults, f"{arch_id} serve cell: {faults}")
        pc13 += serve_launches(cell)
        prompt0 = cell["prompts"][0]
        tf_bound = SSM_TF_REL_BF16.get(arch_id, TF_REL_BF16)
        gen, tf_errs, tf_flips = teacher_forcing(
            model, params, prompt0[:SSM_TF_PROMPT], LM_MAX_NEW, LM_MAX_LEN,
            dev, extra)
        faults = tf_faults(tf_errs, tf_flips, tf_bound)
        check(not faults, f"{arch_id} decode != teacher forcing at bf16: "
              f"{faults}")
        lost = lost_state_rels(model, params, prompt0[:SSM_TF_PROMPT],
                               gen[0], LM_MAX_LEN, dev, extra)
        check(lost["all"] > tf_bound,
              f"{arch_id}: a decode that lost its state reads {lost}, not "
              f"above the bound {tf_bound}")
        tok0 = torch.from_numpy(prompt0[None]).to(dev)
        step = torch.tensor([[cell["runs"][0]["outputs"][0][0]]],
                            dtype=torch.int32, device=dev)
        with torch.inference_mode():
            def prefill0():
                return model.prefill(params, {"tokens": tok0, **extra},
                                     LM_MAX_LEN)
            prefill_ms = host_ms(prefill0, reps=5)
            cache0 = prefill0()[1]
            decode_ms = host_ms(lambda: model.decode_step(params, cache0,
                                                          step), reps=20)
            decode_rows = device_rows(lambda: model.decode_step(
                params, cache0, step))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        pay = payload_bytes(cache0)
        bound_bytes = decode_bound_bytes(model)
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        r1, r2 = cell["runs"]
        print(f"ssm serve: {arch_id} FULL ({json.dumps(asdict(cfg))}"
              f"; {n_params} bf16 parameters drawn leaf by leaf on the card in "
              f"{init_s:.1f} s, peak {init_gb:.2f} GB; param_count "
              f"{cfg.param_count()})"
              + (f", {cfg.n_frames} seeded frame embeddings" if extra else "")
              + f", max_len {LM_MAX_LEN} | {n_req} requests over "
              f"{LM_PROMPTS} {LM_PROMPT_LEN}-token prompts, max_new "
              f"{LM_MAX_NEW}, twice, then a fresh engine: no fault; stats == "
              f"the CPU twin's: run 1 {json.dumps(r1['stats'])}, run 2 "
              f"{json.dumps(r2['stats'])} | bloom_probe launches a run "
              f"{pc13[-3:]} | decode == teacher forcing over the first "
              f"{SSM_TF_PROMPT} prompt tokens, {len(tf_errs)} steps: relative "
              f"L2 max {max(e for e, _ in tf_errs):.4g} (<= {tf_bound}, "
              f"a decode from the prompt's cache with one kind of leaf, or "
              f"all, zeroed reads "
              f"{ {k: round(v, 4) for k, v in lost.items()} }), "
              f"all steps {[round(e, 4) for e, _ in tf_errs]} | {card}",
              flush=True)
        print(f"ssm serve times {arch_id} (host clock, a warm call first): "
              f"prefill {prefill_ms:.2f} ms per {LM_PROMPT_LEN}-token "
              f"request; decode {decode_ms:.3f} ms a token; one step "
              f"profiled: {busy(device_totals(decode_rows), decode_ms)}; top "
              f"device operations: {device_top(decode_rows)} | decode bound "
              f"{bound_ms:.3f} ms ({bound_bytes / 1e9:.3f} GB at 3.35 TB/s: "
              f"the bf16 weights but the embedding table"
              + (f", and {cfg.n_layers} layers' cross-attention K/V "
                 f"recomputed over {cfg.n_frames} frames" if extra else "")
              + f") | run 1 {r1['tokens']} tokens in {r1['s'] * 1e3:.0f} ms "
              f"({r1['tokens'] / r1['s']:.1f} tokens/s), run 2 (all hits) "
              f"{r2['tokens']} in {r2['s'] * 1e3:.0f} ms "
              f"({r2['tokens'] / r2['s']:.1f} tokens/s) | prefix-cache "
              f"payload {pay} B a request (the decode cache at max_len "
              f"{LM_MAX_LEN}) | peak device memory allocated {peak_gb:.2f} "
              f"GB | {card}", flush=True)
        del params, leaves, eng, cell, cache0
        torch.cuda.empty_cache()
        # decode against teacher forcing at f32 (TF32 off), full depth: f32
        # weights from the same seed, the bf16 ones freed
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        MC.set_compute_dtype(torch.float32)
        params = draw_state_leaves(model.param_specs(), MC.init_from_specs(
            model.param_specs(), torch.Generator(dev).manual_seed(0), dev),
            SSM_STATE_SEED)
        gen, f32_errs, f32_flips = teacher_forcing(
            model, params, prompt0[:SSM_TF_PROMPT], LM_MAX_NEW, LM_MAX_LEN,
            dev, extra)
        f32_lost = lost_state_rels(model, params, prompt0[:SSM_TF_PROMPT],
                                   gen[0], LM_MAX_LEN, dev, extra)
        f32_gb = torch.cuda.max_memory_allocated() / 1e9
        del params
        torch.cuda.empty_cache()
        faults = tf_faults(f32_errs, f32_flips, TF_REL_F32)
        check(not faults, f"{arch_id} decode != teacher forcing at f32: "
              f"{faults}")
        check(min(f32_lost.values()) > TF_REL_F32,
              f"{arch_id}: at f32 a decode that lost a cache leaf reads "
              f"{f32_lost}, not above {TF_REL_F32}")
        # the card against the CPU at f32: prefill and one decode step, the
        # loss and its gradients at batch 1, seq 64
        n_cut = SSM_CPU_LAYERS[arch_id]
        small = model if n_cut is None else cut_model(arch_id, n_cut)
        np_params = draw_state_leaves(small.param_specs(), numpy_params(
            small.param_specs(), seed=1), SSM_STATE_SEED)
        forced = np.random.default_rng(9).integers(0, cfg.vocab, 1).tolist()
        toks = np.random.default_rng(12).integers(0, cfg.vocab,
                                                  (1, MOE_CPU_SEQ + 1))
        parts = []
        for where in (dev, "cpu"):
            ex = {k: v.to(where) for k, v in extra.items()}
            t = time.perf_counter()
            logits = forced_logits(small, MC.params_from_numpy(
                np_params, where), prompt0, forced, LM_MAX_LEN, where, ex)
            parts.append((logits, loss_grad_parts(small, np_params, toks,
                                                  where, ex),
                          time.perf_counter() - t))
        MC.set_compute_dtype(torch.bfloat16)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        del np_params
        (lg_card, (loss_card, g_card), card_s), \
            (lg_cpu, (loss_cpu, g_cpu), cpu_s) = parts
        # over the real vocabulary: a padded one's -1e30 logits would be
        # the largest |value|
        rel = [float(np.abs(a - b)[..., :cfg.vocab].max()
                     / np.abs(b[..., :cfg.vocab]).max())
               for a, b in zip(lg_card, lg_cpu)]
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        grad_rel, worst = max((rel_l2(a, b), i)
                              for i, (a, b) in enumerate(zip(g_card, g_cpu)))
        grad_bound = SSM_GRAD_REL.get(arch_id, MOE_GRAD_REL)
        check(max(rel) <= CARD_CPU_REL and loss_rel <= MOE_LOSS_REL
              and grad_rel <= grad_bound,
              f"{arch_id} card != CPU at f32: logits {rel}, loss {loss_rel}, "
              f"gradients {grad_rel} (leaf {worst})")
        print(f"ssm f32 {arch_id}: teacher forcing at FULL depth, TF32 off, "
              f"f32 weights from the same seed: {len(f32_errs)} decode steps, "
              f"relative L2 max {max(e for e, _ in f32_errs):.4g} (<= "
              f"{TF_REL_F32}), max |diff| {max(e for _, e in f32_errs):.4g}, "
              f"with one kind of cache leaf, or all, zeroed "
              f"{ {k: round(v, 4) for k, v in f32_lost.items()} }, "
              f"peak {f32_gb:.2f} GB | card vs CPU, "
              + ("whole" if n_cut is None else
                 f"FULL widths cut to {n_cut} layers")
              + f", numpy weights: prefill + {len(forced)} decode step, max "
              f"|card - cpu| / max |cpu| {[f'{r:.3g}' for r in rel]} (<= "
              f"{CARD_CPU_REL}); loss at batch 1, seq {MOE_CPU_SEQ} "
              f"{loss_card:.6f} vs {loss_cpu:.6f} (relative {loss_rel:.3g} <= "
              f"{MOE_LOSS_REL}), gradient leaves relative L2 max "
              f"{grad_rel:.5g} (<= {grad_bound}; leaf {worst} in "
              f"tree_leaves order) over {len(g_cpu)} leaves "
              f"| card {card_s:.1f} s, CPU {cpu_s:.1f} s | {arch_id} "
              f"{time.monotonic() - ta:.0f} s | {card}", flush=True)
        del parts, g_card, g_cpu, small, model
    print(f"ssm phase: {time.monotonic() - t13:.0f} s | {card} | total "
          f"{time.monotonic() - t_start:.0f} s", flush=True)

    # -- 14. the row split over a DeviceMesh and the dry-run census ---------
    # -- 15. the LM steps sharded over the card's (1, 1) DeviceMesh, in
    # phase 14's process group: they launch none of the seven kernels
    def phase15(host_mesh, census_bytes):
        reset_counts()
        sharded_phase(host_mesh, census_bytes, device=dev, card=card)
        launched = {name: fn.launches for name, fn in kernels.items()}
        check(not any(launched.values()),
              f"the sharded LM steps launched {launched}")

    t14 = time.monotonic()
    launches14, paths14 = mesh_phase(
        fstate.bank, queries, (f_member, f_probes, fstats), train_arg_bytes,
        types.SimpleNamespace(
            reset=reset_counts,
            launches=lambda: {k: kernels[k].launches for k in bank_kernels},
            paths=lambda: {k: bloom_paths(kernels[k]) for k in
                           ("bloom_probe", "cascade_probe") + bloomier_kernels},
            rule=bank_rule),
        device=dev, card=card, then=phase15)
    for k in bank_kernels:
        q9[k] = q9.get(k, 0) + launches14[k]
    print(f"mesh phases 14 and 15: {time.monotonic() - t14:.0f} s | {card} "
          f"| total {time.monotonic() - t_start:.0f} s", flush=True)

    # -- 16. the step trace beside the card's real step: on the host, in a
    # subprocess started after phase 2 (a fake group cannot share this
    # process's NCCL group); it launches no kernel
    reset_counts()
    trace_phase(traces, train_arg_bytes, train_peak_gb, card=card,
                t_start=t_start)
    launched = {name: fn.launches for name, fn in kernels.items()}
    check(not any(launched.values()), f"the step traces launched {launched}")
    print(f"trace phase 16 | total {time.monotonic() - t_start:.0f} s",
          flush=True)

    # -- 17. remat: zamba2-2.7b FULL trains with each layer recomputed in
    # the backward, beside the step trace of the same step with remat and
    # without (on the host, in the subprocess started after phase 2; the
    # step without remat is not run on the card); rwkv6-7b cut to
    # REMAT_RWKV_LAYERS: its remat step equals its plain step bit for bit
    t17 = time.monotonic()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run = train_run(dev, smoke=False, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                    n_steps=REMAT_STEPS, arch=REMAT_ARCH)
    remat_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(run["model"].remat, f"build_trainer built {REMAT_ARCH} without "
          "remat")
    # the three losses are of three batches, whose spread at this size
    # (~0.01) is the first steps' gain: the loss of step 0's batch is
    # taken again after the last step, which must be below step 0's
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in
          SyntheticLMData(run["data"].cfg).batch(0).items()}
    with torch.no_grad():
        again = float(run["model"].loss(run["state"]["params"], b0))
    faults = remat_train_faults(run["losses"], again)
    check(not faults, f"{REMAT_ARCH} train with remat: {faults}")
    held = {k: sum(a.numel() * a.element_size()
                   for a in MC.tree_leaves(run["state"][k]))
            for k in ("params", "opt")}
    zcfg, losses, step_ms = run["model"].cfg, run["losses"], run["ms"]
    del run, b0
    res, took, waited = trace_results(remat_proc, REMAT_TRACE_LIMIT_S,
                                      "the remat traces")
    recs = {r["remat"]: r for r in res["cells"]}
    got = {k: recs[True]["arg_bytes"][k] for k in ("params", "opt")}
    check(got == held, f"traced {REMAT_ARCH} train args {got} B != the "
          f"trainer's allocation {held} B")
    args_b = sum(recs[True]["arg_bytes"].values())
    modelled = {k: (sum(r["arg_bytes"].values()) + r["liveness"]) / 1e9
                for k, r in recs.items()}
    print(f"remat: {REMAT_ARCH} FULL ({zcfg.n_layers} Mamba2 layers, "
          f"d_model {zcfg.d_model}, the shared block after every "
          f"{zcfg.shared_every}th) through launch/train.build_trainer with "
          f"remat (each Mamba2 layer and each shared-block application "
          f"recomputed in the backward), bf16 compute, AdamW f32 | seq "
          f"{TRAIN_SEQ}, batch {TRAIN_BATCH}, {REMAT_STEPS} steps in "
          f"{remat_s:.1f} s: loss {[round(x, 4) for x in losses]}, on step "
          f"0's batch after them {again:.4f} | host ms "
          f"a step {[round(x, 1) for x in step_ms]} (step 0 warms up) | "
          f"peak device memory allocated {peak_gb:.2f} GB; the step trace's "
          f"modelled peak of the same step (args {args_b} B, params and "
          f"AdamW == the trainer's allocation, + liveness "
          f"{recs[True]['liveness']} B) {modelled[True]:.2f} GB: ratio "
          f"{modelled[True] / peak_gb:.3f}; without remat (traced only) "
          f"{modelled[False]:.2f} GB, liveness {recs[False]['liveness']} B; "
          f"largest live at the remat peak "
          f"{[(b, n) for b, n, _ in recs[True]['top']]}, without "
          f"{[(b, n) for b, n, _ in recs[False]['top']]} | traces "
          f"{recs[True]['ops']} / {recs[False]['ops']} ops in "
          f"{recs[True]['trace_s']:.1f} / {recs[False]['trace_s']:.1f} s, "
          f"their process ran from {remat_proc.t0 - t_start:.1f} s to "
          f"{res['t_end'] - t_start:.1f} s of the run ({took:.1f} s, limit "
          f"{REMAT_TRACE_LIMIT_S} s), waited {waited:.1f} s | {card}",
          flush=True)
    pair = remat_pair(dev)
    faults = remat_faults(pair)
    check(not faults, f"{REMAT_RWKV} remat against plain: {faults}")
    print(f"remat: {REMAT_RWKV} FULL widths cut to {pair['layers']} layers, "
          f"f32 weights from a seed, bf16 compute, a train step (forward "
          f"and backward) at batch {pair['batch']} x seq {pair['seq']} with "
          f"remat (each layer and each 64-token WKV chunk recomputed), "
          f"without, and with it again, deterministic algorithms: losses "
          f"{pair['losses']} equal bit for bit, {pair['leaves']} gradient "
          f"leaves equal bit for bit | peak allocated above what each step "
          f"found held {pair['peak_gb'][0]:.2f} GB with remat, "
          f"{pair['peak_gb'][1]:.2f} GB without, "
          f"{pair['peak_gb'][2]:.2f} GB with again | host ms "
          f"{[round(x, 1) for x in pair['ms']]} (the first step warms up) | "
          f"{card}", flush=True)
    launched = {name: fn.launches for name, fn in kernels.items()}
    check(not any(launched.values()), f"the remat phase launched {launched}")
    print(f"remat phase 17: {time.monotonic() - t17:.0f} s | total "
          f"{time.monotonic() - t_start:.0f} s", flush=True)

    q9["bloom_probe"] += sum(l["bloom_probe"] for l in pc10 + pc12 + pc13)
    q9["bloom_gather"] += sum(l["gather"] for l in pc10 + pc12 + pc13)
    for r in records:
        r["launches"] += q9.get(r["name"], 0)
        if r["name"] == "bloom_probe":
            r["gather_launches"] += q9["bloom_gather"]
        for path, c in paths14.get(r["name"], {}).items():
            r[f"{path}_launches"] += c

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
