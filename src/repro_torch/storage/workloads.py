"""Deterministic CRUD workload generators + §5.4 latency accounting.

Workloads are materialized up front as a list of ``WorkloadOp`` batches
(seeded — the same arguments always produce the same traffic), so a store
under test and a host-side reference model can replay identical streams.
Every generator draws each decision stream (op-kind coin flips, key draws,
range endpoints) from its OWN independently seeded
``np.random.Generator``, so the keys of phase N are reproducible even when
an earlier phase's consumption pattern changes — the property differential
runs rely on to replay traffic piecewise.

Four shapes, mirroring the YCSB-style mixes LSM papers benchmark:

- ``uniform_write_heavy``   — mostly puts over a uniform key space; the
  flush/compaction write-amplification exerciser.
- ``zipfian_read_heavy``    — mostly gets with Zipf-ranked popularity over
  the inserted keys (hot-key skew); the filter-bank cache-residency case.
- ``mixed_read_write``      — interleaved puts/gets where a configurable
  fraction of gets miss the store entirely; the ChainedFilter headline
  case (misses are where the ≤ 1 wasted-read rule pays).
- ``crud_mixed``            — full put/get/delete/scan traffic; the
  tombstone-exclusion and fence-pruning exerciser (deleted keys must cost
  0 reads on a chained store, ranges prune by min/max fences).
- ``tagged_query``          — Zipf-ranked candidate batches each carrying
  a predicate list (tag equality / tag sets / range fences) in the query
  layer's spec-tuple form; the predicate-pipeline exerciser.

``LatencyAccountant`` converts per-get SSTable read counts to microseconds
with the calibrated ``core.lsm.latency_model`` and reports the Fig-12
percentiles.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.lsm import latency_model


@dataclass(frozen=True)
class WorkloadOp:
    kind: str                       # 'put' | 'get' | 'del' | 'scan' | 'query'
    keys: np.ndarray                # uint64 [batch] (empty for scans)
    vals: np.ndarray | None = None  # uint64 [batch] for puts
    lo: int = 0                     # scan window [lo, hi)
    hi: int = 0
    stages: tuple = ()              # query ops: pipeline stage specs, the
    #                                 tuple form of query.stages_from_specs


def _key_universe(n: int, seed: int) -> np.ndarray:
    """Distinct uint64 keys, deterministic in (n, seed)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2 ** 63, size=int(n * 1.2) + 64, dtype=np.uint64)
    keys = keys[np.sort(np.unique(keys, return_index=True)[1])]  # keep order
    while len(keys) < n:  # pragma: no cover — astronomically unlikely
        extra = rng.integers(1, 2 ** 63, size=n, dtype=np.uint64)
        keys = np.concatenate([keys, np.setdiff1d(extra, keys)])
    return keys[:n]


def _zipf_weights(n: int, theta: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    return w / w.sum()


def _phase_rngs(seed: int, *phases: str) -> tuple[np.random.Generator, ...]:
    """One independently seeded ``np.random.Generator`` per named stream.
    Consuming from one stream never perturbs another, so (e.g.) the key
    draws of a get phase replay identically whatever the op-kind coin
    flips did — the per-phase reproducibility contract differential runs
    depend on. Stream names enter the seed through crc32, NOT ``hash()``
    (whose per-process salt would silently break cross-process replay and
    the benchmark regression baselines)."""
    return tuple(np.random.default_rng([seed, zlib.crc32(p.encode())])
                 for p in phases)


def uniform_write_heavy(n_ops: int, batch: int = 256, read_frac: float = 0.1,
                        seed: int = 0) -> list[WorkloadOp]:
    """~90% puts of fresh uniform keys, ~10% gets of already-written keys."""
    rng_kind, rng_keys = _phase_rngs(seed + 1, "kind", "keys")
    universe = _key_universe(n_ops * batch, seed)
    ops: list[WorkloadOp] = []
    cursor = 0
    for _ in range(n_ops):
        if cursor == 0 or rng_kind.random() >= read_frac:
            keys = universe[cursor:cursor + batch]
            ops.append(WorkloadOp("put", keys, keys >> np.uint64(17)))
            cursor += batch
        else:
            ops.append(WorkloadOp(
                "get", rng_keys.choice(universe[:cursor], size=batch)))
    return ops


def zipfian_read_heavy(n_ops: int, batch: int = 256, n_keys: int = 8192,
                       write_frac: float = 0.05, theta: float = 1.1,
                       seed: int = 0) -> list[WorkloadOp]:
    """Load ``n_keys`` once, then ~95% gets with Zipf(θ) popularity (rank =
    insertion order) and ~5% overwrites of the same hot ranks. The op-kind
    coin flips and the Zipf key draws are separate seeded streams: the i-th
    mixed-phase key batch is a pure function of (seed, i), whatever mix of
    gets and overwrites preceded it."""
    rng_kind, rng_keys = _phase_rngs(seed + 2, "kind", "keys")
    universe = _key_universe(n_keys, seed)
    weights = _zipf_weights(n_keys, theta)
    ops: list[WorkloadOp] = []
    for start in range(0, n_keys, batch):
        keys = universe[start:start + batch]
        ops.append(WorkloadOp("put", keys, keys >> np.uint64(17)))
    for _ in range(n_ops):
        keys = rng_keys.choice(universe, size=batch, p=weights)
        if rng_kind.random() < write_frac:
            ops.append(WorkloadOp("put", keys, keys + np.uint64(1)))
        else:
            ops.append(WorkloadOp("get", keys))
    return ops


def mixed_read_write(n_ops: int, batch: int = 256, read_frac: float = 0.5,
                     miss_frac: float = 0.5, seed: int = 0
                     ) -> list[WorkloadOp]:
    """Interleaved puts/gets; ``miss_frac`` of each get batch draws keys
    that were NEVER inserted (the wasted-read / tail-latency probe)."""
    rng_kind, rng_keys = _phase_rngs(seed + 3, "kind", "keys")
    universe = _key_universe(2 * n_ops * batch, seed)
    present, absent = universe[::2], universe[1::2]   # disjoint by parity
    ops: list[WorkloadOp] = []
    cursor = 0
    for _ in range(n_ops):
        if cursor == 0 or rng_kind.random() >= read_frac:
            keys = present[cursor:cursor + batch]
            ops.append(WorkloadOp("put", keys, keys >> np.uint64(17)))
            cursor += batch
        else:
            n_miss = int(round(batch * miss_frac))
            hits = rng_keys.choice(present[:cursor], size=batch - n_miss)
            misses = rng_keys.choice(absent, size=n_miss, replace=False)
            keys = np.concatenate([hits, misses])
            rng_keys.shuffle(keys)
            ops.append(WorkloadOp("get", keys))
    return ops


def crud_mixed(n_ops: int, batch: int = 256, read_frac: float = 0.35,
               delete_frac: float = 0.15, scan_frac: float = 0.1,
               scan_span: float = 0.05, seed: int = 0) -> list[WorkloadOp]:
    """Full-CRUD traffic: puts of fresh keys, gets over written keys,
    deletes of a trailing window of written keys, and range scans whose
    window covers ``scan_span`` of the key space (narrow enough that
    min/max fences prune most tables). Each decision stream (op kind, key
    draws, scan endpoints) has its own seeded generator."""
    rng_kind, rng_keys, rng_rng = _phase_rngs(seed + 4, "kind", "keys",
                                              "ranges")
    universe = np.sort(_key_universe(n_ops * batch, seed))
    ops: list[WorkloadOp] = []
    cursor = 0
    deleted_to = 0           # prefix of written keys already deleted
    for _ in range(n_ops):
        r = rng_kind.random()
        if cursor == 0 or r >= read_frac + delete_frac + scan_frac:
            keys = universe[cursor:cursor + batch]
            ops.append(WorkloadOp("put", keys, keys >> np.uint64(17)))
            cursor += batch
        elif r < read_frac:
            ops.append(WorkloadOp(
                "get", rng_keys.choice(universe[:cursor], size=batch)))
        elif r < read_frac + delete_frac and deleted_to + batch <= cursor:
            keys = universe[deleted_to:deleted_to + batch]
            ops.append(WorkloadOp("del", keys))
            deleted_to += batch
        else:
            # window over the WRITTEN region (live data), sized as a
            # fraction of the full key space
            span = max(1, int(len(universe) * scan_span))
            a = int(rng_rng.integers(0, max(1, cursor - span)))
            ops.append(WorkloadOp("scan", np.empty(0, np.uint64),
                                  lo=int(universe[a]),
                                  hi=int(universe[min(a + span,
                                                      len(universe) - 1)])))
    return ops


def tagged_query(n_ops: int, batch: int = 256, n_keys: int = 8192,
                 theta: float = 1.1, tag_bits: int = 4, index: str = "tags",
                 max_stages: int = 3, write_frac: float = 0.1,
                 seed: int = 0) -> list[WorkloadOp]:
    """Predicate-pipeline traffic: Zipf(θ)-ranked candidate keys, each op
    carrying a 1..``max_stages``-deep predicate list drawn over tag
    equality / tag sets / key-range fences (spec tuples — feed them to
    ``query.Pipeline.from_specs``). A ``write_frac`` share of overwrite
    batches keeps the secondary-index enrollment path hot while queries
    run. Kind flips, key draws and predicate draws are three independent
    seeded streams, same replay contract as the CRUD mixes."""
    rng_kind, rng_keys, rng_pred = _phase_rngs(seed + 5, "kind", "keys",
                                               "preds")
    universe = np.sort(_key_universe(n_keys, seed))
    weights = _zipf_weights(n_keys, theta)
    n_tags = 1 << tag_bits
    ops: list[WorkloadOp] = []
    for start in range(0, n_keys, batch):
        keys = universe[start:start + batch]
        ops.append(WorkloadOp("put", keys, keys >> np.uint64(17)))
    for _ in range(n_ops):
        keys = rng_keys.choice(universe, size=batch, p=weights)
        if rng_kind.random() < write_frac:
            ops.append(WorkloadOp("put", keys, keys + np.uint64(1)))
            continue
        stages = []
        for _ in range(int(rng_pred.integers(1, max_stages + 1))):
            r = rng_pred.random()
            if r < 0.5:
                stages.append(("tag_eq", index,
                               int(rng_pred.integers(0, n_tags))))
            elif r < 0.8:
                a = int(rng_pred.integers(0, n_keys - 1))
                span = max(1, int(n_keys * 0.2))
                b = min(n_keys - 1, a + span)
                stages.append(("range", int(universe[a]), int(universe[b])))
            else:
                k = int(rng_pred.integers(1, max(2, n_tags // 2)))
                tags = rng_pred.choice(n_tags, size=k, replace=False)
                stages.append(("tag_in", index,
                               tuple(int(t) for t in np.sort(tags))))
        ops.append(WorkloadOp("query", keys, stages=tuple(stages)))
    return ops


@dataclass
class LatencyAccountant:
    """Accumulates per-get SSTable read counts (plus plan stage counts and
    admission-stall events); reports the calibrated Fig-12 latency
    percentiles with the counts of each traffic class reported DISTINCTLY
    — ``n`` is per-key read samples, ``n_plans`` is executed plans — so a
    plans-only run is never mistaken for an empty one."""

    probes_cost_us: float = 2.0
    read_cost_us: float = 9.0
    reads: list = field(default_factory=list)
    stage_counts: list = field(default_factory=list)   # one tuple per plan
    stalls: list = field(default_factory=list)         # seconds per stall

    def record(self, reads: np.ndarray) -> None:
        self.reads.append(np.asarray(reads, dtype=np.int64))

    def record_stages(self, survivors) -> None:
        """Per-stage survivor counts of one executed plan, cascade order
        (the fused-probe cost model: stage i+1 pays survivors[i] keys)."""
        self.stage_counts.append(tuple(int(s) for s in survivors))

    def record_stall(self, seconds: float) -> None:
        """One write-admission stall (the always-on store's backpressure
        signal): how long the writer waited for compaction headroom."""
        self.stalls.append(float(seconds))

    def report(self) -> dict:
        """``n`` counts per-key read samples; ``n_plans`` (with ``plans``
        kept as its alias for older consumers) counts executed plans —
        distinct, so a plans-only run reports ``n == 0`` but ``n_plans >
        0`` instead of looking empty. Stall accounting (count / total /
        max seconds) rides along whenever any stall was recorded."""
        out: dict = {"n": 0, "n_plans": len(self.stage_counts)}
        if self.reads:
            reads = np.concatenate(self.reads)
            lat = latency_model(reads, probes_cost_us=self.probes_cost_us,
                                read_cost_us=self.read_cost_us)
            out.update({
                "n": int(len(reads)),
                "avg_reads": float(reads.mean()),
                "max_reads": int(reads.max()),
                "p50_us": float(np.percentile(lat, 50)),
                "p95_us": float(np.percentile(lat, 95)),
                "p99_us": float(np.percentile(lat, 99)),
            })
        if self.stage_counts:
            depth = max(len(c) for c in self.stage_counts)
            out["plans"] = len(self.stage_counts)
            out["stage_survivors"] = [
                int(sum(c[i] for c in self.stage_counts if i < len(c)))
                for i in range(depth)]
        if self.stalls:
            out["write_stalls"] = len(self.stalls)
            out["stall_time_s"] = float(sum(self.stalls))
            out["stall_max_s"] = float(max(self.stalls))
        return out


def run_workload(store, ops: list[WorkloadOp],
                 accountant: LatencyAccountant | None = None,
                 query_fn=None) -> dict:
    """Replay a workload against an ``LsmStore``; returns the accountant
    report plus hit-rate. The store's own ``stats`` keep the read/probe
    totals. ``query`` ops dispatch to ``query_fn(op) -> PlanResult``
    (typically a closure over a ``query.Collection`` wrapping the same
    store); each plan's per-candidate reads and per-stage survivor counts
    feed the accountant."""
    accountant = accountant or LatencyAccountant()
    n_found = n_get = 0
    n_scanned = 0
    for op in ops:
        if op.kind == "put":
            store.put_batch(op.keys, op.vals)
        elif op.kind == "del":
            store.delete_batch(op.keys)
        elif op.kind == "scan":
            ks, _ = store.scan(op.lo, op.hi)
            n_scanned += len(ks)
        elif op.kind == "query":
            if query_fn is None:
                raise ValueError("workload contains query ops but no "
                                 "query_fn was supplied")
            res = query_fn(op)
            accountant.record(res.reads)
            accountant.record_stages(res.survivor_counts)
            n_found += len(res.keys)
            n_get += len(op.keys)
        else:
            found, _, reads = store.get_batch(op.keys)
            accountant.record(reads)
            n_found += int(found.sum())
            n_get += len(op.keys)
    out = accountant.report()
    # None, not 0.0, when the workload issued no gets at all: a write-only
    # run has no hit rate, and 0.0 would read as "every get missed"
    out["hit_rate"] = (n_found / n_get) if n_get else None
    out["scanned_keys"] = n_scanned
    return out
