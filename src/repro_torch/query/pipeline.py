"""Predicate pipelines: multi-stage queries as fused filter cascades.

A plan is a conjunction of stages — membership, min/max fence, tag
equality/set — executed as a survivor-flow cascade: each stage evaluates
ONE batched probe over the current survivor set only, and only its
survivors flow to the next stage (the chain-rule composition of §2–3
applied at plan level; compare SQL engines that chain filter CTEs so
each predicate sees only the previous predicate's matches).

Stage semantics are **pure per (key, pinned view)**: every stage's
verdict for a key depends only on the key and the snapshot-pinned state
captured at ``open()`` — never on which stage ran before it. That makes
conjunctive reordering provably result-invariant (the executor's
survivor-gather changes *cost*, not the final set).

Snapshot pinning: ``Pipeline.open()`` eagerly opens the collection's
``snapshot()`` and records its ``gen_id`` fence plus the tag-bank
``BankState`` captured per index. Flushes/compactions mid-plan publish
new generations underneath without tearing the view — every stage of one
execution probes the same generation and the same bank version.

The ≤ 1-read chained bound applies **per membership stage**: a
``Member`` stage resolves survivors through the pinned generation's
chained filter cascade (``Snapshot.get_batch``), paying at most one
wasted SSTable read per key (paper §5.4); tag and range stages pay zero
reads. Every plan ends membership-resolved — if no explicit ``Member``
stage ran, the executor appends one — so tag-retrieval noise on
non-enrolled keys (see ``catalog``) can never leak a dead or absent key
into the result.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .catalog import Collection, MISSING

_U64_END = 1 << 64


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Member:
    """Membership + value resolution in the plan's home collection: one
    batched ``get_batch`` against the pinned view (≤ 1 wasted SSTable
    read per key under the chained filter)."""


@dataclass(frozen=True)
class RangeFence:
    """Survives iff ``lo <= key < hi`` — pure key-space arithmetic, zero
    probes. As the FIRST stage of a scan-driven plan (``run(keys=None)``)
    it also supplies the candidates via the pinned fence-pruned scan."""
    lo: int
    hi: int


@dataclass(frozen=True)
class TagEq:
    """Survives iff the named tag index retrieves exactly ``tag``."""
    index: str
    tag: int


@dataclass(frozen=True)
class TagIn:
    """Survives iff the named tag index retrieves a tag in ``tags``."""
    index: str
    tags: tuple


def stages_from_specs(specs) -> tuple:
    """Tuple-spec form shared with the workload generator and the dict
    oracle: ("member",) | ("range", lo, hi) | ("tag_eq", index, tag) |
    ("tag_in", index, (tags...))."""
    out = []
    for spec in specs:
        kind = spec[0]
        if kind == "member":
            out.append(Member())
        elif kind == "range":
            out.append(RangeFence(int(spec[1]), int(spec[2])))
        elif kind == "tag_eq":
            out.append(TagEq(spec[1], int(spec[2])))
        elif kind == "tag_in":
            out.append(TagIn(spec[1], tuple(int(t) for t in spec[2])))
        else:
            raise ValueError(f"unknown stage spec {spec!r}")
    return tuple(out)


def stage_label(stage) -> str:
    if isinstance(stage, Member):
        return "member"
    if isinstance(stage, RangeFence):
        return f"range[{stage.lo},{stage.hi})"
    if isinstance(stage, TagEq):
        return f"tag_eq({stage.index}=={stage.tag})"
    if isinstance(stage, TagIn):
        return f"tag_in({stage.index})"
    raise TypeError(f"unknown stage {stage!r}")


# ---------------------------------------------------------------------------
# pinned execution context
# ---------------------------------------------------------------------------

class CollectionView:
    """One collection's pinned execution context: the open snapshot, its
    gen-id fence, and the tag-bank states captured AT OPEN — the complete
    frozen read state a plan needs, so publishes after open can neither
    tear the view nor swap a bank under a running stage."""

    def __init__(self, collection: Collection):
        self.collection = collection
        self.snap = collection.snapshot()
        self.gen_id = self.snap.gen_id
        self.states = {name: idx.state_for(self.gen_id)
                       for name, idx in collection.indexes.items()}

    def close(self) -> None:
        self.snap.close()


def _range_mask(keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    m = keys >= np.uint64(max(0, lo))
    if hi < _U64_END:
        m &= keys < np.uint64(max(0, hi))
    return m


def _resolve(view: CollectionView, keys: np.ndarray):
    """Exact membership resolution through the pinned view ->
    (found, vals, reads)."""
    if len(keys) == 0:
        return (np.zeros(0, bool), np.zeros(0, np.uint64),
                np.zeros(0, np.int64))
    return view.snap.get_batch(keys)


def predicate_mask(view: CollectionView, stage, keys: np.ndarray
                   ) -> np.ndarray:
    """bool [n] verdict of one non-Member stage over a key batch — pure
    per (key, view).

    Tag stages split each batch by the pinned memtable overlay: rows the
    frozen memtable owns (live OR tombstone — a memtable record shadows
    every generation-resident version) answer from ``tag_fn`` on the
    frozen value; everything else answers from ONE fused probe of the
    captured tag-bank state. Non-enrolled keys get arbitrary bank answers
    — harmless, because plans always end membership-resolved."""
    if isinstance(stage, RangeFence):
        return _range_mask(keys, stage.lo, stage.hi)
    idx = view.collection.indexes.get(stage.index)
    if idx is None:
        raise KeyError(f"collection {view.collection.name!r} has no index "
                       f"{stage.index!r}; have: "
                       f"{sorted(view.collection.indexes)}")
    if isinstance(stage, TagEq):
        def want(tags):
            return tags == np.uint64(stage.tag)
    elif isinstance(stage, TagIn):
        wanted = np.unique(np.asarray(stage.tags, np.uint64))

        def want(tags):
            return np.isin(tags, wanted)
    else:
        raise TypeError(f"unknown stage {stage!r}")
    n = len(keys)
    out = np.zeros(n, bool)
    if n == 0:
        return out
    inmem, live, mvals = view.snap.memtable_probe(keys)
    if live.any():
        out[live] = want(idx.host_tags(keys[live], mvals[live]))
    rest = ~inmem
    if rest.any():
        state = view.states.get(stage.index, MISSING)
        if state is None:
            pass          # empty generation: nothing generation-resident
        elif state is MISSING:
            # no captured bank for this pinned generation (e.g. the index
            # was created after this plan opened) — exact fallback through
            # the pinned view, still torn-read-free
            f, v, _ = _resolve(view, keys[rest])
            m = np.zeros(int(rest.sum()), bool)
            m[f] = want(idx.host_tags(keys[rest][f], v[f]))
            out[rest] = m
        else:
            out[rest] = want(idx.bank_tags(state, keys[rest]))
    return out


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanResult:
    """keys/vals are the surviving bindings in candidate order.
    ``reads`` is the per-input-candidate SSTable point-read cost (0 for
    keys pruned before any resolution); ``fences`` records the gen-id
    each touched collection was pinned at."""
    keys: np.ndarray
    vals: np.ndarray
    fences: dict
    stage_survivors: tuple            # ((label, survivors_after), ...)
    n_candidates: int
    reads: np.ndarray = field(repr=False, default=None)

    @property
    def total_reads(self) -> int:
        return int(self.reads.sum())

    @property
    def survivor_counts(self) -> tuple:
        return tuple(n for _, n in self.stage_survivors)


class PlanExecution:
    """An OPEN plan: snapshot pinned, fences recorded, ready to ``run``
    one or more candidate batches against the same frozen view. Close it
    (or use ``with``) to release the pin."""

    def __init__(self, pipeline: "Pipeline"):
        self.pipeline = pipeline
        self.view = CollectionView(pipeline.collection)
        self.closed = False

    @property
    def fences(self) -> dict:
        return {self.pipeline.collection.name: self.view.gen_id}

    def run(self, keys=None) -> PlanResult:
        """Execute the cascade. ``keys=None`` runs scan-driven: the
        leading RangeFence supplies candidates from the pinned
        fence-pruned scan; otherwise ``keys`` are the candidates (order
        and duplicates preserved into the result)."""
        if self.closed:
            raise RuntimeError("plan execution is closed")
        stages = self.pipeline.stages
        view = self.view
        if keys is None:
            if not stages or not isinstance(stages[0], RangeFence):
                raise ValueError(
                    "scan-driven plans (keys=None) need a leading RangeFence")
            cands, vals = view.snap.scan(stages[0].lo, stages[0].hi)
            resolved = True           # scan yields live rows of the view
        else:
            cands = np.asarray(keys, dtype=np.uint64)
            vals = np.zeros(len(cands), np.uint64)
            resolved = False
        n0 = len(cands)
        reads = np.zeros(n0, np.int64)
        pos = np.arange(n0)           # survivor -> original candidate slot
        survivors = []
        for stage in stages:
            if isinstance(stage, Member):
                found, v, r = _resolve(view, cands)
                reads[pos] += r
                vals = v
                resolved = True
                mask = found
            else:
                mask = predicate_mask(view, stage, cands)
            cands, vals, pos = cands[mask], vals[mask], pos[mask]
            survivors.append((stage_label(stage), len(cands)))
        if not resolved:
            # implicit final membership resolution: the guarantee that tag
            # noise on dead/absent keys never reaches the caller
            found, v, r = _resolve(view, cands)
            reads[pos] += r
            cands, vals, pos = cands[found], v[found], pos[found]
            survivors.append(("resolve", len(cands)))
        return PlanResult(keys=cands, vals=vals, fences=dict(self.fences),
                          stage_survivors=tuple(survivors),
                          n_candidates=n0, reads=reads)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.view.close()

    def __enter__(self) -> "PlanExecution":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class Pipeline:
    """An executable plan description: home collection + stage tuple.
    ``open()`` pins the view (long-lived handle, many ``run`` calls);
    ``run()`` is the one-shot convenience."""
    collection: Collection
    stages: tuple

    def __post_init__(self):
        self.stages = tuple(self.stages)

    @classmethod
    def from_specs(cls, collection: Collection, specs) -> "Pipeline":
        return cls(collection, stages_from_specs(specs))

    def open(self) -> PlanExecution:
        return PlanExecution(self)

    def run(self, keys=None) -> PlanResult:
        with self.open() as ex:
            return ex.run(keys)
