"""Semijoin pruning: probe the next relation's bank before materializing.

Datalog engines evaluate a rule body left-to-right, restricting each
relation by the bindings produced so far. The expensive step is
materializing the next relation's matching tuples; the classic fix is a
semijoin — reduce the candidate bindings against the next relation FIRST,
then materialize only the reduced set. Here the reducer is the next
collection's membership filter bank: join keys are probed through the
pinned generation's fused filter cascade (zero SSTable reads — memtable
overlay plus ONE ``probe_batch`` launch), candidates the bank rejects are
dropped, optional tag/range predicates narrow further (still zero reads),
and only then do survivors pay ``get_batch`` materialization.

No false drops: the chained cascade is exact-positive over its
generation's live keys (paper §3 — every enrolled key fires) and Bloom
has no false negatives, so a binding with a live join partner always
survives the prune. ``filter_kind='none'`` stores degrade gracefully: the
bank fires for everything, pruning power comes only from the memtable
overlay, and correctness is untouched because materialization is still
exact. Per-step candidate-reduction fractions are reported so benchmarks
can put a number on what the prune saved.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .catalog import Collection
from .pipeline import (CollectionView, Member, Pipeline, predicate_mask,
                       stage_label, _resolve)


def bank_member(view: CollectionView, keys: np.ndarray) -> np.ndarray:
    """May-exist mask [n] from the pinned view's memtable overlay + ONE
    fused membership-bank probe — zero SSTable reads. Never False for a
    key that is live in the view (no-false-negative filters); may be True
    for dead/absent keys (resolved later by materialization)."""
    n = len(keys)
    maybe = np.zeros(n, bool)
    if n == 0:
        return maybe
    inmem, live, _ = view.snap.memtable_probe(keys)
    maybe |= live
    rest = ~inmem
    if rest.any():
        gen = view.snap.gen
        if gen.n_tables:
            store = view.collection.store
            first, mask = gen.probe_batch(keys[rest])
            store.snap_stats.probed += int(rest.sum())
            maybe[rest] = mask != 0
        # else: empty generation — nothing generation-resident exists
    return maybe


@dataclass(frozen=True)
class JoinStep:
    """One semijoin against ``collection``: bindings map through
    ``key_fn(keys, vals) -> join_keys`` (None = join on the base key),
    optionally narrowed by tag/range ``stages`` over the right relation
    before materialization."""
    collection: Collection
    key_fn: object = None
    stages: tuple = ()


@dataclass(frozen=True)
class SemiJoinResult:
    """Surviving bindings plus, per join step, the right relation's
    values aligned with ``keys``. ``step_stats`` records the prune
    accounting: candidates → bank survivors → predicate survivors
    (materialized) → matched, and the candidate-reduction fraction
    (share of candidates that never paid materialization)."""
    keys: np.ndarray
    vals: np.ndarray
    right_vals: tuple
    fences: dict
    base: object                       # the base PlanResult
    step_stats: tuple

    @property
    def candidate_reduction(self) -> tuple:
        return tuple(s["reduction"] for s in self.step_stats)


class SemiJoinExecution:
    """All views pinned EAGERLY at open — the base pipeline's and every
    join step's — so one execution sees one frozen state per collection
    and ``fences`` proves it."""

    def __init__(self, plan: "SemiJoin"):
        self.plan = plan
        self.base = plan.base.open()
        self.views = [CollectionView(st.collection) for st in plan.joins]
        self.closed = False

    @property
    def fences(self) -> dict:
        f = dict(self.base.fences)
        for view in self.views:
            f[view.collection.name] = view.gen_id
        return f

    def run(self, keys=None) -> SemiJoinResult:
        if self.closed:
            raise RuntimeError("semijoin execution is closed")
        base = self.base.run(keys)
        k, v = base.keys, base.vals
        right_vals: list[np.ndarray] = []
        step_stats = []
        for step, view in zip(self.plan.joins, self.views):
            if step.key_fn is not None:
                jk = np.asarray(step.key_fn(k, v), np.uint64)
            else:
                jk = k
            n_cand = len(jk)
            maybe = bank_member(view, jk)
            n_bank = int(maybe.sum())
            for stage in step.stages:     # survivor-flow, zero reads
                if isinstance(stage, Member):
                    continue              # materialization IS the member check
                idx = np.flatnonzero(maybe)
                m = predicate_mask(view, stage, jk[idx])
                maybe[idx[~m]] = False
            surv = np.flatnonzero(maybe)
            found, rv, _ = _resolve(view, jk[surv])
            keep = np.zeros(n_cand, bool)
            keep[surv[found]] = True
            rv_full = np.zeros(n_cand, np.uint64)
            rv_full[surv] = rv
            step_stats.append({
                "collection": view.collection.name,
                "stages": tuple(stage_label(s) for s in step.stages),
                "candidates": n_cand,
                "bank_survivors": n_bank,
                "materialized": len(surv),
                "matched": int(found.sum()),
                "reduction": 1.0 - len(surv) / max(1, n_cand),
            })
            k, v = k[keep], v[keep]
            right_vals = [r[keep] for r in right_vals]
            right_vals.append(rv_full[keep])
        return SemiJoinResult(keys=k, vals=v, right_vals=tuple(right_vals),
                              fences=dict(self.fences), base=base,
                              step_stats=tuple(step_stats))

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.base.close()
            for view in self.views:
                view.close()

    def __enter__(self) -> "SemiJoinExecution":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class SemiJoin:
    """A base pipeline restricted by a sequence of semijoin steps."""
    base: Pipeline
    joins: tuple

    def __post_init__(self):
        self.joins = tuple(self.joins)

    def open(self) -> SemiJoinExecution:
        return SemiJoinExecution(self)

    def run(self, keys=None) -> SemiJoinResult:
        with self.open() as ex:
            return ex.run(keys)
