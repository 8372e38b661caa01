"""Differential suites for the port on the CPU, against ``tests/model.py``
only (no JAX store: the port's plain versions need no interpret mode).

- **Query interleavings** (as ``tests/test_query_differential.py``): CRUD
  traffic, one-shot, scan-driven and pinned plans and semijoins over TWO
  ``repro_torch.query`` collections of ``LsmStore(device="cpu")``, in lock
  step with the dict plan oracle; every result bit-exact, pinned plans
  answering from their open-time state while both collections mutate,
  flush and compact, and no pin leaked.
- **Store interleavings** (as ``tests/test_differential.py``): put /
  delete / get / scan / flush / compact / snapshot ops on the port's
  ``LsmStore``, foreground and with a background compactor merging
  underneath; every get and scan (live or pinned) bit-exact, the chained
  <= 1-read bound and the exclusion-set invariant, no pin leaked, and the
  quiesced background store below its table cap with no compactor error.

Each interleaving comes from ONE hypothesis-drawn seed, replayable from
the ``kind=... seed=... step=...`` tag on every assertion. The example
budgets are the JAX files' fast lanes.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.query import Catalog, JoinStep, Pipeline, SemiJoin  # noqa: E402
from repro_torch.storage import LsmStore  # noqa: E402

from model import (ReferenceCollection, ReferenceStore,  # noqa: E402
                   reference_semijoin)

KIND_IDX = {"chained": 0, "bloom": 1, "none": 2}
KINDS = tuple(KIND_IDX)


# ---------------------------------------------------- query interleavings

_Q_UNIVERSE = H.random_keys(640, seed=92)
Q_POOL = _Q_UNIVERSE[:448]      # keys CRUD ops draw from (both collections)
Q_ABSENT = _Q_UNIVERSE[448:]    # never written (miss/noise traffic)

TAG_BITS = 3
N_TAGS = 1 << TAG_BITS


def tag_fn(keys, vals):
    return vals & np.uint64(N_TAGS - 1)


def _q_mixed_keys(rng, n, absent_frac=0.3):
    n_abs = int(round(n * absent_frac))
    parts = [rng.choice(Q_POOL, size=n - n_abs)]
    if n_abs:
        parts.append(rng.choice(Q_ABSENT, size=n_abs))
    ks = np.concatenate(parts)
    rng.shuffle(ks)
    return ks


def _rand_specs(rng, scan_driven=False):
    """1..3 random stage specs; scan-driven plans lead with a range."""
    specs = []
    if scan_driven:
        a, b = np.sort(rng.choice(Q_POOL, size=2, replace=False))
        specs.append(("range", int(a), int(b) + 1))
    for _ in range(int(rng.integers(1, 4)) - len(specs)):
        r = rng.random()
        if r < 0.35:
            specs.append(("tag_eq", "tags", int(rng.integers(0, N_TAGS))))
        elif r < 0.55:
            k = int(rng.integers(1, N_TAGS // 2 + 1))
            tags = np.sort(rng.choice(N_TAGS, size=k, replace=False))
            specs.append(("tag_in", "tags", tuple(int(t) for t in tags)))
        elif r < 0.8:
            a, b = np.sort(rng.choice(Q_POOL, size=2, replace=False))
            specs.append(("range", int(a), int(b) + int(rng.random() < 0.5)))
        else:
            specs.append(("member",))
    return specs or [("member",)]


def _check_plan(res, exp_k, exp_v, kind, specs, msg):
    np.testing.assert_array_equal(res.keys, exp_k, err_msg=f"{msg} keys")
    np.testing.assert_array_equal(res.vals, exp_v, err_msg=f"{msg} vals")
    if kind == "chained" and len(res.reads):
        n_resolves = max(1, sum(1 for s in specs if s[0] == "member"))
        assert res.reads.max() <= n_resolves, (
            f"{msg}: chained per-membership-stage read bound violated")


MAX_OPEN_PLANS = 3


def run_query_differential(filter_kind: str, seed: int,
                           max_steps: int = 16) -> None:
    """Replay one seeded interleaving: catalog + 2 collections vs oracle."""
    rng = np.random.default_rng([seed, KIND_IDX[filter_kind]])
    cat = Catalog()
    colls, refs = {}, {}
    for name in ("a", "b"):
        colls[name] = cat.create_collection(
            name, filter_kind=filter_kind,
            seed=int(rng.integers(0, 1024)),
            memtable_capacity=int(rng.choice([48, 96, 1 << 30])),
            compact_min_run=int(rng.choice([2, 3])),
            auto_compact=bool(rng.random() < 0.7), device="cpu")
        colls[name].create_index("tags", tag_fn, tag_bits=TAG_BITS)
        refs[name] = ReferenceCollection()
        refs[name].create_index("tags", tag_fn, tag_bits=TAG_BITS)
    open_plans: list[tuple] = []    # (name, specs, PlanExecution, ref snap)
    n_steps = int(rng.integers(6, max_steps + 1))
    ops = rng.choice(
        ["put", "delete", "flush", "compact",
         "query", "scan_query", "semijoin",
         "plan_open", "plan_run", "plan_close"],
        size=n_steps,
        p=[0.22, 0.12, 0.10, 0.06, 0.16, 0.06, 0.10, 0.08, 0.06, 0.04])
    for step, op in enumerate(ops):
        name = ("a", "b")[int(rng.integers(0, 2))]
        coll, ref = colls[name], refs[name]
        msg = (f"[query-diff kind={filter_kind} seed={seed} "
               f"step={step} op={op} coll={name}]")
        if op == "put":
            ks = rng.choice(Q_POOL, size=int(rng.integers(1, 40)))
            vs = rng.integers(1, 2 ** 63, size=len(ks), dtype=np.uint64)
            coll.store.put_batch(ks, vs)
            ref.put_batch(ks, vs)
        elif op == "delete":
            ks = _q_mixed_keys(rng, int(rng.integers(1, 24)), absent_frac=0.15)
            coll.store.delete_batch(ks)
            ref.delete_batch(ks)
        elif op == "flush":
            coll.store.flush()
            ref.flush()
        elif op == "compact":
            coll.store.compact()
            ref.compact()
        elif op in ("query", "scan_query"):
            scan = op == "scan_query"
            specs = _rand_specs(rng, scan_driven=scan)
            cands = None if scan else _q_mixed_keys(
                rng, int(rng.integers(1, 48)))
            res = Pipeline.from_specs(coll, specs).run(cands)
            exp_k, exp_v = ref.plan(specs, cands)
            _check_plan(res, exp_k, exp_v, filter_kind, specs, msg)
        elif op == "semijoin":
            other = "b" if name == "a" else "a"
            base_specs = _rand_specs(rng)
            right_specs = _rand_specs(rng)
            # identity join (both collections share the Q_POOL key space) or
            # value-mapped join keys, chosen per interleaving step
            key_fn = None if rng.random() < 0.7 else (lambda k, v: v)
            cands = _q_mixed_keys(rng, int(rng.integers(1, 48)))
            sj = SemiJoin(
                Pipeline.from_specs(coll, base_specs),
                (JoinStep(colls[other],
                          key_fn=key_fn,
                          stages=Pipeline.from_specs(
                              colls[other], right_specs).stages),))
            res = sj.run(cands)
            exp_k, exp_v, exp_rv = reference_semijoin(
                ref, base_specs, cands, [(refs[other], key_fn, right_specs)])
            np.testing.assert_array_equal(res.keys, exp_k,
                                          err_msg=f"{msg} keys")
            np.testing.assert_array_equal(res.vals, exp_v,
                                          err_msg=f"{msg} vals")
            np.testing.assert_array_equal(res.right_vals[0], exp_rv[0],
                                          err_msg=f"{msg} right vals")
        elif op == "plan_open":
            if len(open_plans) < MAX_OPEN_PLANS:
                specs = _rand_specs(rng)
                ex = Pipeline.from_specs(coll, specs).open()
                open_plans.append((name, specs, ex, ref.snapshot()))
        elif op == "plan_run" and open_plans:
            pname, specs, ex, ref_snap = open_plans[
                int(rng.integers(0, len(open_plans)))]
            pmsg = f"{msg} pinned-on={pname}"
            cands = _q_mixed_keys(rng, int(rng.integers(1, 48)))
            res = ex.run(cands)
            assert res.fences == {pname: ex.view.gen_id}, f"{pmsg} fence"
            exp_k, exp_v = ref_snap.plan(specs, cands)
            _check_plan(res, exp_k, exp_v, filter_kind, specs, pmsg)
        elif op == "plan_close" and open_plans:
            pname, specs, ex, ref_snap = open_plans.pop(
                int(rng.integers(0, len(open_plans))))
            # exit check: the pinned plan still answers from open-time state
            cands = _q_mixed_keys(rng, 24)
            res = ex.run(cands)
            exp_k, exp_v = ref_snap.plan(specs, cands)
            _check_plan(res, exp_k, exp_v, filter_kind, specs,
                        f"{msg} pinned-on={pname}")
            ex.close()
            ref_snap.close()
    # final sweep: every still-open plan must have survived the whole
    # interleaving pinned, then release cleanly; no leaked pins anywhere
    msg = f"[query-diff kind={filter_kind} seed={seed} final]"
    cands = np.concatenate([Q_POOL, Q_ABSENT])
    for pname, specs, ex, ref_snap in open_plans:
        res = ex.run(cands)
        exp_k, exp_v = ref_snap.plan(specs, cands)
        _check_plan(res, exp_k, exp_v, filter_kind, specs,
                    f"{msg} pinned-on={pname}")
        ex.close()
        ref_snap.close()
    for name in ("a", "b"):
        specs = [("tag_in", "tags", tuple(range(N_TAGS // 2))), ("member",)]
        res = Pipeline.from_specs(colls[name], specs).run(cands)
        exp_k, exp_v = refs[name].plan(specs, cands)
        _check_plan(res, exp_k, exp_v, filter_kind, specs,
                    f"{msg} coll={name}")
        assert colls[name].store.open_snapshots == 0, f"{msg} leaked snaps"
        assert colls[name].store.pinned_generations == {}, f"{msg} pins"


# ---------------------------------------------------- store interleavings

S_UNIVERSE = H.random_keys(768, seed=71)
S_POOL = S_UNIVERSE[:512]       # keys ops draw from
S_ABSENT = S_UNIVERSE[512:]     # never written by any op (miss traffic)

FULL_RANGE = (0, 2 ** 64)     # hi == 2**64 includes the max uint64 key


def _s_mixed_keys(rng, n, absent_frac=0.25):
    n_abs = int(round(n * absent_frac))
    parts = [rng.choice(S_POOL, size=n - n_abs)]
    if n_abs:
        parts.append(rng.choice(S_ABSENT, size=n_abs))
    ks = np.concatenate(parts)
    rng.shuffle(ks)
    return ks


def _scan_bounds(rng):
    if rng.random() < 0.15:
        return FULL_RANGE
    a, b = np.sort(rng.choice(S_POOL, size=2, replace=False))
    return int(a), int(b) + int(rng.random() < 0.5)


def _check_scan(store, model, lo, hi, msg):
    """``store``/``model`` may be live stores OR an (engine, oracle)
    snapshot pair — both expose the same scan surface."""
    got_k, got_v = store.scan(lo, hi)
    exp_k, exp_v = model.scan(lo, hi)
    np.testing.assert_array_equal(got_k, exp_k, err_msg=f"{msg} scan keys")
    np.testing.assert_array_equal(got_v, exp_v, err_msg=f"{msg} scan vals")


def _check_get(store, model, keys, msg, *, chained=None):
    found, vals, reads = store.get_batch(keys)
    exp_found, exp_vals = model.get_batch(keys)
    np.testing.assert_array_equal(found, exp_found, err_msg=f"{msg} found")
    np.testing.assert_array_equal(vals, exp_vals, err_msg=f"{msg} vals")
    if chained is None:
        chained = store.filter_kind == "chained"
    if chained:
        assert (reads <= 1).all(), f"{msg}: chained read bound violated"


def _assert_exclusion_sets(store, model, ever_deleted, msg):
    """White-box: deleted-and-gone keys are enrolled as a positive NOWHERE.
    Valid on flushed state only (memtable tombstones haven't touched the
    filters yet) — callers flush first."""
    gone = np.array(
        sorted(ever_deleted - set(model.keys_sorted.tolist())),
        dtype=np.uint64)
    if not len(gone):
        return
    for t, filt in enumerate(store.filters):
        enrolled = np.intersect1d(filt.f2.positive_keys, gone)
        assert enrolled.size == 0, (
            f"{msg}: table {t} still enrolls deleted keys {enrolled[:5]}")


MAX_OPEN_SNAPSHOTS = 4          # bounds pinned generations per interleaving


def run_differential(filter_kind: str, seed: int, max_steps: int = 18,
                     get_cap: int = 48, background: bool = False) -> None:
    """Replay one seeded random interleaving against store + oracle.

    ``background=True`` is the always-on lane: a real
    ``BackgroundCompactor`` thread merges and GC-sweeps WHILE the
    interleaving's gets/scans/snapshot reads run, under a tight seeded
    ``table_cap`` so admission stalls and forced merges actually fire —
    every read (live or pinned) must stay bit-identical to the dict
    oracle with compactions in flight, and the quiesced end state must
    drain below the cap with zero compactor errors."""
    rng = np.random.default_rng([seed, KIND_IDX[filter_kind]])
    kwargs = dict(
        filter_kind=filter_kind,
        bits_per_key=float(rng.choice([6.0, 10.0])),
        fp_alpha=int(rng.choice([6, 8])),
        seed=int(rng.integers(0, 1024)),
        memtable_capacity=int(rng.choice([48, 96, 1 << 30])),
        compact_min_run=int(rng.choice([2, 3])),
        compact_size_ratio=float(rng.choice([2.0, 4.0, 64.0])),
        auto_compact=bool(rng.random() < 0.7))
    if background:
        # tight cap + generous stall bound: admission control stalls
        # instead of raising, and the compactor always unwedges it
        kwargs.update(table_cap=int(rng.choice([3, 5])),
                      stall_timeout_s=30.0)
    store = LsmStore(device="cpu", **kwargs)
    if background:
        store.start_background(poll_s=0.005)
    model = ReferenceStore()
    ever_deleted: set[int] = set()
    chained = filter_kind == "chained"
    snaps: list[tuple] = []         # (engine Snapshot, ReferenceSnapshot)
    n_steps = int(rng.integers(6, max_steps + 1))
    ops = rng.choice(
        ["put", "delete", "get", "scan", "flush", "compact",
         "snap_open", "snap_get", "snap_scan", "snap_close"],
        size=n_steps,
        p=[0.24, 0.14, 0.17, 0.09, 0.10, 0.05, 0.08, 0.05, 0.05, 0.03])
    try:
        for step, op in enumerate(ops):
            msg = (f"[differential kind={filter_kind} seed={seed} "
                   f"step={step} op={op} bg={background}]")
            if op == "put":
                ks = rng.choice(S_POOL, size=int(rng.integers(1, 40)))
                vs = rng.integers(1, 2 ** 63, size=len(ks), dtype=np.uint64)
                store.put_batch(ks, vs)
                model.put_batch(ks, vs)
            elif op == "delete":
                ks = _s_mixed_keys(rng, int(rng.integers(1, 24)),
                                 absent_frac=0.15)
                store.delete_batch(ks)
                model.delete_batch(ks)
                ever_deleted.update(ks.tolist())
            elif op == "get":
                _check_get(store, model,
                           _s_mixed_keys(rng, int(rng.integers(1, get_cap))),
                           msg)
            elif op == "scan":
                lo, hi = _scan_bounds(rng)
                _check_scan(store, model, lo, hi, msg)
            elif op == "flush":
                store.flush()
                model.flush()
            elif op == "compact":
                store.compact()
                model.compact()
            elif op == "snap_open":
                if len(snaps) < MAX_OPEN_SNAPSHOTS:
                    snaps.append((store.snapshot(), model.snapshot()))
            elif op == "snap_get" and snaps:
                s_snap, m_snap = snaps[int(rng.integers(0, len(snaps)))]
                _check_get(s_snap, m_snap,
                           _s_mixed_keys(rng, int(rng.integers(1, get_cap))),
                           msg, chained=chained)
            elif op == "snap_scan" and snaps:
                s_snap, m_snap = snaps[int(rng.integers(0, len(snaps)))]
                lo, hi = _scan_bounds(rng)
                _check_scan(s_snap, m_snap, lo, hi, msg)
            elif op == "snap_close" and snaps:
                s_snap, m_snap = snaps.pop(int(rng.integers(0, len(snaps))))
                # exit check: the snapshot still answers from its open-time
                # state no matter what landed since
                _check_get(s_snap, m_snap, _s_mixed_keys(rng, 24), msg,
                           chained=chained)
                _check_scan(s_snap, m_snap, *FULL_RANGE, msg)
                s_snap.close()
                m_snap.close()
        # final sweep on fully-flushed state: total point/range agreement
        # plus the chained exclusion-set invariant; every still-open
        # snapshot must have survived the whole interleaving and release
        # its pin cleanly
        msg = f"[differential kind={filter_kind} seed={seed} final]"
        store.flush()
        for s_snap, m_snap in snaps:
            _check_get(s_snap, m_snap, S_UNIVERSE, msg, chained=chained)
            _check_scan(s_snap, m_snap, *FULL_RANGE, msg)
            s_snap.close()
            m_snap.close()
        assert store.open_snapshots == 0, f"{msg}: leaked open snapshots"
        assert store.pinned_generations == {}, f"{msg}: leaked generation pins"
        if background:
            # quiesce: compaction debt + deferred GC drain below the cap,
            # and no step on the compactor thread may have failed
            assert store.wait_compaction_idle(timeout_s=30.0), \
                f"{msg}: background compactor never went idle"
            store.stop_background()
            assert store.background_errors == [], \
                f"{msg}: background errors {store.background_errors!r}"
            assert store.n_tables < store.table_cap, \
                f"{msg}: quiesced at {store.n_tables} tables, cap " \
                f"{store.table_cap}"
        _check_get(store, model, S_UNIVERSE, msg)
        _check_scan(store, model, *FULL_RANGE, msg)
        if filter_kind == "chained":
            _assert_exclusion_sets(store, model, ever_deleted, msg)
    finally:
        if background:
            store.stop_background()


# ------------------------------------------------------ fast lanes, as JAX's

@pytest.mark.parametrize("kind,budget", [("chained", 6), ("bloom", 5),
                                         ("none", 5)])
def test_query_differential(kind, budget):
    @given(st.integers(0, 2 ** 32 - 1))
    @settings(max_examples=budget, deadline=None)
    def run(seed):
        run_query_differential(kind, seed)
    run()


@pytest.mark.parametrize("kind,budget", [("chained", 10), ("bloom", 8),
                                         ("none", 8)])
def test_store_differential(kind, budget):
    @given(st.integers(0, 2 ** 32 - 1))
    @settings(max_examples=budget, deadline=None)
    def run(seed):
        run_differential(kind, seed)
    run()


@pytest.mark.parametrize("kind,budget", [("chained", 6), ("bloom", 4),
                                         ("none", 4)])
def test_store_differential_background(kind, budget):
    @given(st.integers(0, 2 ** 32 - 1))
    @settings(max_examples=budget, deadline=None)
    def run(seed):
        run_differential(kind, seed, background=True)
    run()
