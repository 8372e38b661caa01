"""Port parity, the query layer: ``repro_torch.query`` on the CPU against
the JAX ``repro.query`` (its store in Pallas interpret mode, as
``tests/test_query.py`` runs it) on the same seeded store ops, and the
port alone against ``tests/model.py``'s plan oracle for the wider
properties. Tolerance: exact equality everywhere (keys, values, read
counts, survivor counts, tags)."""
import importlib.util
import itertools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro import query as JQ  # noqa: E402
from repro_torch import query as Q  # noqa: E402
from repro_torch.query import (Catalog, JoinStep, Member, Pipeline,  # noqa: E402
                               RangeFence, SemiJoin, TagEq, TagIn, TagIndex)
from repro_torch.serving import TieredPrefixCache, TierSpec  # noqa: E402
from repro_torch.storage import (LatencyAccountant, LsmStore,  # noqa: E402
                                 run_workload, tagged_query)

from model import ReferenceCollection, reference_semijoin  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("chained", "bloom", "none")
TAG_BITS = 4
N_TAGS = 1 << TAG_BITS


def tag_fn(keys, vals):
    return vals & np.uint64(N_TAGS - 1)


def _chip_smoke():
    """``chip_smoke.py`` as a module: its phase-9 helpers take a device."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mk(kind, n=320, seed=9, memtable_capacity=96):
    """Port collection (CPU) + lockstep oracle, loaded and flushed."""
    cat = Catalog()
    coll = cat.create_collection("c", filter_kind=kind, seed=seed,
                                 memtable_capacity=memtable_capacity,
                                 device="cpu")
    coll.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    ref = ReferenceCollection()
    ref.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    rng = np.random.default_rng(seed)
    keys = JH.random_keys(n, seed=seed + 1)
    vals = rng.integers(1, 2 ** 60, n, dtype=np.uint64)
    coll.store.put_batch(keys, vals)
    ref.put_batch(keys, vals)
    coll.store.flush()
    return cat, coll, ref, keys, vals


def _mixed_candidates(keys, seed, n_extra=64, dups=True):
    rng = np.random.default_rng(seed)
    absent = rng.integers(1, 2 ** 63, n_extra, dtype=np.uint64)
    cands = np.concatenate([keys, absent])
    if dups:
        cands = np.concatenate([cands, rng.choice(cands, size=32)])
    rng.shuffle(cands)
    return cands


def _assert_result(res, exp_keys, exp_vals, msg=""):
    np.testing.assert_array_equal(res.keys, exp_keys, err_msg=f"{msg} keys")
    np.testing.assert_array_equal(res.vals, exp_vals, err_msg=f"{msg} vals")


# ------------------------------------------------- the JAX query layer

def _same_plan(p, j, msg):
    for f in ("keys", "vals", "reads"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype, f"{msg} {f} dtype"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f}")
    assert p.fences == j.fences, msg
    assert p.stage_survivors == j.stage_survivors, msg
    assert p.n_candidates == j.n_candidates, msg


@pytest.mark.parametrize("kind", KINDS)
def test_plans_semijoin_and_tags_match_jax(kind):
    """The same ops on a JAX and a port catalog (two collections, deletes,
    rows left in the memtable): every plan, a plan pinned across flush +
    compact, a semijoin and the reassembled tags are equal."""
    rng = np.random.default_rng(31)
    keys = JH.random_keys(384, seed=32)
    vals = rng.integers(1, 2 ** 60, len(keys), dtype=np.uint64)
    r_keys = vals[::2]
    r_vals = rng.integers(1, 2 ** 60, len(r_keys), dtype=np.uint64)
    cats = {"jax": JQ.Catalog(), "port": Catalog()}
    colls = {}
    for side, cat in cats.items():
        kw = {} if side == "jax" else {"device": "cpu"}
        c = cat.create_collection("c", filter_kind=kind, seed=9,
                                  memtable_capacity=1 << 30, **kw)
        o = cat.create_collection("orders", filter_kind=kind, seed=31,
                                  memtable_capacity=1 << 30, **kw)
        for coll in (c, o):
            coll.create_index("tags", tag_fn, tag_bits=TAG_BITS)
        c.store.put_batch(keys, vals)
        c.store.flush()
        c.store.delete_batch(keys[::5])
        c.store.put_batch(keys[1::7], vals[1::7] + np.uint64(3))
        c.store.flush()
        c.store.put_batch(keys[2::11], vals[2::11] + np.uint64(5))  # memtable
        o.store.put_batch(r_keys, r_vals)
        o.store.flush()
        colls[side] = (c, o)
    cands = _mixed_candidates(keys, seed=5)
    ks = np.sort(keys)
    plans = [[("member",)],
             [("tag_eq", "tags", 3), ("range", int(ks[40]), int(ks[300])),
              ("tag_in", "tags", (1, 3, 5)), ("member",)],
             [("tag_in", "tags", (2, 4, 6, 9))]]
    for specs in plans:
        j = JQ.Pipeline.from_specs(colls["jax"][0], specs).run(cands)
        p = Pipeline.from_specs(colls["port"][0], specs).run(cands)
        _same_plan(p, j, f"[{kind} {specs}]")
    scan = [("range", int(ks[20]), int(ks[200])), ("tag_in", "tags", (0, 7))]
    _same_plan(Pipeline.from_specs(colls["port"][0], scan).run(),
               JQ.Pipeline.from_specs(colls["jax"][0], scan).run(),
               f"[{kind} scan]")
    # a plan pinned across flush + compact keeps its captured bank state
    pinned = {}
    for side, (c, _) in colls.items():
        P = JQ.Pipeline if side == "jax" else Pipeline
        pinned[side] = P.from_specs(c, plans[1]).open()
        c.store.put_batch(keys[::3], vals[::3] + np.uint64(1))
        c.store.flush()
        c.store.compact()
    _same_plan(pinned["port"].run(cands), pinned["jax"].run(cands),
               f"[{kind} pinned]")
    for ex in pinned.values():
        ex.close()
    # semijoin through a value-mapped key with a tag stage pushed down
    res = {}
    for side, (c, o) in colls.items():
        M = JQ if side == "jax" else Q
        res[side] = M.SemiJoin(
            M.Pipeline(c, (M.Member(),)),
            (M.JoinStep(o, key_fn=lambda k, v: v,
                        stages=(M.TagIn("tags", tuple(range(12))),)),)
        ).run(cands)
    for f in ("keys", "vals"):
        np.testing.assert_array_equal(getattr(res["port"], f),
                                      getattr(res["jax"], f))
    np.testing.assert_array_equal(res["port"].right_vals[0],
                                  res["jax"].right_vals[0])
    assert res["port"].step_stats == res["jax"].step_stats
    assert res["port"].fences == res["jax"].fences
    # tags reassembled from one probe of the captured state: same dtype,
    # same bits, on the enrolled keys of the current generation
    for i in (0, 1):
        pj, pp = (colls[s][i] for s in ("jax", "port"))
        idx_j, idx_p = pj.indexes["tags"], pp.indexes["tags"]
        gen = pp.store.generation
        assert gen.gen_id == pj.store.generation.gen_id
        live, live_vals = gen.live_items()
        tp = idx_p.bank_tags(idx_p.state_for(gen.gen_id), live)
        tj = idx_j.bank_tags(idx_j.state_for(gen.gen_id), live)
        assert tp.dtype == tj.dtype == np.uint64
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_array_equal(tp, tag_fn(live, live_vals))


# ---------------------------------------------------------------- degeneracy

@pytest.mark.parametrize("kind", KINDS)
def test_single_member_plan_bit_identical_to_get_batch(kind):
    _, coll, _, keys, _ = _mk(kind)
    coll.store.delete_batch(keys[::5])
    coll.store.flush()
    cands = _mixed_candidates(keys, seed=2)
    res = Pipeline(coll, (Member(),)).run(cands)
    found, vals, reads = coll.store.get_batch(cands)
    _assert_result(res, cands[found], vals[found], f"[{kind}]")
    np.testing.assert_array_equal(res.reads, reads)
    assert res.stage_survivors == (("member", int(found.sum())),)
    if kind == "chained":
        assert res.reads.max() <= 1


@pytest.mark.parametrize("kind", KINDS)
def test_stage_reorder_invariance(kind):
    _, coll, ref, keys, _ = _mk(kind, n=256)
    lo, hi = int(keys.min()), int(np.sort(keys)[200])
    stages = (Member(), TagEq("tags", 5), RangeFence(lo, hi),
              TagIn("tags", (1, 5, 9, 13)))
    cands = _mixed_candidates(keys, seed=3)
    exp_k, exp_v = ref.plan([("member",), ("tag_eq", "tags", 5),
                             ("range", lo, hi),
                             ("tag_in", "tags", (1, 5, 9, 13))], cands)
    assert exp_k.size > 0
    for perm in itertools.permutations(stages):
        _assert_result(Pipeline(coll, perm).run(cands), exp_k, exp_v,
                       f"[{kind} perm={perm}]")


@pytest.mark.parametrize("kind", KINDS)
def test_tag_probe_never_returns_dead_key(kind):
    _, coll, _, keys, _ = _mk(kind)
    dead = keys[::2]
    coll.store.delete_batch(dead)
    coll.store.flush()
    coll.store.compact()
    hits = []
    for tag in range(N_TAGS):
        res = Pipeline(coll, (TagEq("tags", tag),)).run(keys)
        assert not np.isin(res.keys, dead).any(), f"[{kind} tag={tag}]"
        assert res.stage_survivors[-1][0] == "resolve"
        hits.append(res.keys)
    np.testing.assert_array_equal(np.sort(np.concatenate(hits)),
                                  np.sort(np.setdiff1d(keys, dead)))


# ---------------------------------------------------------- snapshot pinning

def test_plan_straddles_flush_and_compact():
    _, coll, ref, keys, _ = _mk("chained", memtable_capacity=1 << 30)
    specs = [("tag_in", "tags", (1, 3, 5, 7, 9)),
             ("range", int(keys.min()), int(np.sort(keys)[280])),
             ("member",)]
    ex = Pipeline.from_specs(coll, specs).open()
    fence = ex.fences["c"]
    ref_snap = ref.snapshot()
    new_vals = np.random.default_rng(17).integers(1, 2 ** 60, len(keys),
                                                  dtype=np.uint64)
    for s in (coll.store, ref):
        s.put_batch(keys[::3], new_vals[::3])
        s.delete_batch(keys[1::3])
        s.flush()
        s.compact()
    assert coll.store.generation.gen_id > fence
    cands = _mixed_candidates(keys, seed=4)
    res = ex.run(cands)
    assert res.fences == {"c": fence}
    _assert_result(res, *ref_snap.plan(specs, cands), "[straddle pinned]")
    ex.close()
    _assert_result(Pipeline.from_specs(coll, specs).run(cands),
                   *ref.plan(specs, cands), "[straddle live]")
    assert coll.store.open_snapshots == 0
    assert coll.store.pinned_generations == {}


def test_scan_driven_plan_matches_oracle():
    _, coll, ref, keys, _ = _mk("chained")
    ks = np.sort(keys)
    specs = [("range", int(ks[20]), int(ks[300])),
             ("tag_in", "tags", tuple(range(8)))]
    _assert_result(Pipeline.from_specs(coll, specs).run(),
                   *ref.plan(specs, None), "[scan-driven]")
    with pytest.raises(ValueError):
        Pipeline(coll, (TagEq("tags", 1),)).run(None)


def test_pinned_plan_probes_captured_bank_state():
    _, coll, ref, keys, vals = _mk("chained", memtable_capacity=1 << 30)
    ex = Pipeline(coll, (TagEq("tags", 3),)).open()
    ref_snap = ref.snapshot()
    captured = ex.view.states["tags"]
    for s in (coll.store, ref):          # flip every tag, republish
        s.put_batch(keys, vals + np.uint64(1))
        s.flush()
    assert coll.indexes["tags"].service.state is not captured
    _assert_result(ex.run(keys), *ref_snap.plan([("tag_eq", "tags", 3)], keys),
                   "[captured state]")
    ex.close()
    _assert_result(Pipeline(coll, (TagEq("tags", 3),)).run(keys),
                   *ref.plan([("tag_eq", "tags", 3)], keys), "[current]")


# ------------------------------------------------------------------ semijoin

@pytest.mark.parametrize("kind", KINDS)
def test_semijoin_matches_oracle(kind):
    cat, coll, ref, keys, vals = _mk(kind)
    orders = cat.create_collection("orders", filter_kind=kind, seed=31,
                                   memtable_capacity=96, device="cpu")
    orders.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    r_ref = ReferenceCollection()
    r_ref.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    r_keys = vals[::2]
    r_vals = np.random.default_rng(23).integers(1, 2 ** 60, len(r_keys),
                                                dtype=np.uint64)
    orders.store.put_batch(r_keys, r_vals)
    r_ref.put_batch(r_keys, r_vals)
    orders.store.flush()

    def key_fn(k, v):
        return v

    rspecs = [("tag_in", "tags", tuple(range(12)))]
    sj = SemiJoin(Pipeline(coll, (Member(),)),
                  (JoinStep(orders, key_fn=key_fn,
                            stages=Q.stages_from_specs(rspecs)),))
    cands = _mixed_candidates(keys, seed=5)
    res = sj.run(cands)
    exp_k, exp_v, exp_rv = reference_semijoin(
        ref, [("member",)], cands, [(r_ref, key_fn, rspecs)])
    _assert_result(res, exp_k, exp_v, f"[semijoin {kind}]")
    np.testing.assert_array_equal(res.right_vals[0], exp_rv[0])
    stats = res.step_stats[0]
    assert stats["matched"] == len(res.keys)
    assert set(res.fences) == {"c", "orders"}
    if kind != "none":
        assert stats["materialized"] < stats["candidates"]
    assert coll.store.open_snapshots == orders.store.open_snapshots == 0


# -------------------------------------------------- enrollment & bank states

def test_enrollment_rides_every_publish_and_prunes_states():
    _, coll, _, keys, vals = _mk("chained", memtable_capacity=1 << 30)
    idx = coll.indexes["tags"]
    gen0 = coll.store.generation.gen_id
    assert set(idx._states) == {gen0}
    before = idx.enrollments
    snap = coll.store.snapshot()                 # pins gen0
    coll.store.put_batch(keys[:50], vals[:50] + np.uint64(1))
    coll.store.flush()
    assert idx.enrollments == before + 1
    gen1 = coll.store.generation.gen_id
    assert set(idx._states) == {gen0, gen1}      # pinned state retained
    snap.close()
    coll.store.put_batch(keys[:50], vals[:50] + np.uint64(2))
    coll.store.flush()                           # prunes gen0
    assert set(idx._states) == {coll.store.generation.gen_id}


def test_catalog_registry_and_errors():
    cat, coll, _, _, _ = _mk("chained")
    assert cat.registry.names() == ["c/tags"]
    assert cat.registry.get("c/tags").state is not None
    assert "lookups" in cat.registry.stats()["c/tags"]
    with pytest.raises(ValueError):
        coll.create_index("tags", tag_fn)
    with pytest.raises(KeyError):
        cat["nope"]
    with pytest.raises(ValueError):
        cat.create_collection("c", device="cpu")
    with pytest.raises(KeyError):
        Pipeline(coll, (TagEq("missing", 0),)).run(np.array([1], np.uint64))
    with pytest.raises(ValueError):
        TagIndex("t", tag_fn, tag_bits=17, device="cpu")
    coll.drop_index("tags")
    assert cat.registry.names() == []
    cat.drop_collection("c")
    assert cat.names() == []


def test_entry_points_default_to_the_card():
    """Without a card, an entry point left at its default raises: nothing
    carries on on the CPU unless the caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Catalog().create_collection("c")
    with pytest.raises(RuntimeError, match="CUDA"):
        TagIndex("t", tag_fn)
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredPrefixCache([TierSpec("hbm", 4, 1.0)])


def test_existing_store_is_wrapped_without_a_rebuild():
    """``create_collection(name, store=...)`` only adds a publish hook: the
    generation, its bank and the publish count stay; a ``Member`` plan
    equals ``get_batch`` and a scan-driven plan equals ``scan``."""
    store = LsmStore(filter_kind="chained", memtable_capacity=2 ** 62,
                     auto_compact=False, device="cpu")
    keys = JH.random_keys(3000, seed=4)
    for part in np.array_split(keys, 3):
        store.put_batch(part, part >> np.uint64(13))
        store.flush()
    gen, published = store.generation, store.stats.generations_published
    coll = Catalog().create_collection("main", store=store)
    assert store.generation is gen
    assert store.stats.generations_published == published
    cands = _mixed_candidates(keys, seed=8)
    res = Pipeline(coll, (Member(),)).run(cands)
    found, vals, reads = store.get_batch(cands)
    _assert_result(res, cands[found], vals[found])
    np.testing.assert_array_equal(res.reads, reads)
    ks = np.sort(keys)
    lo, hi = int(ks[100]), int(ks[400])
    res = Pipeline(coll, (RangeFence(lo, hi), Member())).run()
    with store.snapshot() as snap:
        _assert_result(res, *snap.scan(lo, hi))
    store.put_batch(keys[:10], keys[:10])
    store.flush()                               # the hook runs, no index
    assert store.stats.publish_hook_errors == 0
    assert store.open_snapshots == 0


# -------------------------------------------------- workloads + accounting

def test_tagged_query_workload_matches_oracle():
    ops = tagged_query(24, batch=48, n_keys=256, seed=5)
    queries = [o for o in ops if o.kind == "query"]
    assert queries and all(1 <= len(o.stages) <= 3 for o in queries)
    cat = Catalog()
    coll = cat.create_collection("w", filter_kind="chained",
                                 memtable_capacity=128, seed=7, device="cpu")
    coll.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    ref = ReferenceCollection()
    ref.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    acc = LatencyAccountant()
    for op in ops:
        if op.kind == "put":
            coll.store.put_batch(op.keys, op.vals)
            ref.put_batch(op.keys, op.vals)
        else:
            res = Pipeline.from_specs(coll, op.stages).run(op.keys)
            _assert_result(res, *ref.plan(op.stages, op.keys),
                           f"[workload {op.stages}]")
            acc.record(res.reads)
            acc.record_stages(res.survivor_counts)
            counts = res.survivor_counts
            assert all(a >= b for a, b in zip(counts, counts[1:]))
    rep = acc.report()
    assert rep["plans"] == len(queries)
    assert rep["stage_survivors"] == [
        int(sum(c[i] for c in acc.stage_counts if i < len(c)))
        for i in range(len(rep["stage_survivors"]))]


def test_run_workload_dispatches_query_ops():
    ops = tagged_query(10, batch=32, n_keys=128, seed=11)
    coll = Catalog().create_collection("w", filter_kind="chained",
                                       memtable_capacity=64, seed=13,
                                       device="cpu")
    coll.create_index("tags", tag_fn, tag_bits=TAG_BITS)
    out = run_workload(
        coll.store, ops,
        query_fn=lambda op: Pipeline.from_specs(coll, op.stages).run(op.keys))
    assert out["plans"] == sum(1 for o in ops if o.kind == "query")
    assert "stage_survivors" in out
    with pytest.raises(ValueError):
        run_workload(coll.store, ops)


# ------------------------------------- chip_smoke's query cell, CI scale

def test_query_cell_reproduces_the_baseline_counts():
    """``chip_smoke.query_cell`` at ``benchmarks/query_pipeline.py``'s CI
    scale on the CPU: the four seed-determined counts of
    ``BENCH_baseline.json``, exactly, and the fused plan equal to the
    naive plan and the dict model."""
    cs = _chip_smoke()
    name, fields = cs.Q_BASELINE
    base = json.loads((ROOT / "BENCH_baseline.json").read_text())[name]
    out = cs.query_cell(*cs.Q_CI, "cpu", repeat=1)
    assert out["naive_equal"] and out["model_match"]
    assert out["counts"] == {f: base["metrics"][f] for f in fields}
    assert set(out["split_ms"]) == {"overlay", "tag_bank_probe", "get_batch",
                                    "numpy", "total"}
