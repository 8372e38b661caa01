"""Port parity, layer 3: the host write path (filter builds, batched
exclusions, packing) and the whole LSM store — the PyTorch port on the CPU
against the JAX package, in lock-step on the same seeded op streams.
Tolerance: exact equality (buffers, layouts, integer and boolean results)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.core.bloom import BloomFilter as JBloom  # noqa: E402
from repro.core.bloomier import XorFilter as JXor  # noqa: E402
from repro.core.lsm import ChainedTableFilter as JChained  # noqa: E402
from repro.core.othello import DynamicExactFilter as JDyn  # noqa: E402
from repro.serving.filter_service import FilterService as JService  # noqa: E402
from repro.storage import LsmStore as JStore  # noqa: E402
from repro.storage import workloads as JW  # noqa: E402
from repro_torch.core.bloom import BloomFilter  # noqa: E402
from repro_torch.core.bloomier import XorFilter  # noqa: E402
from repro_torch.core.lsm import ChainedTableFilter, LsmLevelChained  # noqa: E402
from repro_torch.core.othello import DynamicExactFilter  # noqa: E402
from repro_torch.core.tables import layout_from_dict  # noqa: E402
from repro_torch.serving.filter_service import FilterBank, FilterService  # noqa: E402
from repro_torch.storage import LsmStore, Generation  # noqa: E402
from repro_torch.storage import workloads as W  # noqa: E402

KEYS = JH.random_keys(30_000, seed=17)


def _same_tables(port, ref):
    """to_tables() of a port filter and a JAX filter: identical bytes and
    an identical layout."""
    (pt, pl), (rt, rl) = port.to_tables(), ref.to_tables()
    assert pt.dtype == rt.dtype == np.uint32
    assert pt.tobytes() == rt.tobytes()
    assert type(pl).__name__ == type(rl).__name__
    assert dataclasses.asdict(pl) == dataclasses.asdict(rl)


@pytest.mark.parametrize("mode,alpha,seed", [("fuse", 7, 0), ("uniform", 9, 3),
                                             ("fuse", 32, 5), ("uniform", 1, 8)])
def test_xor_filter_tables_identical(mode, alpha, seed):
    ks = KEYS[:1500]
    port = XorFilter.build(ks, alpha, mode=mode, seed=seed)
    ref = JXor.build(ks, alpha, mode=mode, seed=seed)
    _same_tables(port, ref)
    q = KEYS[:4000]
    np.testing.assert_array_equal(port.query(q), ref.query(q))
    back = XorFilter.from_tables(*ref.to_tables())
    np.testing.assert_array_equal(back.query(q), ref.query(q))


def test_dynamic_exact_filter_identical_through_exclude_include():
    pos, neg = KEYS[:800], KEYS[800:1600]
    port = DynamicExactFilter.build(pos, neg, seed=2**31 + 1)
    ref = JDyn.build(pos, neg, seed=2**31 + 1)
    _same_tables(port, ref)
    steps = [("exclude", KEYS[1600:2400]),          # new negatives (unions)
             ("include", KEYS[2400:2600]),          # new positives
             ("exclude", KEYS[:50]),                # value flips: reassign
             ("include", KEYS[800:900]),            # flips back
             ("exclude", KEYS[2600:6000])]          # dense batch: cycles
    for op, ks in steps:
        getattr(port, op)(ks)
        getattr(ref, op)(ks)
        _same_tables(port, ref)
        np.testing.assert_array_equal(port.positive_keys, ref.positive_keys)
    q = KEYS[:7000]
    np.testing.assert_array_equal(port.query(q), ref.query(q))
    back = DynamicExactFilter.from_tables(*ref.to_tables())
    np.testing.assert_array_equal(back.query(q), ref.query(q))


def test_chained_and_bloom_filters_identical():
    own, older = np.sort(KEYS[:1200]), KEYS[1200:5000]
    port = ChainedTableFilter.build(own, older, fp_alpha=7, seed1=4, seed2=9)
    ref = JChained.build(own, older, fp_alpha=7, seed1=4, seed2=9)
    _same_tables(port, ref)
    new, dead = KEYS[5000:9000], KEYS[100:300]
    port.exclude_new(own, new)
    ref.exclude_new(own, new)
    port.exclude_deleted(dead)
    ref.exclude_deleted(dead)
    _same_tables(port, ref)
    q = KEYS[:10_000]
    np.testing.assert_array_equal(port.query(q), ref.query(q))
    back = ChainedTableFilter.from_tables(*ref.to_tables())
    np.testing.assert_array_equal(back.query(q), ref.query(q))
    pb = BloomFilter.build(KEYS[:2000], 0.01, seed=2**31 + 3)
    rb = JBloom.build(KEYS[:2000], 0.01, seed=2**31 + 3)
    _same_tables(pb, rb)
    back = BloomFilter.from_tables(*rb.to_tables())
    np.testing.assert_array_equal(back.query(q), rb.query(q))


def test_filter_service_matches_jax_service():
    cf = JChained.build(KEYS[:600], KEYS[600:2500], seed1=1, seed2=2)
    dyn = JDyn.build(KEYS[:400], KEYS[400:1200], seed=3)
    bf = JBloom.build(KEYS[:900], 0.02, seed=5)
    q = KEYS[:3000]
    want_m, want_p = JService([cf, bf, dyn]).probe(q)
    port = [ChainedTableFilter.build(KEYS[:600], KEYS[600:2500], seed1=1,
                                     seed2=2),
            BloomFilter.build(KEYS[:900], 0.02, seed=5),
            DynamicExactFilter.build(KEYS[:400], KEYS[400:1200], seed=3)]
    svc = FilterService(port, device="cpu")
    got_m, got_p = svc.probe(q)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_p, want_p)
    assert svc.stats.lookups == len(q)
    np.testing.assert_array_equal(svc.stats.hits, want_m.sum(axis=1))
    np.testing.assert_array_equal(svc.probe_filter(1, q), want_m[1])
    state = svc.state
    port[0].exclude_new(np.sort(KEYS[:600]), KEYS[5000:8000])
    svc.refresh_tables(port)
    assert svc.version == state.version + 1
    np.testing.assert_array_equal(svc.probe(q, state=state)[0], want_m)
    unpacked = FilterBank.pack(port).unpack()
    np.testing.assert_array_equal(unpacked[0].query(q), port[0].query(q))


def _op_stream(seed, n_ops=28):
    """Seeded puts / deletes / gets / scans / flushes / compactions over
    overlapping key ranges (overwrites, deletes of flushed keys, misses)."""
    rng = np.random.default_rng(seed)
    pool = KEYS[:6000]
    ops = []
    for i in range(n_ops):
        r = rng.random()
        if r < 0.45 or i < 3:
            ks = rng.choice(pool, 700, replace=False)
            ops.append(("put", ks, ks * np.uint64(3) + np.uint64(i)))
        elif r < 0.6:
            ops.append(("del", rng.choice(pool, 250, replace=False), None))
        elif r < 0.8:
            ops.append(("get", np.concatenate(
                [rng.choice(pool, 1500), KEYS[-1000:]]), None))
        elif r < 0.88:
            lo, hi = np.sort(rng.choice(pool, 2))
            ops.append(("scan", int(lo), int(hi)))
        elif r < 0.96:
            ops.append(("flush", None, None))
        else:
            ops.append(("compact", None, None))
    ops.append(("get", KEYS[:7000], None))
    return ops


def _stats(store):
    d = store.stats.as_dict()
    d.pop("stall_time_s")
    return d


@pytest.mark.parametrize("kind", ["chained", "bloom", "none"])
def test_store_lock_step_with_jax_store(kind):
    cfg = dict(filter_kind=kind, memtable_capacity=1800, seed=13,
               compact_min_run=3, bits_per_key=9.0)
    ref = JStore(**cfg)
    port = LsmStore(device="cpu", **cfg)
    for op, a, b in _op_stream(seed=len(kind)):
        if op == "put":
            ref.put_batch(a, b)
            port.put_batch(a, b)
        elif op == "del":
            ref.delete_batch(a)
            port.delete_batch(a)
        elif op == "get":
            for got, want in zip(port.get_batch(a), ref.get_batch(a)):
                np.testing.assert_array_equal(got, want)
        elif op == "scan":
            for got, want in zip(port.scan(a, b), ref.scan(a, b)):
                np.testing.assert_array_equal(got, want)
        else:
            getattr(ref, op)()
            getattr(port, op)()
    assert _stats(port) == _stats(ref)
    assert port.stats.gets > 0 and port.n_tables == ref.n_tables
    gp, gr = port.generation, ref.generation
    assert gp.chains == gr.chains
    assert gp.tables.tobytes() == gr.tables.tobytes()
    assert gp.params.tobytes() == gr.params.tobytes()
    if kind == "chained":
        assert port.stats.compactions > 0 and port.stats.deletes > 0
        assert port.stats.wasted_reads <= port.stats.probed


def test_generation_from_numpy_probes_like_jax_generation():
    ref = JStore(seed=21, memtable_capacity=2**62, auto_compact=False)
    for i in range(5):
        ks = KEYS[i * 900:(i + 1) * 900]
        ref.put_batch(ks, ks)
        if i == 3:
            ref.delete_batch(KEYS[:300])
        ref.flush()
    g = ref.generation
    port = Generation.from_numpy(
        g.gen_id, [(t.keys, t.vals, t.tombs) for t in g.sstables],
        g.chains, g.tables, g.filter_bits, device="cpu")
    assert port.params.tobytes() == g.params.tobytes()
    q = KEYS[:6000]
    for got, want in zip(port.probe_batch(q), g.probe_batch(q)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port.live_items(), g.live_items()):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):            # frozen like the reference
        port.sstables[0].keys[0] = 1
    # a JAX-packed bank rebuilds port filters that query like the JAX ones
    lays = ref.service.bank.layouts
    port_lays = [layout_from_dict(type(lay).__name__, dataclasses.asdict(lay))
                 for lay in lays]
    for lay, f in zip(port_lays, ref.filters):
        back = ChainedTableFilter.from_tables(g.tables, lay)
        np.testing.assert_array_equal(back.query(q), f.query(q))


def test_store_matches_host_model_and_workload_generators():
    store = LsmStore(device="cpu", seed=1, memtable_capacity=2**62,
                     auto_compact=False)
    for i in range(6):
        ks = KEYS[i * 1000:(i + 1) * 1000]
        store.put_batch(ks, ks >> np.uint64(13))
        store.flush()
    lvl = LsmLevelChained.from_parts(store.sstables, store.filters, seed=1)
    sample = np.concatenate([KEYS[:6000:40], KEYS[-150:]])
    found, vals, reads = store.get_batch(sample)
    ref = [lvl.point_query(int(k)) for k in sample]
    np.testing.assert_array_equal(found, [r[0] for r in ref])
    np.testing.assert_array_equal(reads, [r[1] for r in ref])
    np.testing.assert_array_equal(vals[found], sample[found] >> np.uint64(13))
    for gen in ("uniform_write_heavy", "zipfian_read_heavy",
                "mixed_read_write", "crud_mixed", "tagged_query"):
        a = getattr(W, gen)(6, batch=64, seed=4)
        b = getattr(JW, gen)(6, batch=64, seed=4)
        assert [o.kind for o in a] == [o.kind for o in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.keys, y.keys)
            assert (x.lo, x.hi, x.stages) == (y.lo, y.hi, y.stages)
    ops = W.crud_mixed(24, batch=128, seed=2)
    rp = W.run_workload(LsmStore(device="cpu", memtable_capacity=500), ops)
    rj = JW.run_workload(JStore(memtable_capacity=500), ops)
    assert rp == rj


def test_background_compactor_and_snapshots_on_port_store():
    store = LsmStore(device="cpu", memtable_capacity=400, seed=2)
    bg = store.start_background(poll_s=0.005)
    try:
        for i in range(12):
            ks = KEYS[i * 400:(i + 1) * 400]
            store.put_batch(ks, ks)
        snap = store.snapshot()
        store.delete_batch(KEYS[:200])
        store.flush()
        assert store.wait_compaction_idle(timeout_s=60)
    finally:
        store.stop_background()
    assert not bg.errors and not bg.running
    assert store.stats.bg_compactions > 0
    found, vals, reads = store.get_batch(KEYS[:4800])
    assert not found[:200].any() and found[200:].all()
    np.testing.assert_array_equal(vals[200:], KEYS[200:4800])
    assert reads.max() <= 1
    sf, _, sr = snap.get_batch(KEYS[:4800])
    assert sf.all() and sr.max() <= 1               # the pinned view
    snap.close()
    assert store.open_snapshots == 0


def test_port_reproduces_the_baseline_read_counts():
    """The committed lsm_store grid (CI scale: 8 tables x 2048 keys, 4096
    queries) through the port: its avg SSTable reads are deterministic and
    must equal the JAX package's recorded ones exactly."""
    import json
    import pathlib
    base = json.loads((pathlib.Path(__file__).parents[1]
                       / "BENCH_baseline.json").read_text())
    want = base["lsm_store (batched storage engine)"]["metrics"]["avg_reads"]
    per, n_tables, n_q = 2048, 8, 4096
    keys = JH.random_keys(per * (n_tables + 1) + n_q, seed=42)
    exist = np.random.default_rng(7).choice(keys[:per * n_tables], n_q,
                                            replace=False)
    miss = keys[per * n_tables:per * n_tables + n_q]

    def build(kind, bpk=0.0):
        s = LsmStore(filter_kind=kind, bits_per_key=bpk, seed=1,
                     memtable_capacity=2**62, auto_compact=False,
                     device="cpu")
        for i in range(n_tables):
            ks = keys[i * per:(i + 1) * per]
            s.put_batch(ks, ks >> np.uint64(13))
            s.flush()
        return s

    chained = build("chained")
    bpk = chained.filter_bits / (per * n_tables)
    stores = {"chained": chained, "bloom-0x": build("none"),
              "bloom-1x": build("bloom", bpk), "bloom-2x": build("bloom", 2 * bpk)}
    for name, s in stores.items():
        for qn, qs in (("exist", exist), ("miss", miss)):
            _, _, reads = s.get_batch(qs)
            assert float(reads.mean()) == want[f"{name}_{qn}"], (name, qn)
