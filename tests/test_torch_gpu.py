"""The CUDA probe kernels on the card, each held against its plain torch
version (exact equality: integer outputs). Needs a CUDA device and nvcc;
skips elsewhere. This file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core.bloom import BloomFilter  # noqa: E402
from repro_torch.core.bloomier import ExactBloomier, XorFilter  # noqa: E402
from repro_torch.core.chained import (ChainedFilterAnd,  # noqa: E402
                                      ChainedFilterCascade)
from repro_torch.kernels import (_build, bloom_onchip,  # noqa: E402
                                 bloomier_onchip, common, lsm_window, ops,
                                 selfcheck)
from repro_torch.kernels.bloom_probe import (bloom_probe,  # noqa: E402
                                             bloom_probe_onchip)
from repro_torch.kernels.cascade_probe import (cascade_descriptors,  # noqa: E402
                                               cascade_probe,
                                               cascade_probe_onchip)
from repro_torch.kernels.chained_probe import chained_probe  # noqa: E402
from repro_torch.kernels.lsm_probe import (chain_descriptors,  # noqa: E402
                                           lsm_chain_probe, lsm_probe)
from repro_torch.kernels.xor_probe import exact_probe, xor_probe  # noqa: E402
from repro_torch.query import (Catalog, JoinStep, Member,  # noqa: E402
                               Pipeline, RangeFence, SemiJoin, TagEq, TagIn)
from repro_torch.serving import (FilterService, TieredPrefixCache,  # noqa: E402
                                 TierSpec)
from repro_torch.serving.filter_service import layout_sources  # noqa: E402
from repro_torch.storage import LsmStore  # noqa: E402

KERNELS = {"lsm_probe": lsm_probe, "lsm_chain_probe": lsm_chain_probe,
           "bloom_probe": bloom_probe, "xor_probe": xor_probe,
           "exact_probe": exact_probe, "chained_probe": chained_probe,
           "cascade_probe": cascade_probe}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", range(len(selfcheck.edge_cases())),
                         ids=[f"{k}:{n}" for k, n, _ in selfcheck.edge_cases()])
def test_kernel_matches_plain_version(cuda, case):
    kernel, _, arg = selfcheck.edge_cases()[case]
    counter = KERNELS[kernel]
    before = counter.launches
    bad = selfcheck.check_case(kernel, arg, cuda)
    torch.cuda.synchronize()
    assert bad == 0
    assert counter.launches == before + 1


@pytest.mark.parametrize("case", range(len(selfcheck.PARTITION_CASES)),
                         ids=[n for n, _ in selfcheck.PARTITION_CASES])
def test_partition_matches_torch_twin(cuda, case):
    _, args = selfcheck.PARTITION_CASES[case]
    assert selfcheck.check_partition(device=cuda, **args) == 0
    torch.cuda.synchronize()


def test_path_counters_follow_the_eligibility_rule(cuda):
    fuse16 = ("fuse",) * 16
    card = lsm_window.device_bytes(cuda)
    short = ("fuse",) * (lsm_window.MIN_TABLES - 1)
    cases = [(fuse16, None), (fuse16, 1), (fuse16, 20),
             (fuse16, lsm_window.MIN_KEYS), (fuse16, lsm_window.MIN_KEYS - 1),
             (short, lsm_window.MIN_KEYS), (("fuse", "uniform") * 8, None),
             (("fuse", "bloom") * 8, None), (("fuse", "always") * 8, None),
             (("nos1",), None)]
    taken = set()
    for kinds, n in cases:
        words, hi, lo, chains = selfcheck.lsm_case(kinds, cuda, per=1000)
        if n is not None:    # n random keys (most of them miss)
            hi, lo = common.key_lanes(H.random_keys(n, seed=5), cuda)
        desc = torch.from_numpy(chain_descriptors(chains)).to(cuda)
        window = lsm_window.path_reason(chains, hi.numel(), words.data_ptr(),
                                        card) is None
        taken.add(window)
        before = (lsm_probe.window_launches, lsm_probe.gather_launches)
        lsm_probe(words, hi, lo, desc, chains=chains)
        assert (lsm_probe.window_launches - before[0],
                lsm_probe.gather_launches - before[1]) == \
            ((1, 0) if window else (0, 1)), (kinds, n)
        # one table: lsm_chain_probe has the gather kernel only
        before = lsm_chain_probe.launches
        lsm_chain_probe(words, hi, lo, chain=chains[0])
        assert lsm_chain_probe.launches == before + 1
    assert taken == {True, False}        # both paths were taken
    torch.cuda.synchronize()


def test_bloom_path_counters_follow_the_onchip_rule(cuda):
    B = bloom_onchip
    room = selfcheck.ROOM
    taken = set()
    # (bitmap words, keys): staged under, at and past the window of keys
    # the rule takes; a single layer in L2
    for words, n in ((4000, 1), (4000, B.MIN_LOCAL_KEYS - 1),
                     (4000, B.MIN_LOCAL_KEYS), (4000, B.MAX_LOCAL_KEYS),
                     (room + 128, B.MIN_LOCAL_KEYS)):
        tables, (offset,) = selfcheck.bitmap_bank((words,), seed=1, ors=2)
        bank = common.to_device(tables, cuda)
        hi, lo = common.key_lanes(H.random_keys(n, seed=5), cuda)
        layer = (32 * words - 5, 7, 2**31 + 1, offset)
        onchip = B.onchip_reason((layer,), n, bank.numel(),
                                 bank.data_ptr()) is None
        taken.add(onchip)
        before = (bloom_probe.onchip_launches, bloom_probe.gather_launches)
        bloom_probe(bank, hi, lo, m_bits=layer[0], k=layer[1], seed=layer[2],
                    offset=layer[3])
        assert (bloom_probe.onchip_launches - before[0],
                bloom_probe.gather_launches - before[1]) == \
            ((1, 0) if onchip else (0, 1)), (words, n)
    assert taken == {True, False}        # both paths were taken
    # the cascade: a staged span at two batch sizes, a span in L2, and more
    # layers than the on-chip kernel stages
    small = selfcheck.synthetic_cascade((2000,) * 18)
    wide = selfcheck.synthetic_cascade(selfcheck.WIDE_CASCADE)
    deep = selfcheck.synthetic_cascade((128,) * (B.MAX_LAYERS + 1))
    cases = [(small, 5000), (small, B.MIN_LOCAL_KEYS), (wide, 1000),
             (deep, B.MIN_LOCAL_KEYS)]
    taken = set()
    for (tables, layers), n in cases:
        bank = common.to_device(tables, cuda)
        desc = torch.from_numpy(cascade_descriptors(layers)).to(cuda)
        hi, lo = common.key_lanes(H.random_keys(n, seed=6), cuda)
        onchip = B.onchip_reason(layers, n, bank.numel(),
                                 bank.data_ptr()) is None
        taken.add(onchip)
        before = (cascade_probe.onchip_launches,
                  cascade_probe.gather_launches)
        cascade_probe(bank, hi, lo, desc, layers=layers)
        assert (cascade_probe.onchip_launches - before[0],
                cascade_probe.gather_launches - before[1]) == \
            ((1, 0) if onchip else (0, 1)), (len(layers), n)
        if len(layers) > B.MAX_LAYERS:
            with pytest.raises(ValueError):
                cascade_probe_onchip(bank, hi, lo, desc, layers=layers)
    assert taken == {True, False}
    torch.cuda.synchronize()


def test_bloomier_path_counters_follow_the_onchip_rule(cuda):
    B = bloomier_onchip
    # (kernel, tables, keys): a plane that fits one block under and at
    # MIN_KEYS keys, two chained planes in one block, planes over one block
    cases = [("exact_probe", ((16384, 106, 1),), B.MIN_KEYS - 1),
             ("exact_probe", ((16384, 106, 1),), B.MIN_KEYS),
             ("chained_probe", ((2048, 100, 3), (8192, 100, 1)), B.MIN_KEYS),
             ("xor_probe", ((8192, 140, 8),), B.MIN_KEYS),
             ("chained_probe", ((8192, 140, 3), (16384, 140, 1)),
              B.MIN_KEYS)]
    taken = set()
    for kernel, tables, n in cases:
        bank, a = selfcheck.synthetic_bloomier(kernel, tables)
        words = common.to_device(bank, cuda)
        hi, lo = common.key_lanes(H.random_keys(n, seed=8), cuda)
        fits = selfcheck.bloomier_plan(kernel, tables) is not None
        onchip = fits and n >= B.MIN_KEYS
        taken.add(onchip)
        counter = KERNELS[kernel]
        before = (counter.onchip_launches, counter.gather_launches)
        kern, plain = selfcheck.bloomier_calls(kernel, a, words)
        for g, w in zip(kern(hi, lo), plain(hi, lo)):
            assert torch.equal(g, w)
        assert (counter.onchip_launches - before[0],
                counter.gather_launches - before[1]) == \
            ((1, 0) if onchip else (0, 1)), (kernel, tables, n)
        if not fits:                  # the on-chip entry point refuses
            with pytest.raises(ValueError):
                selfcheck.bloomier_calls(kernel, a, words, "onchip")[0](hi, lo)
    assert taken == {True, False}
    torch.cuda.synchronize()


def test_filter_service_planes_on_card(cuda):
    """The service's planes live on the card; a probe of MIN_KEYS queries
    takes exact_probe's on-chip path with them and agrees with the CPU
    service, before and after refresh_tables."""
    keys = H.random_keys(60_000, seed=9)
    pos, neg = keys[:5000], keys[5000:45_000]
    filters = [XorFilter.build(pos, 8, seed=12),
               ExactBloomier.build(pos[:2500], neg[:5000], seed=13),
               ChainedFilterAnd.build(pos, neg, seed=14)]
    q = np.random.default_rng(7).choice(keys, bloomier_onchip.MIN_KEYS)
    gpu, cpu = (FilterService(filters, device=d) for d in (cuda, "cpu"))
    assert all(p.words.is_cuda for pl in gpu.state.planes for p in pl)
    before = exact_probe.onchip_launches
    for g, w in zip(gpu.probe(q), cpu.probe(q)):
        np.testing.assert_array_equal(g, w)
    assert exact_probe.onchip_launches == before + 1
    filters[0].tbl.table[:] ^= np.uint32(1)       # new contents
    gpu.refresh_tables(filters)
    cpu.refresh_tables(filters)
    for g, w in zip(gpu.probe(q), cpu.probe(q)):
        np.testing.assert_array_equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["chained", "bloom", "none"])
def test_store_on_card_matches_store_on_cpu(cuda, kind):
    keys = H.random_keys(40_000, seed=3)
    stores = [LsmStore(filter_kind=kind, memtable_capacity=3000, seed=7,
                       bits_per_key=9.0, device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(1)
    for i in range(10):
        ks = keys[i * 2500:(i + 1) * 2500]
        dead = rng.choice(keys[:(i + 1) * 2500], 300, replace=False)
        for s in stores:
            s.put_batch(ks, ks >> np.uint64(5))
            s.delete_batch(dead)
    q = np.concatenate([keys[:25_000], keys[-10_000:]])
    before = lsm_probe.launches
    got, want = stores[0].get_batch(q), stores[1].get_batch(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert lsm_probe.launches == before + 1
    assert stores[0].stats.as_dict()["sstable_reads"] == \
        stores[1].stats.as_dict()["sstable_reads"]
    if kind != "none":
        m_gpu, p_gpu = stores[0].service.probe(q)
        m_cpu, p_cpu = stores[1].service.probe(q)
        np.testing.assert_array_equal(m_gpu, m_cpu)
        np.testing.assert_array_equal(p_gpu, p_cpu)


def test_kernels_reject_what_they_cannot_take(cuda):
    tables, chains, _, _ = selfcheck.edge_bank(("fuse",), per=200)
    words = torch.from_numpy(tables.view(np.int32).copy()).to(cuda)
    desc = torch.from_numpy(chain_descriptors(chains)).to(cuda)
    hi = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # key lanes on another device
        lsm_probe(words, hi, hi.cpu(), desc, chains=chains)
    with pytest.raises(ValueError):        # descriptors on another device
        lsm_probe(words, hi, hi, desc.cpu(), chains=chains)
    with pytest.raises(ValueError):
        lsm_probe(words, hi, hi, desc.repeat(33, 1), chains=chains * 33)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    first, mask = lsm_probe(words, empty, empty, desc, chains=chains)
    assert first.numel() == mask.numel() == 0


def test_filter_service_on_card_matches_cpu(cuda):
    keys = H.random_keys(50_000, seed=9)
    n = 5000
    pos, neg = keys[:n], keys[n:9 * n]
    filters = [BloomFilter.build(pos, 0.01, seed=11),
               XorFilter.build(pos, 8, seed=12),
               ExactBloomier.build(pos[:n // 2], neg[:n], seed=13),
               ChainedFilterAnd.build(pos, neg, seed=14),
               ChainedFilterCascade.build(pos, neg, seed=3)]
    q = np.random.default_rng(7).choice(keys, 30_000)
    gpu, cpu = (FilterService(filters, device=d) for d in (cuda, "cpu"))
    before = {k: f.launches for k, f in KERNELS.items()}
    got, want = gpu.probe(q), cpu.probe(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in ("bloom_probe", "xor_probe", "exact_probe", "chained_probe",
                 "cascade_probe"):
        assert KERNELS[name].launches == before[name] + 1
    assert gpu.stats.as_dict() == cpu.stats.as_dict()
    for f, fn in zip(filters, (ops.bloom_query, ops.xor_query,
                               ops.exact_query, ops.chained_query,
                               ops.cascade_query)):
        np.testing.assert_array_equal(fn(f, q, device=cuda), f.query(q))


def test_filter_kernels_reject_what_they_cannot_take(cuda):
    tables, lay, _, _ = selfcheck.filter_case("chained_probe", "stage 1",
                                              per=200)
    words = torch.from_numpy(tables.view(np.int32).copy()).to(cuda)
    hi = torch.zeros(16, dtype=torch.int32, device=cuda)
    x = dict(mode=lay.xor.mode, seed=lay.xor.seed, seg_len=lay.xor.seg_len,
             n_seg=lay.xor.n_seg, offset=lay.xor.offset)
    with pytest.raises(ValueError):        # key lanes on another device
        xor_probe(words, hi, hi.cpu(), alpha=3, fp_seed=1, **x)
    with pytest.raises(TypeError):
        xor_probe(words, hi.to(torch.int64), hi, alpha=3, fp_seed=1, **x)
    with pytest.raises(ValueError):        # outside the bank
        exact_probe(words[:128], hi, hi, strategy="a", bit_seed=1, **x)
    with pytest.raises(ValueError):
        chained_probe(words, hi, hi[:8], **ops.chained_and_params(lay))
    layers = ((64, 3, 1, 0),)
    desc = torch.from_numpy(cascade_descriptors(layers)).to(cuda)
    with pytest.raises(ValueError):        # descriptors on another device
        cascade_probe(words, hi, hi, desc.cpu(), layers=layers)
    with pytest.raises(ValueError):
        cascade_probe(words, hi, hi, desc, layers=((2**31, 3, 1, 0),))
    for probe in (bloom_probe, bloom_probe_onchip):
        with pytest.raises(ValueError):    # k < 0
            probe(words, hi, hi, m_bits=64, k=-1, seed=1, offset=0)
        with pytest.raises(ValueError):    # the bitmap runs past the bank
            probe(words, hi, hi, m_bits=64, k=3, seed=1,
                  offset=words.numel() - 1)

    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert xor_probe(words, empty, empty, alpha=3, fp_seed=1, **x).numel() == 0
    for out in (chained_probe(words, empty, empty,
                              **ops.chained_and_params(lay)),
                cascade_probe(words, empty, empty, desc, layers=layers)):
        assert all(o.numel() == 0 for o in out)


def test_prepare_warm_builds_every_library_the_bank_can_route_to(
        cuda, tmp_path, monkeypatch):
    """From an empty build directory, ``prepare(warm=True)`` leaves a
    library of every source the bank's layouts can route to, and the
    first probes after ``publish`` (gather and on-chip paths) build
    nothing more."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    keys = H.random_keys(60_000, seed=9)
    pos, neg = keys[:5000], keys[5000:45_000]
    filters = [BloomFilter.build(pos, 0.01, seed=11),
               XorFilter.build(pos, 8, seed=12),
               ExactBloomier.build(pos[:2500], neg[:5000], seed=13),
               ChainedFilterAnd.build(pos, neg, seed=14),
               ChainedFilterCascade.build(pos, neg, seed=3)]
    svc = FilterService(filters, device=cuda)
    assert not list(tmp_path.glob("*.so"))
    state = svc.prepare(filters, warm=True)
    want = layout_sources(state.bank.layouts)
    built = {p.name.rsplit("-", 1)[0] for p in tmp_path.glob("*.so")}
    assert built == want
    svc.publish(state)
    for n in (1024, bloomier_onchip.MIN_KEYS):
        svc.probe(np.random.default_rng(n).choice(keys, n))
    torch.cuda.synchronize()
    assert {p.name.rsplit("-", 1)[0] for p in tmp_path.glob("*.so")} == want


def _tag_fn(keys, vals):
    return vals & np.uint64(15)


def test_query_layer_on_card_matches_cpu(cuda):
    """A tagged collection, a 4-stage plan, a scan-driven plan and a
    semijoin on the card equal the same on the CPU."""
    keys = H.random_keys(30_000, seed=21)
    vals = np.random.default_rng(2).integers(1, 2 ** 60, len(keys),
                                             dtype=np.uint64)
    out = {}
    for d in (cuda, "cpu"):
        cat = Catalog()
        ev = cat.create_collection("events", seed=3, device=d,
                                   memtable_capacity=2 ** 62,
                                   auto_compact=False)
        orders = cat.create_collection("orders", seed=11, device=d,
                                       memtable_capacity=2 ** 62,
                                       auto_compact=False)
        for c in (ev, orders):
            c.create_index("tags", _tag_fn)
        for part in np.array_split(np.arange(20_000), 4):
            ev.store.put_batch(keys[part], vals[part])
            ev.store.flush()
        ev.store.delete_batch(keys[:500])
        orders.store.put_batch(keys[::4], vals[::4] + np.uint64(1))
        orders.store.flush()
        ks = np.sort(keys[:20_000])
        stages = (TagEq("tags", 3), RangeFence(int(ks[5000]), int(ks[15000])),
                  TagIn("tags", (1, 3, 5)), Member())
        plan = Pipeline(ev, stages).run(keys)
        scan = Pipeline(ev, (RangeFence(int(ks[100]), int(ks[900])),
                             TagIn("tags", (0, 1, 2)))).run()
        sj = SemiJoin(Pipeline(ev, (Member(),)),
                      (JoinStep(orders, stages=(TagIn("tags", (2, 4)),)),)
                      ).run(keys)
        out[str(d)] = (plan, scan, sj)
    (pg, sg, jg), (pc, sc, jc) = out["cuda"], out["cpu"]
    for g, c in ((pg, pc), (sg, sc)):
        for f in ("keys", "vals", "reads"):
            np.testing.assert_array_equal(getattr(g, f), getattr(c, f))
        assert g.stage_survivors == c.stage_survivors
    for f in ("keys", "vals"):
        np.testing.assert_array_equal(getattr(jg, f), getattr(jc, f))
    np.testing.assert_array_equal(jg.right_vals[0], jc.right_vals[0])
    assert jg.step_stats == jc.step_stats


def test_prefix_cache_on_card_matches_cpu(cuda):
    tiers = [TierSpec("hbm", 8, 1.0), TierSpec("dram", 32, 10.0),
             TierSpec("ssd", 128, 150.0)]
    caches = [TieredPrefixCache(tiers, seed=5, device=d)
              for d in (cuda, "cpu")]
    rng = np.random.default_rng(3)
    keys = rng.integers(1, 2 ** 62, 300).tolist()
    probe = keys + rng.integers(2 ** 62, 2 ** 63, 300).tolist()
    before = bloom_probe.launches
    got = []
    for pc in caches:
        res = []
        for part in range(2):
            for i in range(part * 150, (part + 1) * 150):
                pc.insert(keys[i], payload=i)
            res += pc.lookup_batch(probe[part * 300:(part + 1) * 300])
        got.append(res)
    assert got[0] == got[1]
    assert caches[0].stats() == caches[1].stats()
    assert bloom_probe.launches == before + 2 * len(tiers)
