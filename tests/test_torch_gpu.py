"""The CUDA probe kernels on the card, each held against its plain torch
version (exact equality: integer outputs). Needs a CUDA device and nvcc;
skips elsewhere. This file imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import math

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


def _chip_smoke():
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_llama_two_layers_card_matches_cpu(cuda):
    """llama3.2-1b FULL widths cut to 2 layers, f32 with TF32 off, the same
    numpy weights on the card and on the CPU: prefill and 4 decode steps
    within 1e-3 of the largest logit."""
    import dataclasses
    from repro_torch.configs.llama3_2_1b import FULL
    from repro_torch.models import common as MC
    from repro_torch.models.transformer import TransformerLM
    cs = _chip_smoke()
    m = TransformerLM(dataclasses.replace(FULL, n_layers=2))
    np_params = cs.numpy_params(m.param_specs(), seed=1)
    prompt = np.random.default_rng(2).integers(0, FULL.vocab, 64)
    tf32, was = torch.backends.cuda.matmul.allow_tf32, MC.COMPUTE_DTYPE
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    try:
        got = [cs.forced_logits(m, MC.params_from_numpy(np_params, d), prompt,
                                [1, 2, 3, 4], 128, d) for d in (cuda, "cpu")]
    finally:
        MC.set_compute_dtype(was)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(*got):
        assert np.abs(a - b).max() <= cs.CARD_CPU_REL * np.abs(b).max()


def test_serve_engine_on_card_matches_cpu(cuda):
    """The smoke llama at bf16 served on the card and on the CPU by
    ``chip_smoke.serve_cell``: no fault, equal stats, one ``bloom_probe``
    launch a tier a run on the card, none on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import common as MC
    cs = _chip_smoke()
    m = get_arch(cs.LM_ARCH).model(smoke=True)
    p = MC.init_from_specs(m.param_specs(),
                           torch.Generator().manual_seed(0), "cpu")

    def reset():
        bloom_probe.launches = 0

    kw = dict(prompt_len=16, max_new=4, max_len=32)
    card = cs.serve_cell(m, p, cuda, reset=reset,
                         read=lambda: bloom_probe.launches, **kw)
    cpu = cs.serve_cell(m, p, "cpu", reset=reset,
                        read=lambda: bloom_probe.launches, **kw)
    assert cs.serve_faults(card, cpu) == []
    assert [r["launches"] for r in card["runs"]] == [3, 3]
    assert card["fresh_launches"] == 3
    assert [r["launches"] for r in cpu["runs"]] == [0, 0]


def test_matmul_f32_backward_on_card(cuda):
    """``matmul_f32`` of bf16 operands on the card: an f32 result equal to
    the f32 product of the same values (within f32 summation order), and
    its backward the transpose of the reference's einsum: the cotangent
    rounded to bf16, bf16 gradients within one bf16 rounding of the f32
    products, the f32 weight's gradient through the cast in f32."""
    from repro_torch.models import common as MC
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(2, 64, 256, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(256, 384, generator=g, device=cuda) * 0.05
    x.requires_grad_(True)
    w.requires_grad_(True)
    out = MC.matmul_f32(x, w.to(torch.bfloat16))
    assert out.dtype == torch.float32 and out.shape == (2, 64, 384)
    want = x.detach().float() @ w.detach().to(torch.bfloat16).float()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    cot = torch.randn(2, 64, 384, generator=g, device=cuda)
    dx, dw = torch.autograd.grad(out, (x, w), cot)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    c16 = cot.to(torch.bfloat16).float().reshape(-1, 384)
    want_dx = (c16 @ w.detach().to(torch.bfloat16).float().t()).reshape(x.shape)
    want_dw = x.detach().float().reshape(-1, 256).t() @ c16
    torch.testing.assert_close(dx.float(), want_dx, rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(dw, want_dw, rtol=2 ** -7, atol=1e-3)


def test_train_step_two_layers_card_matches_cpu(cuda):
    """llama3.2-1b FULL widths cut to 2 layers, f32 with TF32 off: one
    train step (``chip_smoke.train_step_parts``: loss, gradients, AdamW
    from a carried state) on the card against the CPU, within phase 11's
    tolerances."""
    import dataclasses
    from repro_torch.configs.llama3_2_1b import FULL
    from repro_torch.models import common as MC
    from repro_torch.models.transformer import TransformerLM
    cs = _chip_smoke()
    m = TransformerLM(dataclasses.replace(FULL, n_layers=2), remat=True,
                      q_chunk=512)
    np_p = cs.numpy_params(m.param_specs(), seed=1)
    np_o = cs.carried_opt_state(np_p, step=10)
    toks = np.random.default_rng(2).integers(0, FULL.vocab, (1, 65))
    tf32, was = torch.backends.cuda.matmul.allow_tf32, MC.COMPUTE_DTYPE
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    try:
        card, cpu = (cs.train_step_parts(m, np_p, np_o, toks, d)
                     for d in (cuda, "cpu"))
    finally:
        MC.set_compute_dtype(was)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(card[0] - cpu[0]) <= cs.TRAIN_LOSS_REL * abs(cpu[0])
    assert max(cs.rel_l2(a, b) for a, b in zip(card[1], cpu[1])) <= \
        cs.TRAIN_GRAD_REL
    assert max(cs.rel_l2(a, b) for a, b in zip(card[2], cpu[2])) <= \
        cs.TRAIN_PARAM_REL


def test_smoke_train_step_is_deterministic_on_card(cuda):
    """The smoke llama's bf16 loss and gradients twice on the card under
    ``torch.use_deterministic_algorithms(True)``: bit for bit the same
    (the embedding's scatter sorts its repeated tokens). ``warn_only``:
    torch asks cuBLAS's workspace to be fixed by an environment variable
    before cuBLAS starts; on one stream its products repeat anyway, which
    this test checks."""
    import warnings
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import common as MC
    m = get_arch("llama3.2-1b").model(smoke=True, remat=True, q_chunk=512)
    p = MC.init_from_specs(m.param_specs(),
                           torch.Generator(cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 8, (2, 33)).astype(np.int32)).to(cuda)      # repeated tokens
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    was = MC.COMPUTE_DTYPE
    MC.set_compute_dtype(torch.bfloat16)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            runs = [loss_and_grads(m, p, batch) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
        MC.set_compute_dtype(was)
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(MC.tree_leaves(g1),
                                                 MC.tree_leaves(g2)))


def test_moe_block_card_matches_cpu(cuda):
    """``moe_block`` at deepseek-v2-lite's widths (d_model 2048, 64
    experts of d_ff 1408, top-6) over 256 tokens, f32 with TF32 off, the
    same weights on the card and on the CPU: equal expert ids and dropped
    pairs, outputs within 1e-5 of the largest, and the gradients of x and
    every weight (the backward through the index dispatch) within 1e-4
    relative L2."""
    from repro_torch.models import common as MC
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    D, F, E, k = 2048, 1408, 64, 6
    x = rng.normal(size=(1, 256, D)).astype(np.float32)
    w = {"router": rng.normal(size=(D, E)) / np.sqrt(D),
         "wi_gate": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wi_up": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wo": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    cot = rng.normal(size=x.shape).astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for d in (cuda, "cpu"):
            tx = torch.from_numpy(x).to(d).requires_grad_(True)
            tw = {n: torch.from_numpy(a.astype(np.float32)).to(d)
                  .requires_grad_(True) for n, a in w.items()}
            with cs.recorded_routes() as routed:
                y = MC.moe_block(tx, tw, n_experts=E, top_k=k)
            grads = torch.autograd.grad(
                torch.sum(y * torch.from_numpy(cot).to(d)), [tx, *tw.values()])
            runs.append((y.detach().cpu().numpy(), routed,
                         [g.cpu().numpy() for g in grads]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (y_card, r_card, g_card), (y_cpu, r_cpu, g_cpu) = runs
    assert len(r_card) == len(r_cpu) == 1
    np.testing.assert_array_equal(r_card[0], r_cpu[0])
    assert np.abs(y_card - y_cpu).max() <= 1e-5 * np.abs(y_cpu).max()
    for a, b in zip(g_card, g_cpu):
        assert cs.rel_l2(a, b) <= 1e-4


def test_mla_decode_card_matches_cpu(cuda):
    """deepseek-v2-lite FULL widths cut to 2 layers (one dense, one MoE),
    f32 with TF32 off, the same numpy weights on the card and on the CPU:
    the absorbed MLA prefill and 4 decode steps over the compressed cache
    within 1e-3 of the largest logit, the MoE layer routed alike."""
    from repro_torch.models import common as MC
    cs = _chip_smoke()
    m = cs.cut_model(cs.MOE_ARCH)
    np_params = cs.numpy_params(m.param_specs(), seed=1)
    prompt = np.random.default_rng(2).integers(0, m.cfg.vocab, 64)
    tf32, was = torch.backends.cuda.matmul.allow_tf32, MC.COMPUTE_DTYPE
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    try:
        got = []
        for d in (cuda, "cpu"):
            with cs.recorded_routes() as routed:
                got.append((cs.forced_logits(
                    m, MC.params_from_numpy(np_params, d), prompt,
                    [1, 2, 3, 4], 128, d), routed))
    finally:
        MC.set_compute_dtype(was)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (card, r_card), (cpu, r_cpu) = got
    for a, b in zip(card, cpu):
        assert np.abs(a - b).max() <= cs.CARD_CPU_REL * np.abs(b).max()
    assert len(r_card) == len(r_cpu) == 5
    assert all(np.array_equal(a, b) for a, b in zip(r_card, r_cpu))


def test_bf16_leaf_by_leaf_init_on_card(cuda):
    """deepseek-v2-lite FULL's bf16 weights drawn leaf by leaf on the
    card (``chip_smoke.bf16_params``): every leaf bf16, param_count + the
    final norm's gains of them, peak memory within the bf16 bytes plus
    one f32 leaf, and a ``ServeEngine`` holds those tensors, not a copy."""
    from repro_torch.configs import get_arch
    from repro_torch.models import common as MC
    from repro_torch.serving import ServeEngine
    cs = _chip_smoke()
    m = get_arch(cs.MOE_ARCH).model()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = cs.bf16_params(m, cuda)
    leaves = MC.tree_leaves(params)
    n = sum(a.numel() for a in leaves)
    assert all(a.dtype == torch.bfloat16 and a.is_cuda for a in leaves)
    assert n == m.cfg.param_count() + m.cfg.d_model
    biggest = max(math.prod(s.shape) for s in MC.tree_leaves(m.param_specs()))
    assert torch.cuda.max_memory_allocated() - base <= \
        2 * n + 4 * biggest + 2 ** 26
    eng = ServeEngine(m, params, max_len=8, device=cuda)
    assert all(a is b for a, b in zip(leaves,
                                      MC.tree_leaves(eng.compute_params)))
    del eng, params, leaves
    torch.cuda.empty_cache()


@pytest.mark.parametrize("arch_id", ["zamba2-2.7b", "rwkv6-7b",
                                     "whisper-tiny"])
def test_ssm_rwkv_encdec_smoke_card_matches_cpu(cuda, arch_id):
    """The smoke Zamba2, RWKV6 and whisper models at f32 with TF32 off,
    the same numpy weights (and whisper's frames) on the card and on the
    CPU: a 16-token prefill (one smoke chunk) and 4 decode steps within
    ``CARD_CPU_REL`` of the largest logit; the loss within 1e-5 and each
    gradient leaf within 1e-4 relative L2 at seq 16."""
    from repro_torch.configs import get_arch
    from repro_torch.models import common as MC
    cs = _chip_smoke()
    m = get_arch(arch_id).model(smoke=True)
    np_params = cs.numpy_params(m.param_specs(), seed=1)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, m.cfg.vocab, 16)
    toks = rng.integers(0, m.cfg.vocab, (1, 17))
    frames = {}
    if arch_id == "whisper-tiny":
        frames = {"frames": torch.from_numpy(rng.normal(
            size=(1, m.cfg.n_frames, m.cfg.d_model)).astype(np.float32))}
    tf32, was = torch.backends.cuda.matmul.allow_tf32, MC.COMPUTE_DTYPE
    torch.backends.cuda.matmul.allow_tf32 = False
    MC.set_compute_dtype(torch.float32)
    try:
        got = []
        for d in (cuda, "cpu"):
            extra = {k: v.to(d) for k, v in frames.items()}
            got.append((cs.forced_logits(m, MC.params_from_numpy(np_params, d),
                                         prompt, [1, 2, 3, 4], 32, d, extra),
                        cs.loss_grad_parts(m, np_params, toks, d, frames)))
    finally:
        MC.set_compute_dtype(was)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (card, (loss_card, g_card)), (cpu, (loss_cpu, g_cpu)) = got
    for a, b in zip(card, cpu):
        assert np.abs(a - b).max() <= cs.CARD_CPU_REL * np.abs(b).max()
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert max(cs.rel_l2(a, b) for a, b in zip(g_card, g_cpu)) <= 1e-4


def test_mesh_filter_service_on_card_matches_one_device(cuda, tmp_path):
    """A 1-rank NCCL group: ``FilterService(mesh=)`` over the mesh
    service bank of ``tests/_torch_ranks.py`` returns the one-device
    service's rows and stats, launching each bank kernel once a probe."""
    import torch.distributed as dist
    from _torch_ranks import N_QUERIES, bank_case
    from repro_torch.launch.mesh import make_mesh, start_group
    filters, q = bank_case()
    one = FilterService(filters, device=cuda)
    start_group(str(tmp_path), 0, 1, device="cuda", timeout_s=60.0)
    try:
        svc = FilterService(filters, device=cuda,
                            mesh=make_mesh((1,), ("data",)))
        before = {k: f.launches for k, f in KERNELS.items()}
        for n in (N_QUERIES, 0):
            for g, w in zip(svc.probe(q[:n]), one.probe(q[:n])):
                np.testing.assert_array_equal(g, w)
        assert {k: f.launches - before[k] for k, f in KERNELS.items()} == {
            **{k: 0 for k in KERNELS}, **{k: 2 for k in (
                "bloom_probe", "xor_probe", "exact_probe", "chained_probe",
                "cascade_probe")}}
        for i in range(len(filters)):
            np.testing.assert_array_equal(svc.probe_filter(i, q),
                                          one.probe_filter(i, q))
        assert svc.stats.as_dict() == one.stats.as_dict()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id", ["llama3.2-1b", "deepseek-v2-lite-16b",
                                     "zamba2-2.7b", "rwkv6-7b",
                                     "whisper-tiny"])
def test_sharded_steps_on_card_match_one_device(cuda, tmp_path, arch_id):
    """A 1-rank NCCL group, the card's (1, 1) mesh: each family's smoke
    train step at bf16 compute (f32 master weights, deterministic
    algorithms), a 12-token prefill and 2 decode steps over the mesh,
    whose products run ``_MatmulF32`` under ``local_map``, equal the
    one-device steps bit for bit; the sharded state and caches are
    DTensors, the loss and logits plain tensors."""
    import warnings
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from _torch_ranks import serve_batch, step_inputs
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh, start_group
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import common as MC
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    m = get_arch(arch_id).model(smoke=True)
    p = MC.init_from_specs(m.param_specs(),
                           torch.Generator(cuda).manual_seed(0), cuda)
    opt = adamw_init(p)
    inp = step_inputs(m, arch_id)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in inp["batch"].items()}
    was = MC.COMPUTE_DTYPE
    MC.set_compute_dtype(torch.bfloat16)
    start_group(str(tmp_path), 0, 1, device="cuda", timeout_s=60.0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_host_mesh("cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            one = make_train_step(m, AdamWConfig())(p, opt, batch)
            sh = make_train_step(m, AdamWConfig(), mesh=mesh)(p, opt, batch)
        assert all(isinstance(t, DTensor) for t in MC.tree_leaves(sh[:2]))
        assert torch.equal(one[2]["loss"], sh[2]["loss"])
        for a, b in zip(MC.tree_leaves(one[:2]), MC.tree_leaves(sh[:2])):
            assert torch.equal(a, b.full_tensor())
        bp = MC.tree_map(lambda t: t.to(torch.bfloat16), p)
        prompt = serve_batch(inp, 12, lambda a: torch.from_numpy(a).to(cuda))
        lg1, c1 = make_prefill_step(m, 16)(bp, prompt)
        lg2, c2 = make_prefill_step(m, 16, mesh=mesh)(bp, prompt)
        assert torch.equal(lg1, lg2) and not isinstance(lg2, DTensor)
        for i in range(2):
            step = torch.from_numpy(inp["decode"][i]).to(cuda)
            lg1, c1 = make_serve_step(m)(bp, c1, step)
            lg2, c2 = make_serve_step(m, mesh=mesh)(bp, c2, step)
            assert torch.equal(lg1, lg2)
        assert c1["len"] == c2["len"]
        for a, b in zip(MC.tree_leaves(c1), MC.tree_leaves(c2)):
            assert (a == b if isinstance(a, int)
                    else torch.equal(a, b.full_tensor()))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        MC.set_compute_dtype(was)
        dist.destroy_process_group()


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_step_trace_of_llama_at_16x16_beside_the_card(cuda, shape_name):
    """Phase 16's two 16x16 cells on the card's host: llama3.2-1b FULL
    traced over a fake group of 256 ranks (``dryrun.traced_cell``,
    ``meta`` tensors: no device memory), its grouped-query attention on
    q heads split over 'model' and 8 kv heads that 16 does not divide;
    the traced argument bytes equal the census's, and the step moves
    collectives and has a liveness peak."""
    from repro_torch.launch import dryrun, hbm_model, op_trace
    from repro_torch.launch.mesh import make_production_mesh
    before = torch.cuda.memory_allocated()
    mesh = make_production_mesh()
    cell, trace = dryrun.traced_cell("llama3.2-1b", shape_name, mesh)
    census = dryrun.run_cell("llama3.2-1b", shape_name, mesh, "16x16",
                             verbose=False)
    assert trace.arg_bytes == census["memory_model"]["args"]
    assert op_trace.collective_summary(trace)["count"] > 0
    assert hbm_model.peak_hbm_bytes(trace) > 0 and trace.flops > 0
    assert torch.cuda.memory_allocated() == before
