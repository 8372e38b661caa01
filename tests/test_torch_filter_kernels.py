"""Port parity, slice 2 device side: the plain versions of xor_probe,
exact_probe, chained_probe and cascade_probe (what the CUDA kernels are
held against on the card) against the JAX package's Pallas kernels in
interpret mode on ``selfcheck.filter_case`` banks; ``kernels.ops`` against
``repro.kernels.ops``; and a 5-filter ``FilterService(device="cpu")``
against the JAX ``FilterService``. Tolerance: exact equality (integer and
boolean outputs, integer-derived stats)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.core.bloom import BloomFilter as JBloom  # noqa: E402
from repro.core.bloomier import ExactBloomier as JExact  # noqa: E402
from repro.core.bloomier import XorFilter as JXor  # noqa: E402
from repro.core.chained import ChainedFilterAnd as JAnd  # noqa: E402
from repro.core.chained import ChainedFilterCascade as JCascade  # noqa: E402
from repro.kernels import common as JC  # noqa: E402
from repro.kernels import ops as JOps  # noqa: E402
from repro.kernels.cascade_probe import cascade_probe as j_cascade  # noqa: E402
from repro.kernels.chained_probe import chained_probe as j_chained  # noqa: E402
from repro.kernels.xor_probe import exact_probe as j_exact  # noqa: E402
from repro.kernels.xor_probe import xor_probe as j_xor  # noqa: E402
from repro.serving.filter_service import FilterService as JService  # noqa: E402
from repro_torch.core.bloom import BloomFilter  # noqa: E402
from repro_torch.core.bloomier import ExactBloomier, XorFilter  # noqa: E402
from repro_torch.core.chained import (ChainedFilterAnd,  # noqa: E402
                                      ChainedFilterCascade)
from repro_torch.core.tables import layout_from_dict  # noqa: E402
from repro_torch.kernels import ops, ref, selfcheck  # noqa: E402
from repro_torch.kernels.bloom_probe import (bloom_probe,  # noqa: E402
                                             bloom_probe_gather,
                                             bloom_probe_onchip)
from repro_torch.kernels.cascade_probe import (cascade_descriptors,  # noqa: E402
                                               cascade_probe)
from repro_torch.kernels.chained_probe import chained_probe  # noqa: E402
from repro_torch.kernels.xor_probe import exact_probe, xor_probe  # noqa: E402
from repro_torch.serving.filter_service import (FilterBank,  # noqa: E402
                                                FilterService)

PER = 240
CASES = selfcheck.filter_edge_cases()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _jax_outputs(kernel, tables, lay, hi2d, lo2d):
    """The JAX Pallas kernel (interpret mode) on the same bank, as a tuple
    of int32 arrays."""
    if kernel == "xor_probe":
        out = j_xor(tables, hi2d, lo2d, mode=lay.mode, seed=lay.seed,
                    seg_len=lay.seg_len, n_seg=lay.n_seg, alpha=lay.alpha,
                    fp_seed=lay.fp_seed, offset=lay.offset, interpret=True)
        return (np.asarray(out),)
    if kernel == "exact_probe":
        out = j_exact(tables, hi2d, lo2d, mode=lay.mode, seed=lay.seed,
                      seg_len=lay.seg_len, n_seg=lay.n_seg,
                      strategy=lay.strategy, bit_seed=lay.bit_seed,
                      offset=lay.offset, interpret=True)
        return (np.asarray(out),)
    if kernel == "chained_probe":
        outs = j_chained(tables, hi2d, lo2d, interpret=True,
                         **JOps.chained_and_params(lay))
    else:
        outs = j_cascade(tables, hi2d, lo2d, layers=lay.probe_params(),
                         interpret=True)
    return tuple(np.asarray(o) for o in outs)


def _port_outputs(kernel, tables, lay, hi, lo):
    """The port's wrapper on CPU tensors (it runs the plain version)."""
    kern, _ = selfcheck.filter_calls(kernel, lay, _t(tables))
    return tuple(g.numpy() for g in kern(hi, lo))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{k}:{n}" for k, n, _ in CASES])
def test_plain_version_matches_jax_interpret(case):
    kernel, _, arg = CASES[case]
    tables, lay, q, f = selfcheck.filter_case(kernel, arg, per=PER, seed=5)
    hi2d, lo2d, n = JC.blockify(*JH.np_split_u64(q))
    want = _jax_outputs(kernel, tables, lay, hi2d, lo2d)
    # the [R, 128] blocks the JAX kernel takes, and flat lanes
    got = _port_outputs(kernel, tables, lay, _t(hi2d), _t(lo2d))
    flat = _port_outputs(kernel, tables, lay, _t(hi2d.ravel()),
                         _t(lo2d.ravel()))
    for g, fl, w in zip(got, flat, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(fl, w.ravel())
    member = got[0].ravel()[:n].astype(bool)
    np.testing.assert_array_equal(member, f.query(q))   # the host filter
    assert member.any() and not member.all()
    if kernel == "chained_probe" and arg != "no stage 1":
        probes = got[1].ravel()[:n]
        assert ((probes == 2) & ~member).any()  # stage 1 passed, stage 2 not
    if kernel == "cascade_probe":
        np.testing.assert_array_equal(got[1].ravel()[:n],
                                      f.probes_until_decided(q))


def test_ref_oracles_keep_the_reference_signatures():
    """kernels/ref.py on separate (unpacked) tables, as the JAX oracles
    take them, against the host filters."""
    keys = JH.random_keys(6000, seed=8)
    pos, neg, q = keys[:500], keys[500:4500], keys[::3]
    hi, lo = (_t(a) for a in JH.np_split_u64(q))
    b = BloomFilter.build(pos, 0.05, seed=2**31 + 1)
    assert torch.equal(ref.bloom_probe_ref(_t(b.words), hi, lo, m_bits=b.m_bits,
                                           k=b.k, seed=b.seed),
                       torch.from_numpy(b.query(q)))
    x = XorFilter.build(pos, 5, mode="uniform", seed=9)
    xl = dict(mode="uniform", seed=x.tbl.layout.seed,
              seg_len=x.tbl.layout.seg_len, n_seg=x.tbl.layout.n_seg)
    assert torch.equal(ref.xor_probe_ref(_t(x.tbl.table), hi, lo, alpha=5,
                                         fp_seed=x.fp_seed, **xl),
                       torch.from_numpy(x.query(q)))
    c = ChainedFilterAnd.build(pos, neg, seed=2**31 + 3)
    l1, l2 = (dict(mode=t.layout.mode, seed=t.layout.seed,
                   seg_len=t.layout.seg_len, n_seg=t.layout.n_seg)
              for t in (c.f1.tbl, c.f2.tbl))
    got = ref.chained_probe_ref(_t(c.f1.tbl.table), _t(c.f2.tbl.table), hi, lo,
                                l1=l1, l2=l2, alpha=c.f1.alpha,
                                fp_seed=c.f1.fp_seed, strategy=c.f2.strategy,
                                bit_seed=c.f2.bit_seed)
    assert torch.equal(got, torch.from_numpy(c.query(q)))
    s = ChainedFilterCascade.build(pos, neg, seed=2**31 + 4)
    got = ref.cascade_probe_ref(
        [_t(f.words) for f in s.layers],
        [dict(m_bits=f.m_bits, k=f.k, seed=f.seed) for f in s.layers], hi, lo)
    assert torch.equal(got, torch.from_numpy(s.query(q)))


def _both(keys):
    """The five serving filter kinds built by both packages (JAX, port)
    from the same keys and seeds: benchmarks/filter_service.py's bank at
    λ = 8."""
    n = len(keys) // 10
    pos, neg = keys[:n], keys[n:9 * n]
    out = []
    for mod in ((JBloom, JXor, JExact, JAnd, JCascade),
                (BloomFilter, XorFilter, ExactBloomier, ChainedFilterAnd,
                 ChainedFilterCascade)):
        bloom, xor, exact, chained, cascade = mod
        out.append([bloom.build(pos, 0.01, seed=11), xor.build(pos, 8, seed=12),
                    exact.build(pos[:n // 2], neg[:n], seed=13),
                    chained.build(pos, neg, seed=14),
                    cascade.build(pos, neg, seed=3)])
    return out


KEYS = JH.random_keys(4000, seed=31)
QUERIES = np.random.default_rng(7).choice(KEYS, 2048, replace=True)


def test_ops_queries_match_the_jax_ops():
    jf, pf = _both(KEYS)
    q = QUERIES[:1000]
    fns = [(JOps.bloom_query, ops.bloom_query), (JOps.xor_query, ops.xor_query),
           (JOps.exact_query, ops.exact_query),
           (JOps.chained_query, ops.chained_query),
           (JOps.cascade_query, ops.cascade_query)]
    for (jfn, pfn), j, p in zip(fns, jf, pf):
        want = jfn(j, q)
        np.testing.assert_array_equal(pfn(p, q, device="cpu"), want)
        np.testing.assert_array_equal(want, p.query(q))
    jm, jp = JOps.cascade_query(jf[4], q, with_probes=True)
    pm, pp = ops.cascade_query(pf[4], q, device="cpu", with_probes=True)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pp, jp)
    empty = np.zeros(0, np.uint64)
    assert ops.xor_query(pf[1], empty, device="cpu").shape == (0,)


def test_filter_service_matches_the_jax_service():
    jf, pf = _both(KEYS)
    jsvc, psvc = JService(jf), FilterService(pf, device="cpu")
    assert psvc.bank.tables.tobytes() == jsvc.bank.tables.tobytes()
    for _ in range(2):                        # stats accumulate over probes
        jm, jp = jsvc.probe(QUERIES)
        pm, pp = psvc.probe(QUERIES)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pp, jp)
    assert psvc.stats.as_dict() == jsvc.stats.as_dict()
    # the exact filters are exact over their universes; chained probes are
    # 1 + stage-1 pass, the cascade's the host's sequential count
    n = len(KEYS) // 10
    for i, f in enumerate(pf):
        np.testing.assert_array_equal(pm[i], f.query(QUERIES))
    np.testing.assert_array_equal(pp[3], 1 + pf[3].stage_queries(QUERIES)[0])
    np.testing.assert_array_equal(pp[4], pf[4].probes_until_decided(QUERIES))
    assert pm[3][np.isin(QUERIES, KEYS[:n])].all()
    assert not pm[3][np.isin(QUERIES, KEYS[n:9 * n])].any()
    for i in range(5):
        np.testing.assert_array_equal(psvc.probe_filter(i, QUERIES), pm[i])
    # a JAX-packed bank serves through the port unchanged
    layouts = tuple(layout_from_dict(type(lay).__name__, dataclasses.asdict(lay))
                    for lay in jsvc.bank.layouts)
    unpacked = FilterBank(jsvc.bank.tables, layouts).unpack()
    assert [type(f) for f in unpacked] == [type(f) for f in pf]
    m2, p2 = FilterService(unpacked, device="cpu").probe(QUERIES)
    np.testing.assert_array_equal(m2, jm)
    np.testing.assert_array_equal(p2, jp)
    # online training that keeps the cascade's layout: refresh_tables
    stream = KEYS[-200:]
    labels = np.arange(len(stream)) % 3 == 0
    for svc, filters in ((jsvc, jf), (psvc, pf)):
        filters[4].train(stream, labels)
        svc.refresh_tables(filters)
    assert pf[4].n_layers == jf[4].n_layers
    jm, jp = jsvc.probe(QUERIES)
    pm, pp = psvc.probe(QUERIES)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(psvc.probe_filter(4, stream), labels)
    # a layer appended by training changes the layout: refresh refuses it,
    # rebuild serves it
    pf[4].layers.append(BloomFilter.build(stream[:64], 0.25, seed=977 * 99))
    with pytest.raises(ValueError):
        psvc.refresh_tables(pf)
    psvc.rebuild(pf)
    pm, _ = psvc.probe(QUERIES)
    np.testing.assert_array_equal(pm[4], pf[4].query(QUERIES))


def test_wrappers_validate_their_arguments():
    tables, lay, _, _ = selfcheck.filter_case("chained_probe", "stage 1",
                                              per=PER)
    words = _t(tables)
    z = torch.zeros(8, dtype=torch.int32)
    x = dict(mode=lay.xor.mode, seed=lay.xor.seed, seg_len=lay.xor.seg_len,
             n_seg=lay.xor.n_seg, offset=lay.xor.offset)
    with pytest.raises(ValueError):
        xor_probe(words, z, z, alpha=33, fp_seed=0, **x)
    with pytest.raises(ValueError):
        xor_probe(words, z, z, alpha=0, fp_seed=0, **x)
    with pytest.raises(ValueError):                 # outside the bank
        xor_probe(words[:256], z, z, alpha=3, fp_seed=0, **x)
    with pytest.raises(ValueError):
        xor_probe(words, z, z, alpha=3, fp_seed=0, **dict(x, seg_len=2**31))
    with pytest.raises(ValueError):
        exact_probe(words, z, z, strategy="c", bit_seed=0, **x)
    with pytest.raises(TypeError):
        exact_probe(words.to(torch.int64), z, z, strategy="a", bit_seed=0, **x)
    with pytest.raises(ValueError):
        chained_probe(words, z, z[:4], **ops.chained_and_params(lay))
    layers = ((64, 3, 1, 0), (2**31, 3, 1, 0))
    desc = torch.from_numpy(cascade_descriptors(layers))
    with pytest.raises(ValueError):
        cascade_probe(words, z, z, desc, layers=layers)
    with pytest.raises(ValueError):                 # no layers
        cascade_probe(words, z, z, desc[:0], layers=())
    with pytest.raises(ValueError):                 # desc of other layers
        cascade_probe(words, z, z, desc, layers=((64, 3, 1, 0), (64, 2, 1, 0)))
    # bloom_probe: the cascade's layer check (k >= 0, inside the bank)
    for probe in (bloom_probe, bloom_probe_gather, bloom_probe_onchip):
        with pytest.raises(ValueError):             # k < 0
            probe(words, z, z, m_bits=64, k=-1, seed=1, offset=0)
        with pytest.raises(ValueError):             # past the bank
            probe(words, z, z, m_bits=64, k=3, seed=1,
                  offset=words.numel() - 1)
        with pytest.raises(ValueError):
            probe(words, z, z, m_bits=0, k=3, seed=1, offset=0)
    assert bloom_probe(words, z, z, m_bits=64, k=0, seed=1).all()
