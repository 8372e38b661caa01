"""Port parity, the rest of slice 6: the tiered prefix cache
(``repro_torch.serving.prefix_cache``, its tier bank probed through the
port's ``FilterService`` on the CPU) and the numpy §5.2–§5.3 modules
(``core/{cuckoo, othello_ref, adaptive, huffman}``) against the JAX
package on the same inputs, and ``FilterService.prepare(warm=True)`` on
the CPU. Tolerance: exact equality everywhere."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import adaptive as JA  # noqa: E402
from repro.core import cuckoo as JC  # noqa: E402
from repro.core import hashing as JH  # noqa: E402
from repro.core import huffman as JHF  # noqa: E402
from repro.core import othello_ref as JO  # noqa: E402
from repro.serving import prefix_cache as JP  # noqa: E402
from repro_torch.core import adaptive, cuckoo, huffman, othello_ref  # noqa: E402
from repro_torch.core.bloom import BloomFilter  # noqa: E402
from repro_torch.core.bloomier import XorFilter  # noqa: E402
from repro_torch.core.chained import ChainedFilterCascade  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serving import FilterService, prefix_cache  # noqa: E402
from repro_torch.serving.filter_service import layout_sources  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = JH.random_keys(20_000, seed=61)


def _tiers(mod):
    return [mod.TierSpec("hbm", 4, 1.0), mod.TierSpec("dram", 8, 10.0),
            mod.TierSpec("ssd", 64, 150.0)]


# ------------------------------------------------------------ prefix cache

def test_prefix_cache_matches_jax():
    """One insert / batched-lookup / insert / lookup stream through the
    JAX cache and the port's: the same results, stats and tier stores,
    and the port's ``lookup_batch`` equal to its key-by-key ``lookup``."""
    jax_pc = JP.TieredPrefixCache(_tiers(JP), seed=4)
    port_pc = prefix_cache.TieredPrefixCache(_tiers(prefix_cache), seed=4,
                                             device="cpu")
    twin = prefix_cache.TieredPrefixCache(_tiers(prefix_cache), seed=4,
                                          device="cpu")
    rng = np.random.default_rng(1)
    keys = rng.integers(1, 2 ** 62, 120).tolist()
    probe = keys + rng.integers(2 ** 62, 2 ** 63, 120).tolist()
    rng.shuffle(probe)
    for part in range(2):
        for i in range(part * 60, (part + 1) * 60):
            for pc in (jax_pc, port_pc, twin):
                pc.insert(keys[i], payload=i)
        q = probe[part * 120:(part + 1) * 120]
        got = port_pc.lookup_batch(q)
        assert got == jax_pc.lookup_batch(q)
        assert got == [twin.lookup(k) for k in q]
    assert port_pc.stats() == jax_pc.stats()
    assert port_pc.store == jax_pc.store and port_pc.lru == jax_pc.lru
    assert port_pc.probes == twin.probes
    assert port_pc.wasted_probes == twin.wasted_probes <= twin.lookups
    # the second batch re-packed the bank by refresh_tables; a Bloom-only
    # bank has no Bloomier planes to pack
    assert port_pc._service.version == 1
    assert port_pc._service.state.planes == (None, None, None)
    for fp, fj in zip(port_pc.filters, jax_pc.filters):
        assert fp.bloom.to_tables()[0].tobytes() == \
            fj.bloom.to_tables()[0].tobytes()
        assert fp.exact.to_tables()[0].tobytes() == \
            fj.exact.to_tables()[0].tobytes()


def test_chip_smoke_prefix_cache_cell_on_the_cpu():
    """``chip_smoke.prefix_cache_cell`` at a reduced stream: batched equal
    to key by key, every tier full, the refresh taken, no planes."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.prefix_cache_cell("cpu", n_inserts=240, n_lookups=512)
    assert out["equal"] and out["stats_equal"] and out["overflowed"]
    assert out["versions"] == [0, 1]
    assert out["service"].state.planes == (None, None, None)
    assert out["stats"]["wasted_probes"] <= out["stats"]["lookups"] == 512
    assert 0 < out["hits"] < 512


# --------------------------------------------- FilterService.prepare(warm)

def test_prepare_warm_is_a_no_op_on_the_cpu(monkeypatch):
    """On the CPU ``warm=True`` builds nothing and probes nothing; the
    state it stages equals the unwarmed one."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel library was built on the CPU")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "lib", refuse)
    filters = [BloomFilter.build(KEYS[:2000], 0.01, seed=3),
               XorFilter.build(KEYS[:2000], 8, seed=4)]
    svc = FilterService(filters, device="cpu")
    warm = svc.prepare(filters, warm=True)
    cold = svc.prepare(filters)
    assert warm.bank.tables.tobytes() == cold.bank.tables.tobytes()
    svc.publish(warm)
    assert svc.stats.lookups == 0
    member, _ = svc.probe(KEYS[:4000])
    np.testing.assert_array_equal(member[0], filters[0].query(KEYS[:4000]))


def test_layout_sources_name_every_path():
    cascade = ChainedFilterCascade.build(KEYS[:500], KEYS[500:2500], seed=3)
    svc = FilterService([BloomFilter.build(KEYS[:500], 0.01, seed=1),
                         XorFilter.build(KEYS[:500], 8, seed=2), cascade],
                        device="cpu")
    want = {"bloom_probe", "bloom_onchip", "xor_probe", "bloomier_onchip",
            "cascade_probe"}
    assert layout_sources(svc.state.bank.layouts) == want
    assert want <= set(_build.stems())


# -------------------------------------------------- §5.2–§5.3 host modules

def test_cuckoo_matches_jax():
    ks = KEYS[:3000]
    tp, tj = cuckoo.CuckooHashTable(M=4096, seed=5), JC.CuckooHashTable(
        M=4096, seed=5)
    tp.insert_many(ks)
    tj.insert_many(ks)
    np.testing.assert_array_equal(tp.t1, tj.t1)
    np.testing.assert_array_equal(tp.t2, tj.t2)
    q = KEYS[:6000]
    np.testing.assert_array_equal(tp.which_table(q), tj.which_table(q))
    pred = np.arange(len(q)) % 2
    np.testing.assert_array_equal(tp.lookup_accesses(q, pred),
                                  tj.lookup_accesses(q, pred))
    assert tp.load_factor == tj.load_factor
    # the filter's kicks draw from numpy's global generator: same seed
    np.random.seed(11)
    fp = cuckoo.CuckooFilter.build(ks, 0.01, seed=7)
    np.random.seed(11)
    fj = JC.CuckooFilter.build(ks, 0.01, seed=7)
    np.testing.assert_array_equal(fp.slots, fj.slots)
    np.testing.assert_array_equal(fp.query(q), fj.query(q))
    assert fp.bits == fj.bits
    full = cuckoo.CuckooHashTable(M=4, seed=1, max_kicks=8)
    with pytest.raises(cuckoo.CuckooFull):
        full.insert_many(KEYS[:32])


def test_sequential_othello_matches_jax():
    ks = KEYS[:1500]
    vals = (ks & np.uint64(1)).astype(np.uint8)
    op = othello_ref.SequentialOthello.build(ks, vals, seed=3)
    oj = JO.SequentialOthello.build(ks, vals, seed=3)
    for o in (op, oj):                   # value flips and new keys
        o.insert_batch(ks[:40], 1 - vals[:40])
        o.insert_batch(KEYS[1500:1600], np.ones(100, np.uint8))
    assert (op.ma, op.mb, op.seed, op.n_keys) == (oj.ma, oj.mb, oj.seed,
                                                  oj.n_keys)
    np.testing.assert_array_equal(op.bits_a, oj.bits_a)
    np.testing.assert_array_equal(op.bits_b, oj.bits_b)
    np.testing.assert_array_equal(op.lookup(KEYS[:3000]),
                                  oj.lookup(KEYS[:3000]))
    (tp, lp), (tj, lj) = op.to_tables(), oj.to_tables()
    assert tp.tobytes() == tj.tobytes()
    assert (lp.offset, lp.width, lp.ma, lp.mb, lp.seed) == (
        lj.offset, lj.width, lj.ma, lj.mb, lj.seed)


def test_adaptive_cuckoo_matches_jax():
    ks = KEYS[:4000]
    ap = adaptive.AdaptiveCuckoo.build(ks, M=4096, seed=4)
    aj = JA.AdaptiveCuckoo.build(ks, M=4096, seed=4)
    assert ap.train_rounds(ks) == aj.train_rounds(ks)
    assert ap.predictor.to_tables()[0].tobytes() == \
        aj.predictor.to_tables()[0].tobytes()
    np.testing.assert_array_equal(ap.external_accesses(ks),
                                  aj.external_accesses(ks))
    assert ap.filter_bits == aj.filter_bits
    for r in (0.2, 0.4, 0.45):
        assert adaptive.expected_access_reduction(r) == \
            JA.expected_access_reduction(r)
    assert adaptive.emoma_bits(4096) == JA.emoma_bits(4096)


@pytest.mark.parametrize("omega", [2, 8])
def test_random_access_huffman_matches_jax(omega):
    text = huffman.exponential_text(omega, 3000, seed=omega)
    assert text == JHF.exponential_text(omega, 3000, seed=omega)
    hp = huffman.RandomAccessHuffman.build(text, seed=1)
    hj = JHF.RandomAccessHuffman.build(text, seed=1)
    assert hp.code == hj.code and hp.bits == hj.bits
    assert hp.cf.to_tables()[0].tobytes() == hj.cf.to_tables()[0].tobytes()
    assert hp.decode_range(0, 400) == hj.decode_range(0, 400) == text[:400]
    assert hp.probes_per_char_avg() == hj.probes_per_char_avg()
    assert huffman.entropy_bits_per_char(text) == \
        JHF.entropy_bits_per_char(text)
    assert huffman.huffman_bits_per_char(text) == \
        JHF.huffman_bits_per_char(text)
    single = huffman.RandomAccessHuffman.build("aaaa")
    assert single.cf is None and single.decode_at(2) == "a"
