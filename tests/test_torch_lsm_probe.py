"""Port parity, layer 2: the probe kernels' plain versions (what the CUDA
kernels are held against on the card) against the JAX package's Pallas
kernels in interpret mode, on the edge banks the card's checks use
(``repro_torch.kernels.selfcheck.edge_bank``).
Tolerance: exact equality (integer outputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.core.bloom import BloomFilter as JBloom  # noqa: E402
from repro.core.lsm import ChainedTableFilter as JChained  # noqa: E402
from repro.core.othello import DynamicExactFilter as JDyn  # noqa: E402
from repro.kernels import common as JC  # noqa: E402
from repro.kernels.bloom_probe import bloom_probe as j_bloom_probe  # noqa: E402
from repro.kernels.lsm_probe import (lsm_probe as j_lsm_probe,  # noqa: E402
                                     lsm_chain_probe as j_lsm_chain_probe,
                                     othello_hit as j_othello_hit)
from repro_torch.kernels import common as C  # noqa: E402
from repro_torch.kernels import lsm_probe as L  # noqa: E402
from repro_torch.kernels import selfcheck  # noqa: E402
from repro_torch.kernels.bloom_probe import bloom_probe, bloom_probe_ref  # noqa: E402

PER = 240
SEED = 21
# the JAX package's host filter class of each packed layout
JAX_FILTER = {"LsmChainLayout": JChained, "OthelloTable": JDyn,
              "BloomTable": JBloom}


def _bank(kinds):
    """(packed uint32 bank, chains, query keys, layouts) for tables of
    ``kinds``, newest first: stage-1 seeds wrap mod 2**32 (x7919), Othello
    and Bloom seeds >= 2**31, keys include the lane extremes."""
    return selfcheck.edge_bank(kinds, per=PER, seed=SEED)


def _blocks(q):
    """Query keys blocked as the JAX kernels take them."""
    return JC.blockify(*JH.np_split_u64(q))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


CASES = {
    "fuse": ("fuse",),
    "uniform": ("uniform",),
    "no_stage1": ("nos1",),
    "bloom": ("bloom",),
    "mixed8": ("fuse", "uniform", "nos1", "bloom", "always", "fuse",
               "uniform", "fuse"),
}


def _desc(chains):
    return torch.from_numpy(L.chain_descriptors(chains))


@pytest.mark.parametrize("case", list(CASES))
def test_lsm_probe_matches_jax_interpret(case):
    tables, chains, q, _ = _bank(CASES[case])
    hi2d, lo2d, n = _blocks(q)
    want_f, want_m = j_lsm_probe(tables, hi2d, lo2d, chains=chains,
                                 interpret=True)
    want_f, want_m = np.asarray(want_f), np.asarray(want_m)
    words, desc = _t(tables), _desc(chains)
    # the [R, 128] blocks the JAX kernel takes, and flat lanes
    got_f, got_m = L.lsm_probe(words, _t(hi2d), _t(lo2d), desc,
                               chains=chains)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    flat_f, flat_m = L.lsm_probe(words, _t(hi2d.ravel()), _t(lo2d.ravel()),
                                 desc, chains=chains)
    np.testing.assert_array_equal(flat_f.numpy(), want_f.ravel())
    np.testing.assert_array_equal(flat_m.numpy(), want_m.ravel())
    assert (want_f.ravel()[:n] < len(chains)).any()    # something fired


def test_lsm_probe_32_tables_matches_host_filters():
    kinds = ("fuse", "uniform", "nos1", "bloom") * 8
    tables, chains, q, lays = _bank(kinds)
    hi2d, lo2d, n = _blocks(q)
    # the JAX package's host filters, read back from the same bank
    filters = [JAX_FILTER[type(lay).__name__].from_tables(tables, lay)
               for lay in lays]
    hits = np.stack([f.query(q) for f in filters], axis=1)
    want_m = (hits.astype(np.int64) << np.arange(32)).sum(axis=1)
    want_m = want_m.astype(np.uint32).view(np.int32)   # bit 31 wraps
    want_f = np.where(hits.any(1), hits.argmax(1), 32)
    got_f, got_m = L.lsm_probe(_t(tables), _t(hi2d), _t(lo2d), _desc(chains),
                               chains=chains)
    np.testing.assert_array_equal(C.unblockify(got_m, n).numpy(), want_m)
    np.testing.assert_array_equal(C.unblockify(got_f, n).numpy(), want_f)
    assert (want_m < 0).any()                          # table 31 fired


@pytest.mark.parametrize("kind", ["fuse", "uniform", "nos1"])
def test_lsm_chain_probe_matches_jax_interpret(kind):
    tables, chains, q, _ = _bank(("bloom", kind))
    chain = chains[1]
    hi2d, lo2d, _ = _blocks(q)
    want = j_lsm_chain_probe(tables, hi2d, lo2d, chain=chain, interpret=True)
    got = L.lsm_chain_probe(_t(tables), _t(hi2d), _t(lo2d), chain=chain)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert set(np.unique(got[1].numpy())) <= ({1} if kind == "nos1"
                                              else {1, 2})
    if kind == "nos1":          # the Othello classifier alone (FilterService)
        ma, mb, seed, off_a, off_b = chain[2]
        want_o = j_othello_hit(tables, hi2d, lo2d, ma=ma, mb=mb, seed=seed,
                               offset_a=off_a, offset_b=off_b)
        got_o = L.othello_hit(_t(tables), _t(hi2d), _t(lo2d), ma=ma, mb=mb,
                              seed=seed, offset_a=off_a, offset_b=off_b)
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))


def test_bloom_probe_matches_jax_interpret():
    tables, chains, q, _ = _bank(("fuse", "bloom"))
    m_bits, k, seed, offset = chains[1][1]
    assert seed >= 2**31 and offset > 0
    hi2d, lo2d, _ = _blocks(q)
    want = np.asarray(j_bloom_probe(tables, hi2d, lo2d, m_bits=m_bits, k=k,
                                    seed=seed, offset=offset, interpret=True))
    got = bloom_probe(_t(tables), _t(hi2d), _t(lo2d), m_bits=m_bits, k=k,
                      seed=seed, offset=offset)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bloom_probe_ref(_t(tables), _t(hi2d), _t(lo2d), m_bits=m_bits, k=k,
                        seed=seed, offset=offset).numpy(), want)
    assert want.any() and not want.all()


def test_wrappers_validate_their_arguments():
    tables, chains, _, _ = _bank(("fuse", "bloom"))
    words, desc = _t(tables), _desc(chains)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        L.lsm_probe(words, z, z, desc[:0], chains=())
    with pytest.raises(ValueError):
        L.lsm_probe(words, z, z, _desc(chains * 17), chains=chains * 17)
    with pytest.raises(ValueError):                  # desc of other chains
        L.lsm_probe(words, z, z, desc.flip(0), chains=chains)
    with pytest.raises(ValueError):                  # desc of another shape
        L.lsm_probe(words, z, z, desc[:, :8], chains=chains)
    with pytest.raises(TypeError):
        L.lsm_probe(words.to(torch.int64), z, z, desc, chains=chains)
    with pytest.raises(ValueError):
        L.lsm_probe(words, z, z[:4], desc, chains=chains)
    with pytest.raises(ValueError):
        L.lsm_chain_probe(words, z, z, chain=chains[1])
    with pytest.raises(ValueError):
        bloom_probe(words, z, z, m_bits=2**31, k=3, seed=0)
    if not torch.cuda.is_available():     # no silent fall back to the CPU
        with pytest.raises(RuntimeError):
            C.as_device("cuda")
