"""Port parity, layer 1: hashing, packed-table layouts and the lsm_probe
params/descriptor packing — the PyTorch port against the JAX package.
Tolerance: exact equality (all outputs are integers)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as JH  # noqa: E402
from repro.core import tables as JT  # noqa: E402
from repro.core.bloom import BloomFilter as JBloom  # noqa: E402
from repro.core.bloomier import XorFilter as JXor  # noqa: E402
from repro.core.lsm import ChainedTableFilter as JChained  # noqa: E402
from repro.core.othello import DynamicExactFilter as JDyn  # noqa: E402
from repro.kernels import lsm_probe as JL  # noqa: E402
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import tables as T  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import lsm_probe as L  # noqa: E402

SEEDS = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
RANGES = [1, 7, 1000, 2**20 + 3, 2**31 - 1]


def _lanes(n, seed=0):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # the lanes' extremes, where 32-bit wrap and the mulhi carries bite
    hi[:4] = [0, 2**32 - 1, 2**31, 2**32 - 2]
    lo[:4] = [2**32 - 1, 0, 2**31 - 1, 2**32 - 3]
    return hi, lo


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def test_numpy_host_functions_are_the_reference_copies():
    hi, lo = _lanes(4096, seed=1)
    keys = JH.random_keys(777, seed=5)
    np.testing.assert_array_equal(H.random_keys(777, seed=5), keys)
    for a, b in zip(H.np_split_u64(keys), JH.np_split_u64(keys)):
        np.testing.assert_array_equal(a, b)
    for seed in SEEDS:
        np.testing.assert_array_equal(H.np_hash_u32(hi, lo, seed),
                                      JH.np_hash_u32(hi, lo, seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_hashes_match_numpy_and_jax(seed):
    hi, lo = _lanes(8192, seed=seed % 97)
    th, tl = _t(hi), _t(lo)
    want = JH.np_hash_u32(hi, lo, seed)
    got = H.t_hash_u32(th, tl, seed).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(JH.jx_hash_u32(jnp.asarray(hi), jnp.asarray(lo), seed)))
    # np_fmix32 xors a uint32 argument in place: hand it a copy
    np.testing.assert_array_equal(
        H.t_fmix32(th).numpy().astype(np.uint32), JH.np_fmix32(hi.copy()))
    # a seed carried as a lane tensor hashes like the scalar seed
    lane = torch.full((1,), seed, dtype=torch.int64)
    np.testing.assert_array_equal(
        H.t_hash_u32(th, tl, lane).numpy().astype(np.uint32), want)
    for n in RANGES:
        ref = JH.np_hash_to_range(hi, lo, seed, n)
        np.testing.assert_array_equal(
            H.t_hash_to_range(th, tl, seed, n).numpy(), ref)
        np.testing.assert_array_equal(
            np.asarray(JH.jx_hash_to_range(jnp.asarray(hi), jnp.asarray(lo),
                                           seed, n)), ref)


def test_mulhi_near_the_top_of_the_range():
    a = np.array([0, 1, 2**31, 2**32 - 2, 2**32 - 1, 0xDEADBEEF], np.uint32)
    for b in (1, 2**16 + 1, 2**31 - 2, 2**31 - 1):
        want = np.asarray(JH.jx_mulhi32(jnp.asarray(a), b)).astype(np.int64)
        np.testing.assert_array_equal(H.t_mulhi32(_t(a), b).numpy(), want)
        np.testing.assert_array_equal(
            want, (a.astype(np.uint64) * np.uint64(b)) >> np.uint64(32))
    lane = torch.tensor([[2**31 - 1], [3]])
    np.testing.assert_array_equal(
        H.t_mulhi32(_t(a), lane).numpy(),
        (a.astype(np.uint64)[None] * np.array([[2**31 - 1], [3]], np.uint64)
         >> np.uint64(32)).astype(np.int64))
    with pytest.raises(ValueError):
        H.t_mulhi32(_t(a), 2**31)
    with pytest.raises(ValueError):
        H.t_mulhi32(_t(a), torch.tensor([2**31]))


def _jax_parts(keys):
    xor_u = JXor.build(keys[:300], 9, mode="uniform", seed=4)
    xor_f = JXor.build(keys[:300], 7, mode="fuse", seed=5)
    dyn = JDyn.build(keys[:200], keys[200:500], seed=2**31 + 3)
    chained = JChained.build(keys[:400], keys[400:1200], seed1=6, seed2=7)
    bloom = JBloom.build(keys[:500], 0.01, seed=2**31 + 9)
    return [xor_u, xor_f, dyn, chained, bloom]


def test_concat_tables_and_layout_from_dict_round_trip():
    keys = JH.random_keys(2000, seed=3)
    parts = [f.to_tables() for f in _jax_parts(keys)]
    want_buf, want_lays = JT.concat_tables(parts)
    port_parts = [(t, T.layout_from_dict(type(lay).__name__,
                                         dataclasses.asdict(lay)))
                  for t, lay in parts]
    got_buf, got_lays = T.concat_tables(port_parts)
    np.testing.assert_array_equal(got_buf, want_buf)
    assert got_buf.dtype == np.uint32
    for g, w in zip(got_lays, want_lays):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert g.width == w.width
    # every descriptor kind rebuilds, nested ones included
    x = JT.XorTable(0, 128, "fuse", 1, 64, 5, 7, 48)
    b = JT.BloomTable(0, 128, 4000, 5, 2)
    e = JT.ExactTable(128, 128, "uniform", 2, 40, 3, "a", 269)
    o = JT.OthelloTable(256, 128, 700, 700, 9)
    for lay in (x, b, e, o,
                JT.LsmChainLayout(xor=None, oth=o, n_keys=10),
                JT.LsmChainLayout(xor=x, oth=o, n_keys=10),
                JT.ChainedAndLayout(xor=x, exact=e, eps=0.1, n_pos=3,
                                    n_neg=4, n_false_pos=1),
                JT.CascadeLayout(layers=(b, b.shift(128)), n_pos=2, n_neg=3,
                                 delta=0.5)):
        got = T.layout_from_dict(type(lay).__name__, dataclasses.asdict(lay))
        assert dataclasses.asdict(got) == dataclasses.asdict(lay)
        assert type(got).__name__ == type(lay).__name__
    assert T.layout_from_dict("LsmChainLayout", dataclasses.asdict(
        JT.LsmChainLayout(xor=None, oth=o, n_keys=1))
    ).oth.offset_b == o.offset_b
    with pytest.raises(ValueError):
        T.layout_from_dict("NoSuchLayout", {})
    np.testing.assert_array_equal(T.pad_words(np.arange(5)),
                                  JT.pad_words(np.arange(5)))
    np.testing.assert_array_equal(common.pad_table(np.arange(300)),
                                  JT.pad_words(np.arange(300)))


def _mixed_chains():
    """Uniform and fuse chains, a chain without stage 1, bloom and always
    tables, interleaved so the groups are not contiguous."""
    def xp(mode, s):
        return (mode, 11 + s, 64 + s, 5 + s, 7 + (s % 3), 31 * s + 17,
                128 * s)

    def op(s):
        return (700 + s, 650 + s, 2**32 - 1 - s, 4000 + s, 4100 + s)

    return (("chain", xp("fuse", 1), op(1)),
            ("bloom", (9000, 7, 2**31 + 1, 256)),
            ("chain", xp("uniform", 2), op(2)),
            ("chain", None, op(3)),
            ("always",),
            ("chain", xp("fuse", 4), op(4)),
            ("chain", xp("uniform", 5), op(5)),
            ("chain", xp("fuse", 6), op(6)))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_pack_chain_params_byte_identical(n):
    chains = _mixed_chains()[:n]
    want = JL.pack_chain_params(chains)
    got = L.pack_chain_params(chains)
    assert got.dtype == want.dtype == np.uint32
    assert got.tobytes() == want.tobytes()
    assert L.chain_params_len(chains) == JL.chain_params_len(chains)
    assert L._group_chains(chains) == JL._group_chains(chains)
    # 12 uniform chains spill past one 128-word block
    many = tuple(("chain", ("uniform", s, 64, 3, 7, s, 0), (9, 9, s, 0, 1))
                 for s in range(12))
    assert L.pack_chain_params(many).tobytes() == \
        JL.pack_chain_params(many).tobytes()
    assert L.chain_params_len(many) == JL.chain_params_len(many) == 256
    assert L.MAX_TABLES == JL.MAX_TABLES == 32


def test_chain_descriptors_point_into_params():
    """Each kernel descriptor row holds the fields ``pack_chain_params``
    packs for its table (the params lanes the JAX kernel reads)."""
    chains = _mixed_chains()
    desc = L.chain_descriptors(chains).view(np.uint32)
    params = L.pack_chain_params(chains)
    assert desc.shape == (len(chains), L.DESC_K)
    groups, scalar = L._group_chains(chains)
    base = 0
    for ts in groups.values():
        for j, t in enumerate(ts):
            assert (desc[t, 0], desc[t, 1], desc[t, 2]) == (
                L.TAG_CHAIN, 1, chains[t][1][0] == "fuse")
            # params order: seed, seg_len, offset, alpha mask, fp seed,
            # n_seg-2, othello seed, ma, mb, offset A, offset B
            fields = params[base + j::len(ts)][:11]
            assert list(desc[t, 3:14]) == [fields[i] for i in
                                           (0, 1, 5, 2, 3, 4, 7, 8, 6, 9, 10)]
        base += 11 * len(ts)
    assert list(desc[3]) == [L.TAG_CHAIN, 0, 0, 0, 0, 0, 0, 0, 0,
                             *chains[3][2], 0, 0]
    assert list(desc[1]) == [L.TAG_BLOOM, 0, 0, *chains[1][1]] + [0] * 9
    assert list(desc[4]) == [L.TAG_ALWAYS] + [0] * 15
    assert L.chain_descriptors(()).shape == (0, L.DESC_K)
    with pytest.raises(ValueError):
        L.chain_descriptors((("nope",),))
