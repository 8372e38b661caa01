"""Port parity for the on-chip path of ``bloom_probe`` and
``cascade_probe`` (``repro_torch.kernels.bloom_onchip``): the rule that
decides where the path applies and where it keeps the bitmap, at its
edges; the staged span and its rebased layer offsets; and the on-chip
entry points on the CPU (their plain versions, reading the bitmap where
the kernel's plan keeps it) against the JAX package's Pallas kernels in
interpret mode on ``selfcheck.filter_case`` banks.
Tolerance: exact equality (integer outputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.kernels import common as JC  # noqa: E402
from repro.kernels.bloom_probe import bloom_probe as j_bloom  # noqa: E402
from repro.kernels.cascade_probe import cascade_probe as j_cascade  # noqa: E402
from repro_torch.kernels import bloom_onchip as B  # noqa: E402
from repro_torch.kernels import selfcheck  # noqa: E402
from repro_torch.kernels.bloom_probe import (bloom_probe,  # noqa: E402
                                             bloom_probe_onchip)
from repro_torch.kernels.cascade_probe import (cascade_descriptors,  # noqa: E402
                                               cascade_probe_onchip)

PER = 240
ROOM = B.block_words(1)          # span words one block holds beside a layer
BANK = 4 * ROOM                  # words of a bank that holds every span below


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _layer(words, offset=128, k=7):
    return (32 * words - 5, k, 2**31 + 1, offset)


def _layers(n, words=64):
    return tuple(_layer(words, 128 * (i + 1)) for i in range(n))


N = B.MIN_LOCAL_KEYS
# (layers, keys, bank words, bank address) -> on-chip path or not
REASON_CASES = {
    "staged span at the one-block limit": (((_layer(ROOM),), N, BANK, 0),
                                           True),
    "staged, MIN_LOCAL_KEYS - 1 keys": (((_layer(4000),), N - 1, BANK, 0),
                                        False),
    "staged, MAX_LOCAL_KEYS - 1 keys": (
        ((_layer(4000),), B.MAX_LOCAL_KEYS - 1, BANK, 0), True),
    "staged, MAX_LOCAL_KEYS keys": (
        ((_layer(4000),), B.MAX_LOCAL_KEYS, BANK, 0), False),
    "one layer one word over the limit, in L2": (
        ((_layer(ROOM + 1),), N, BANK, 0), False),
    "one layer, span not 16-byte aligned, in L2": (
        ((_layer(4000, 130),), N, BANK, 0), False),
    "one layer, bank not 16-byte aligned, in L2": (
        ((_layer(4000),), N, BANK, 4), False),
    "one layer, span rounded to 16 B past the bank, in L2": (
        (((32 * 4001, 7, 1, 128),), N, 128 + 4002, 0), False),
    "span rounded to 16 B at the bank's end, staged": (
        (((32 * 4001, 7, 1, 128),), N, 128 + 4004, 0), True),
    "two layers in L2, one key": (
        ((_layer(ROOM, 128), _layer(64, 128 + ROOM + 128)), 1, BANK, 0),
        True),
    "two layers staged, one key": ((_layers(2), 1, BANK, 0), True),
    "MAX_LAYERS layers, staged": ((_layers(B.MAX_LAYERS), N, BANK, 0), True),
    "MAX_LAYERS + 1 layers": ((_layers(B.MAX_LAYERS + 1), N, BANK, 0),
                              False),
}


@pytest.mark.parametrize("name", list(REASON_CASES))
def test_onchip_reason_at_its_edges(name):
    (layers, n, bank_words, ptr), onchip = REASON_CASES[name]
    why = B.onchip_reason(layers, n, bank_words, ptr)
    assert (why is None) == onchip, why
    if len(layers) > B.MAX_LAYERS:      # the kernel cannot take it at all
        with pytest.raises(ValueError):
            B.check(layers)


@pytest.mark.parametrize("layers,bank_words,ptr,want", [
    ((_layer(ROOM),), BANK, 0, (B.LOCAL, 128, ROOM)),
    ((_layer(ROOM + 1),), BANK, 0, (B.GLOBAL, 0, 0)),
    ((_layer(4000, 130),), BANK, 0, (B.GLOBAL, 0, 0)),
    ((_layer(4000),), BANK, 16, (B.LOCAL, 128, 4000)),
    # a cascade's span: its first layer's offset to the end of its last
    (((64, 3, 1, 512), (4000, 2, 1, 256), (100, 1, 1, 1024)), BANK, 0,
     (B.LOCAL, 256, 1024 + 4 - 256)),
])
def test_plan_keeps_the_span_where_it_fits(layers, bank_words, ptr, want):
    assert tuple(B.plan(layers, bank_words, ptr)) == want


def test_staged_span_reassembles_every_layer():
    tables, layers = selfcheck.synthetic_cascade((300, 4000, 128, 77))
    words = _t(tables)
    p = B.plan(layers, words.numel())
    assert p.mode == B.LOCAL and p.stage_words % 4 == 0
    held = B.staged_ref(words, p)
    assert held.numel() == p.stage_words
    for m_bits, _, _, offset in layers:   # rebased offsets, the same words
        n_words = (m_bits + 31) // 32
        assert torch.equal(held[offset - p.base:offset - p.base + n_words],
                           words[offset:offset + n_words])
    assert torch.equal(B.staged_ref(words, B.Plan(B.GLOBAL, 0, 0)), words)
    assert B.grid_blocks(1) == 1 and B.grid_blocks(B.THREADS + 1) == 2


def _jax_bloom(tables, lay, q):
    hi2d, lo2d, n = JC.blockify(*JH.np_split_u64(q))
    out = j_bloom(tables, hi2d, lo2d, m_bits=lay.m_bits, k=lay.k,
                  seed=lay.seed, offset=lay.offset, interpret=True)
    return np.asarray(out).ravel()[:n]


def _jax_cascade(tables, lay, q):
    hi2d, lo2d, n = JC.blockify(*JH.np_split_u64(q))
    outs = j_cascade(tables, hi2d, lo2d, layers=lay.probe_params(),
                     interpret=True)
    return tuple(np.asarray(o).ravel()[:n] for o in outs)


PLANS = ("staged", "in L2")


def _plan(layers, words, where):
    p = B.plan(layers, words.numel())
    assert p.mode == B.LOCAL and p.base > 0
    return p if where == "staged" else B.Plan(B.GLOBAL, 0, 0)


@pytest.mark.parametrize("where", PLANS)
def test_bloom_onchip_matches_jax_interpret(where):
    tables, lay, q, f = selfcheck.filter_case("bloom_probe", 0.01, per=PER,
                                              seed=5)
    words = _t(tables)
    hi, lo = (_t(a) for a in JH.np_split_u64(q))
    want = _jax_bloom(tables, lay, q)
    layer = (lay.m_bits, lay.k, lay.seed, lay.offset)
    assert lay.seed >= 2**31 and lay.offset > 0
    got, _ = B.onchip_ref(words, hi, lo, layers=(layer,),
                          p=_plan((layer,), words, where))
    np.testing.assert_array_equal(got.numpy(), want)
    args = dict(m_bits=lay.m_bits, k=lay.k, seed=lay.seed, offset=lay.offset)
    np.testing.assert_array_equal(bloom_probe_onchip(words, hi, lo, **args)
                                  .numpy(), want)
    np.testing.assert_array_equal(bloom_probe(words, hi, lo, **args).numpy(),
                                  want)
    np.testing.assert_array_equal(want.astype(bool), f.query(q))
    assert want.any() and not want.all()


@pytest.mark.parametrize("depth", [1, 18])
@pytest.mark.parametrize("where", PLANS)
def test_cascade_onchip_matches_jax_interpret(depth, where):
    tables, lay, q, f = selfcheck.filter_case("cascade_probe", depth,
                                              per=PER, seed=5)
    words = _t(tables)
    hi, lo = (_t(a) for a in JH.np_split_u64(q))
    want = _jax_cascade(tables, lay, q)
    layers = lay.probe_params()
    assert all(s >= 2**31 for _, _, s, _ in layers)
    got = B.onchip_ref(words, hi, lo, layers=layers,
                       p=_plan(layers, words, where))
    desc = torch.from_numpy(cascade_descriptors(layers))
    entry = cascade_probe_onchip(words, hi, lo, desc, layers=layers)
    for g, e, w in zip(got, entry, want):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(e.numpy(), w)
    np.testing.assert_array_equal(want[0].astype(bool), f.query(q))
    np.testing.assert_array_equal(want[1], f.probes_until_decided(q))


def test_onchip_entry_points_refuse_what_the_kernel_cannot_take():
    tables, layers = selfcheck.synthetic_cascade((128,) * (B.MAX_LAYERS + 1))
    words = _t(tables)
    z = torch.zeros(8, dtype=torch.int32)
    desc = torch.from_numpy(cascade_descriptors(layers))
    with pytest.raises(ValueError):         # more layers than it stages
        cascade_probe_onchip(words, z, z, desc, layers=layers)
    with pytest.raises(ValueError):         # k < 0
        bloom_probe_onchip(words, z, z, m_bits=64, k=-1, seed=1, offset=128)
    with pytest.raises(ValueError):         # past the bank
        bloom_probe_onchip(words, z, z, m_bits=64, k=2, seed=1,
                           offset=words.numel() - 1)
