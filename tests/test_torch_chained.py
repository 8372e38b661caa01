"""Port parity, slice 2 host side: the theory copy, ExactBloomier,
ChainedFilterAnd and ChainedFilterCascade (build, query, probe counts,
online training) and FilterBank packing of the five serving filter kinds
— the PyTorch port against the JAX package on the same numpy keys and
seeds. Tolerance: exact equality (buffers, layouts, booleans, counts;
theory floats bit for bit)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.core import theory as JT  # noqa: E402
from repro.core.bloom import BloomFilter as JBloom  # noqa: E402
from repro.core.bloomier import ExactBloomier as JExact  # noqa: E402
from repro.core.bloomier import XorFilter as JXor  # noqa: E402
from repro.core.chained import ChainedFilterAnd as JAnd  # noqa: E402
from repro.core.chained import ChainedFilterCascade as JCascade  # noqa: E402
from repro.serving.filter_service import FilterBank as JBank  # noqa: E402
from repro_torch.core import theory as T  # noqa: E402
from repro_torch.core.bloom import BloomFilter  # noqa: E402
from repro_torch.core.bloomier import ExactBloomier, XorFilter  # noqa: E402
from repro_torch.core.chained import (ChainedFilterAnd,  # noqa: E402
                                      ChainedFilterCascade)
from repro_torch.core.tables import layout_from_dict  # noqa: E402
from repro_torch.serving.filter_service import FilterBank  # noqa: E402

KEYS = JH.random_keys(30_000, seed=29)
N_POS = 1500
POS = KEYS[:N_POS]
QUERIES = np.concatenate([KEYS[:4000], KEYS[-2000:]])   # pos, neg, unseen


def _same_layout(port_lay, ref_lay):
    assert type(port_lay).__name__ == type(ref_lay).__name__
    fields = dataclasses.asdict(ref_lay)
    assert port_lay == layout_from_dict(type(ref_lay).__name__, fields)
    assert dataclasses.asdict(port_lay) == fields


def _same_tables(port, ref):
    (pt, pl), (rt, rl) = port.to_tables(), ref.to_tables()
    assert pt.dtype == rt.dtype == np.uint32
    assert pt.tobytes() == rt.tobytes()
    _same_layout(pl, rl)


def test_theory_copy_matches_the_reference():
    grid = [(e, lam) for e in (0.0, 1e-4, 0.01, 0.2, 0.5, 1.0)
            for lam in (0.0, 0.5, 1.5, 2.0, 8.0, 100.0, 1e6)]
    for eps, lam in grid:
        assert T.f_lower_bound(eps, lam) == JT.f_lower_bound(eps, lam)
        if eps < 1.0 and lam > 0:
            assert T.corollary_4_1_space(eps, lam) == \
                JT.corollary_4_1_space(eps, lam)
            assert T.corollary_4_1_space(eps, lam, C=1.0) == \
                JT.corollary_4_1_space(eps, lam, C=1.0)
    for lam in (0.5, 1.5, 8.0, 1e3):
        for name in ("optimal_eps_prime_exact", "chained_and_space_exact",
                     "chained_and_space_exact_rounded",
                     "chained_cascade_space_exact", "exact_bloomier_space"):
            assert getattr(T, name)(lam) == getattr(JT, name)(lam)
    assert T.chain_rule_gap(0.01, 8.0, 0.1) == JT.chain_rule_gap(0.01, 8.0, 0.1)
    assert T.cuckoo_lambda(0.3) == JT.cuckoo_lambda(0.3)
    assert T.huffman_overhead_bound() == JT.huffman_overhead_bound()


@pytest.mark.parametrize("strategy,mode,seed", [("a", "fuse", 13),
                                                ("b", "uniform", 2**31 + 5)])
def test_exact_bloomier_identical(strategy, mode, seed):
    pos, neg = KEYS[:800], KEYS[800:2400]
    port = ExactBloomier.build(pos, neg, strategy=strategy, mode=mode,
                               seed=seed)
    ref = JExact.build(pos, neg, strategy=strategy, mode=mode, seed=seed)
    _same_tables(port, ref)
    assert port.bit_seed == ref.bit_seed == seed * 131 + 7
    assert port.bits == ref.bits
    np.testing.assert_array_equal(port.query(QUERIES), ref.query(QUERIES))
    assert port.query(pos).all() and not port.query(neg).any()
    back = ExactBloomier.from_tables(*ref.to_tables())
    np.testing.assert_array_equal(back.query(QUERIES), ref.query(QUERIES))
    with pytest.raises(ValueError):
        ExactBloomier.build(pos, neg, strategy="c")


@pytest.mark.parametrize("lam,eps", [(1.5, 0.0), (8, 0.0), (1.5, 0.01),
                                     (8, 0.01)])
def test_chained_and_identical(lam, eps):
    neg = KEYS[N_POS:N_POS + int(lam * N_POS)]
    port = ChainedFilterAnd.build(POS, neg, eps=eps, seed=14)
    ref = JAnd.build(POS, neg, eps=eps, seed=14)
    _same_tables(port, ref)
    assert (port.f1 is None) == (ref.f1 is None)
    assert (port.f1 is None) == (lam < 2)        # λ < 2: no stage 1
    assert port.f2.strategy == ref.f2.strategy
    assert (port.bits, port.n_false_pos) == (ref.bits, ref.n_false_pos)
    np.testing.assert_array_equal(port.query(QUERIES), ref.query(QUERIES))
    for a, b in zip(port.stage_queries(QUERIES), ref.stage_queries(QUERIES)):
        np.testing.assert_array_equal(a, b)
    if eps == 0:                                  # exact over its universe
        assert port.query(POS).all() and not port.query(neg).any()
    back = ChainedFilterAnd.from_tables(*ref.to_tables())
    np.testing.assert_array_equal(back.query(QUERIES), ref.query(QUERIES))


def test_cascade_build_identical():
    neg = KEYS[N_POS:9 * N_POS]
    port = ChainedFilterCascade.build(POS, neg, seed=3)
    ref = JCascade.build(POS, neg, seed=3)
    _same_tables(port, ref)
    assert port.n_layers == ref.n_layers > 2
    assert port.bits == ref.bits
    np.testing.assert_array_equal(port.query(QUERIES), ref.query(QUERIES))
    np.testing.assert_array_equal(port.probes_until_decided(QUERIES),
                                  ref.probes_until_decided(QUERIES))
    assert port.query(POS).all() and not port.query(neg).any()
    back = ChainedFilterCascade.from_tables(*ref.to_tables())
    np.testing.assert_array_equal(back.query(QUERIES), ref.query(QUERIES))


@pytest.mark.parametrize("n_layers", [2, 12])
def test_cascade_empty_and_train_identical(n_layers):
    """§5.3 online training: equal error curves and equal tables after
    every round of training, including layers that train appends when
    the pre-sized layers saturate (n_layers = 2)."""
    port = ChainedFilterCascade.empty(N_POS, 8.0, n_layers=n_layers, seed=4)
    ref = JCascade.empty(N_POS, 8.0, n_layers=n_layers, seed=4)
    _same_tables(port, ref)
    rng = np.random.default_rng(11)
    for step in range(3):
        idx = rng.choice(len(KEYS), 3000, replace=False)
        keys = KEYS[idx]
        labels = idx < 4 * N_POS
        errs = port.train(keys, labels)
        assert errs == ref.train(keys, labels)
        assert errs[-1] == 0.0
        _same_tables(port, ref)
    if n_layers == 2:
        assert port.n_layers > n_layers              # train appended layers
    np.testing.assert_array_equal(port.probes_until_decided(QUERIES),
                                  ref.probes_until_decided(QUERIES))


def test_filter_bank_pack_identical_for_five_kinds():
    neg = KEYS[N_POS:9 * N_POS]
    build = [
        (BloomFilter, JBloom, lambda c: c.build(POS, 0.01, seed=11)),
        (XorFilter, JXor, lambda c: c.build(POS, 8, seed=12)),
        (ExactBloomier, JExact,
         lambda c: c.build(POS[:N_POS // 2], neg[:N_POS], seed=13)),
        (ChainedFilterAnd, JAnd, lambda c: c.build(POS, neg, seed=14)),
        (ChainedFilterCascade, JCascade, lambda c: c.build(POS, neg, seed=3)),
    ]
    port = FilterBank.pack([make(p) for p, _, make in build])
    ref = JBank.pack([make(r) for _, r, make in build])
    assert port.tables.tobytes() == ref.tables.tobytes()
    for pl, rl in zip(port.layouts, ref.layouts):
        _same_layout(pl, rl)
    # a JAX-packed bank unpacks into the port's filter classes
    got = FilterBank(ref.tables, tuple(
        layout_from_dict(type(lay).__name__, dataclasses.asdict(lay))
        for lay in ref.layouts)).unpack()
    assert [type(f) for f in got] == [p for p, _, _ in build]
    for f, g in zip(ref.unpack(), got):
        np.testing.assert_array_equal(f.query(QUERIES), g.query(QUERIES))
