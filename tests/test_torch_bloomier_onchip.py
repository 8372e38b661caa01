"""Port parity for the on-chip path of ``xor_probe``, ``exact_probe`` and
``chained_probe`` (``repro_torch.kernels.bloomier_onchip``): the narrow
planes against a numpy oracle and, as a property, every field read from a
plane against its slot word; the on-chip entry points on the CPU (their
plain versions, every slot read from the planes) against the JAX
package's Pallas kernels in interpret mode on ``selfcheck.filter_case``
filters; the plan and the rule at their edges; and
``FilterService.refresh_tables`` packing new planes from new contents.
Tolerance: exact equality (integer outputs)."""
import copy
import functools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core import hashing as JH  # noqa: E402
from repro.kernels import common as JC  # noqa: E402
from repro.kernels import ops as JOps  # noqa: E402
from repro.kernels.chained_probe import chained_probe as j_chained  # noqa: E402
from repro.kernels.xor_probe import exact_probe as j_exact  # noqa: E402
from repro.kernels.xor_probe import xor_probe as j_xor  # noqa: E402
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core.bloomier import XorFilter  # noqa: E402
from repro_torch.kernels import bloomier_onchip as B  # noqa: E402
from repro_torch.kernels import selfcheck  # noqa: E402
from repro_torch.kernels.xor_probe import (xor_probe, xor_probe_onchip,  # noqa: E402
                                           xor_probe_ref)
from repro_torch.serving.filter_service import FilterService  # noqa: E402

PER = 240


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


# -- the planes ---------------------------------------------------------------

@pytest.mark.parametrize("alpha,width", [(1, 1), (2, 2), (3, 4), (8, 8),
                                         (9, 16), (16, 16)])
def test_pack_plane_matches_numpy_oracle(alpha, width):
    rng = np.random.default_rng(alpha)
    seg_len, n_seg, offset = 8, 5, 36          # 40 slots behind 36 words
    bank = rng.integers(0, 2**32, offset + seg_len * n_seg + 7,
                        dtype=np.uint32)
    plane = B.pack_plane(_t(bank), ("fuse", 1, seg_len, n_seg, offset), alpha)
    assert (plane.width, plane.alpha, plane.n_slots) == (width, alpha, 40)
    assert plane.words.numel() % 4 == 0
    fields = bank[offset:offset + 40].astype(np.uint64) & ((1 << alpha) - 1)
    per = 32 // width
    want = np.zeros(plane.words.numel(), np.uint64)
    for s, f in enumerate(fields):                # LSB-first, no straddle
        want[s // per] |= f << np.uint64((s % per) * width)
    np.testing.assert_array_equal(
        plane.words.numpy().view(np.uint32), want.astype(np.uint32))


def test_no_plane_above_16_bits():
    assert B.field_width(16) == 16 and B.field_width(17) is None
    with pytest.raises(ValueError):
        B.pack_plane(torch.zeros(64, dtype=torch.int32),
                     ("fuse", 1, 8, 3, 0), 17)


# -- the on-chip entry points against the Pallas kernels ---------------------

@functools.lru_cache(maxsize=None)
def _case(kernel, arg):
    """(bank, layout, keys, filter, JAX outputs) of one filter case."""
    tables, lay, q, f = selfcheck.filter_case(kernel, arg, per=PER, seed=5)
    hi2d, lo2d, n = JC.blockify(*JH.np_split_u64(q))
    if kernel == "xor_probe":
        outs = (j_xor(tables, hi2d, lo2d, mode=lay.mode, seed=lay.seed,
                      seg_len=lay.seg_len, n_seg=lay.n_seg, alpha=lay.alpha,
                      fp_seed=lay.fp_seed, offset=lay.offset,
                      interpret=True),)
    elif kernel == "exact_probe":
        outs = (j_exact(tables, hi2d, lo2d, mode=lay.mode, seed=lay.seed,
                        seg_len=lay.seg_len, n_seg=lay.n_seg,
                        strategy=lay.strategy, bit_seed=lay.bit_seed,
                        offset=lay.offset, interpret=True),)
    else:
        outs = j_chained(tables, hi2d, lo2d, interpret=True,
                         **JOps.chained_and_params(lay))
    want = tuple(np.asarray(o).ravel()[:n] for o in outs)
    return tables, lay, q, f, want


REPLAY_CASES = (
    [("xor_probe", (a, "fuse")) for a in (1, 3, 8, 9, 16, 17, 32)]
    + [("xor_probe", (8, "uniform")), ("exact_probe", "a"),
       ("exact_probe", "b"), ("chained_probe", "stage 1"),
       ("chained_probe", "no stage 1"), ("chained_probe", "eps>0")])


@pytest.mark.parametrize("kernel,arg", REPLAY_CASES,
                         ids=[f"{k}:{a}" for k, a in REPLAY_CASES])
def test_onchip_replay_matches_jax_interpret(kernel, arg):
    tables, lay, q, f, want = _case(kernel, arg)
    words = _t(tables)
    hi, lo = (_t(a) for a in JH.np_split_u64(q))
    np.testing.assert_array_equal(want[0].astype(bool), f.query(q))
    alpha = arg[0] if kernel == "xor_probe" else 1
    kern, _ = selfcheck.filter_calls(kernel, lay, words, "onchip")
    if B.field_width(alpha) is None:
        with pytest.raises(ValueError):         # no plane above 16 bits
            kern(hi, lo)
    else:
        for g, w in zip(kern(hi, lo), want):
            np.testing.assert_array_equal(g.numpy(), w)
    # every entry point on the CPU runs a plain version of the same bits
    for path in (None, "gather"):
        kern, _ = selfcheck.filter_calls(kernel, lay, words, path)
        for g, w in zip(kern(hi, lo), want):
            np.testing.assert_array_equal(g.numpy(), w)


# -- every field the kernel reads ---------------------------------------------

@settings(max_examples=40, deadline=None)
@given(alpha=st.integers(1, 16), n_slots=st.integers(1, 3000),
       offset=st.integers(0, 40), seed=st.integers(0, 2**32 - 1))
def test_plane_fields_are_the_slots_low_bits(alpha, n_slots, offset, seed):
    """The field the kernel reads for any slot (``plane_field``, as
    ``probe::SharedPlane`` reads it) is the slot word's low α bits, and the
    plane's words are what one block copies."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 2**32, offset + n_slots + 3, dtype=np.uint32)
    plane = B.pack_plane(_t(bank), ("uniform", 1, n_slots, 1, offset), alpha)
    width = B.field_width(alpha)
    assert plane.words.numel() == B.plane_words(n_slots, width)
    assert plane.words.numel() % 4 == 0
    assert plane.words.numel() * 32 >= n_slots * width
    slots = torch.from_numpy(rng.integers(0, n_slots, 64))
    got = B.plane_field(plane, slots).numpy()
    want = bank[offset + slots.numpy()].astype(np.int64) & ((1 << alpha) - 1)
    np.testing.assert_array_equal(got, want)


# -- the rule at its edges -----------------------------------------------------

ONE = B.BLOCK_BYTES // 2048     # 16384-slot 1-bit segments one block holds


def _g(seg_len, n_seg, alpha=1, mode="fuse"):
    return B.Geometry(mode, seg_len, n_seg, alpha)


PLAN_CASES = {
    "1-bit plane at the one-block limit": ((_g(16384, ONE),), True),
    "one segment over": ((_g(16384, ONE + 1),), False),
    "filters cell exact table (217 KB)": ((_g(16384, 106),), True),
    "filters cell Xor alpha 8 (1.15 MB)": ((_g(8192, 140, 8),), False),
    "filters cell chained (860 KB)": ((_g(8192, 140, 3), _g(16384, 140)),
                                      False),
    "two planes sharing one block": ((_g(2048, 100, 3), _g(8192, 100)),
                                     True),
    "two planes, one segment too many": ((_g(2048, 100, 3),
                                          _g(16384, ONE - 50 + 1)), False),
    "two planes at the one-block limit": ((_g(2048, 100, 3),
                                           _g(16384, ONE - 50)), True),
    "uniform in one block": ((_g(1024, 3, 8, "uniform"),), True),
    "uniform over one block": ((_g(16384 * ONE // 3 + 128, 3, 1, "uniform"),),
                               False),
    "alpha 16 in one block": ((_g(1024, 100, 16),), True),
    "alpha 17": ((_g(8, 3, 17),), False),
    "least fuse table": ((_g(8, 3),), True),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_at_its_edges(name):
    geos, fits = PLAN_CASES[name]
    p, why = B.plan_reason(geos)
    assert (p is not None) == fits and (why is None) == fits
    if not fits:
        assert B.onchip_reason(geos, 1 << 22) == why
        return
    assert p.smem_bytes == 4 * sum(p.n_words) <= B.BLOCK_BYTES
    assert all(n % 4 == 0 for n in p.n_words)
    assert p.smem_words == tuple(sum(p.n_words[:k])
                                 for k in range(len(geos)))
    for g, n in zip(geos, p.n_words):
        assert n == B.plane_words(g.seg_len * g.n_seg,
                                  B.field_width(g.alpha))


def test_onchip_reason_follows_the_keys():
    exact = (_g(16384, 106),)
    assert B.onchip_reason(exact, B.MIN_KEYS) is None
    assert B.onchip_reason(exact, 1 << 22) is None
    assert "too few" in B.onchip_reason(exact, B.MIN_KEYS - 1)
    assert "one block" in B.onchip_reason((_g(8192, 140, 8),), 1 << 22)


def test_onchip_entry_points_refuse_what_no_plan_holds():
    tables, lay, q, _, _ = _case("xor_probe", (17, "fuse"))
    words = _t(tables)
    hi, lo = (_t(a) for a in JH.np_split_u64(q))
    a = dict(mode=lay.mode, seed=lay.seed, seg_len=lay.seg_len,
             n_seg=lay.n_seg, alpha=lay.alpha, fp_seed=lay.fp_seed,
             offset=lay.offset)
    with pytest.raises(ValueError):
        xor_probe_onchip(words, hi, lo, **a)
    other = B.pack_plane(words, ("fuse", 1, 8, 3, 0), 8)
    with pytest.raises(ValueError):            # another table's plane
        xor_probe_onchip(words, hi, lo, **dict(a, alpha=8), plane=other)
    over = dict(a, alpha=8, seg_len=16384, n_seg=ONE // 8 + 1, offset=0)
    big = torch.zeros(16384 * over["n_seg"], dtype=torch.int32)
    with pytest.raises(ValueError):            # the plane outgrows a block
        xor_probe_onchip(big, hi, lo, **over)


# -- planes follow a bank's contents ------------------------------------------------

def test_refresh_tables_packs_new_planes():
    keys = H.random_keys(3000, seed=4)
    f = XorFilter.build(keys[:1000], 8, seed=2**31 + 9)
    svc = FilterService([f], device="cpu")
    old = svc.state
    lay = old.bank.layouts[0]
    table = (lay.mode, lay.seed, lay.seg_len, lay.n_seg, lay.offset)
    assert torch.equal(old.planes[0][0].words,
                       B.pack_plane(old.tables, table, 8).words)
    g = copy.deepcopy(f)
    g.tbl.table[:] ^= np.uint32(0x5A)            # new contents, same layout
    svc.refresh_tables([g])
    new = svc.state
    assert new.bank.layouts == old.bank.layouts and new.descs is old.descs
    assert not torch.equal(new.planes[0][0].words, old.planes[0][0].words)
    assert torch.equal(new.planes[0][0].words,
                       B.pack_plane(new.tables, table, 8).words)
    q = keys[::2]
    hi, lo = (_t(a) for a in JH.np_split_u64(q))
    a = dict(mode=lay.mode, seed=lay.seed, seg_len=lay.seg_len,
             n_seg=lay.n_seg, alpha=8, fp_seed=lay.fp_seed,
             offset=lay.offset)
    want = xor_probe_ref(new.tables, hi, lo, **a)
    got = xor_probe_onchip(new.tables, hi, lo, **a, plane=new.planes[0][0])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(svc.probe(q)[0][0], g.query(q))
    assert torch.equal(xor_probe(new.tables, hi, lo, **a,
                                 plane=new.planes[0][0]), want)
