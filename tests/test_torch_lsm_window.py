"""Port parity for the window path of ``lsm_probe``
(``repro_torch.kernels.lsm_window``): the partition's torch twin against
the JAX package's fuse slot layout, the probe replayed in bucket order
against the plain version and the JAX kernel (interpret mode), and the
rules that decide where the path applies, at their edges.
Tolerance: exact equality (integer outputs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from repro.core.bloomier import SlotLayout as JSlotLayout  # noqa: E402
from repro.kernels import common as JC  # noqa: E402
from repro.kernels.lsm_probe import lsm_probe as j_lsm_probe  # noqa: E402
from repro_torch.kernels import lsm_probe as L  # noqa: E402
from repro_torch.kernels import lsm_window as W  # noqa: E402
from repro_torch.kernels import selfcheck  # noqa: E402

PER = 240
FUSE4 = ("fuse",) * 4


def _case(kinds, per=PER, seed=0, n=None):
    return selfcheck.lsm_case(kinds, "cpu", per=per, seed=seed, n=n)


def _desc(chains):
    return torch.from_numpy(L.chain_descriptors(chains))


@pytest.mark.parametrize("kinds,seed", [(FUSE4, 0), (("fuse",) * 8, 3)])
def test_partition_twin_matches_jax_fuse_slots(kinds, seed):
    words, hi, lo, chains = _case(kinds, seed=seed)
    part = W.partition_ref(hi, lo, chains)
    bucket = W.buckets_ref(hi, lo, chains)
    n = hi.numel()
    hi_np = hi.numpy().view(np.uint32)
    lo_np = lo.numpy().view(np.uint32)
    base = 0
    for t, chain in enumerate(chains):
        mode, seed1, seg_len, n_seg, _, _, _ = chain[1]
        slots = JSlotLayout(mode, n_seg * seg_len, seg_len, n_seg,
                            seed1).slots_np(hi_np, lo_np)
        w = (bucket[t] - base).numpy()
        assert ((w >= 0) & (w < n_seg - 2)).all()
        for s in slots:      # every slot inside the key's 3-segment window
            s = np.asarray(s, np.int64)
            assert ((s >= w * seg_len) & (s < (w + 3) * seg_len)).all()
        np.testing.assert_array_equal(np.asarray(slots[0]) // seg_len, w)
        base += n_seg - 2
    # stable bucket order: buckets ascending, key index ascending in each
    counts = torch.bincount(bucket.reshape(-1), minlength=W.n_buckets(chains))
    assert torch.equal(part.bstart[1:] - part.bstart[:-1], counts.int())
    assert int(part.bstart[-1]) == n * len(chains)
    for g in range(W.n_buckets(chains)):
        b, e = int(part.bstart[g]), int(part.bstart[g + 1])
        idx = part.s_idx[b:e].long()
        assert bool((idx[1:] > idx[:-1]).all())
        t = _table_of(chains, g)
        assert bool((bucket[t, idx] == g).all())
        assert torch.equal(part.s_hi[b:e], hi[idx])
        assert torch.equal(part.s_lo[b:e], lo[idx])


def _table_of(chains, g):
    base = 0
    for t, chain in enumerate(chains):
        base += chain[1][3] - 2
        if g < base:
            return t
    raise IndexError(g)


WINDOW_CASES = {
    "T=1": dict(kinds=("fuse",)),
    "T=16": dict(kinds=("fuse",) * 16),
    "T=32 bit 31": dict(kinds=("fuse",) * 32),
    "one window each, n=1": dict(kinds=("fuse",) * 16, per=2, n=1),
    "empty windows, n=6": dict(kinds=("fuse",) * 8, per=20, seed=1, n=6),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_replay_equals_plain_versions(case):
    args = dict(WINDOW_CASES[case])
    words, hi, lo, chains = _case(args.pop("kinds"), **{"per": PER, **args})
    assert W.window_reason(chains, hi.numel(), words.data_ptr()) is None
    got = L.lsm_probe_window(words, hi, lo, _desc(chains), chains=chains)
    want = L.lsm_probe_ref(words, hi, lo, chains=chains)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] != 0).any()                       # something fired
    if len(chains) == 32:
        assert (got[1] < 0).any()                    # table 31 fired
    if case.startswith("empty"):
        part = W.partition_ref(hi, lo, chains)
        assert (part.bstart[1:] == part.bstart[:-1]).any()


def test_window_replay_matches_jax_kernels():
    words, hi, lo, chains = _case(FUSE4)
    tables = words.numpy().view(np.uint32)
    h2, l2, n = JC.blockify(hi.numpy().view(np.uint32),
                            lo.numpy().view(np.uint32))
    want_f, want_m = j_lsm_probe(tables, h2, l2, chains=chains, interpret=True)
    got_f, got_m = L.lsm_probe_window(words, hi, lo, _desc(chains),
                                      chains=chains)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f).ravel()[:n])
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m).ravel()[:n])


# eligibility at its edges: a 500k-key table's layout (seg_len 8192, 72
# segments: 70 windows) and a 2**20-key batch
OTH = (4096, 4096, 1, 1 << 20, (1 << 20) + 128)


def _chain(seg_len=8192, n_seg=72, offset=128, mode="fuse"):
    return ("chain", (mode, 5, seg_len, n_seg, 7, 9, offset), OTH)


THRESHOLD = 70 * 8192 // 8          # (n_seg - 2) * seg_len / 8 = 71,680
BUDGET_SEG = W.WINDOW_BYTES_MAX // 12 // 4 * 4   # largest 16-B seg_len
ELIGIBILITY = [
    ("main shapes", (_chain(),) * 16, 1 << 20, 0, True),
    ("seg_len 8192 (96 KB)", (_chain(),), THRESHOLD, 0, True),
    ("seg_len at the budget", (_chain(BUDGET_SEG, 3),), 1 << 20, 0, True),
    ("seg_len past the budget", (_chain(BUDGET_SEG + 4, 3),), 1 << 20, 0,
     False),
    ("seg_len 16384 (192 KB)", (_chain(16384, 40),), 1 << 22, 0, False),
    ("seg_len 32768 (384 KB)", (_chain(32768, 40),), 1 << 24, 0, False),
    ("uniform layout", (_chain(mode="uniform"),), 1 << 20, 0, False),
    ("bloom table", (_chain(), ("bloom", (1 << 20, 7, 3, 0))), 1 << 20, 0,
     False),
    ("always table", (("always",), _chain()), 1 << 20, 0, False),
    ("no stage 1", (("chain", None, OTH),), 1 << 20, 0, False),
    ("offset not 16-B aligned", (_chain(offset=130),), 1 << 20, 0, False),
    ("seg_len not 16-B aligned", (_chain(seg_len=10, n_seg=3),), 1 << 20, 0,
     False),
    ("bank pointer not 16-B aligned", (_chain(),), 1 << 20, 8, False),
    ("keys at the threshold", (_chain(),), THRESHOLD, 0, True),
    ("keys below the threshold", (_chain(),), THRESHOLD - 1, 0, False),
    ("512 windows", (_chain(8, 514),), 1 << 20, 0, True),
    ("513 windows", (_chain(8, 515),), 1 << 20, 0, False),
    ("n x T at 2**31", (_chain(),) * 32, 1 << 26, 0, False),
]


@pytest.mark.parametrize("name,chains,n,ptr,ok", ELIGIBILITY,
                         ids=[e[0] for e in ELIGIBILITY])
def test_window_eligibility_edges(name, chains, n, ptr, ok):
    reason = W.window_reason(chains, n, ptr)
    assert (reason is None) == ok, reason


def test_window_wrappers_refuse_what_the_rule_refuses():
    words, hi, lo, chains = _case(("fuse", "uniform"))
    with pytest.raises(ValueError):
        L.lsm_probe_window(words, hi, lo, _desc(chains), chains=chains)
    words, hi, lo, chains = _case(FUSE4, n=20)       # too few keys
    with pytest.raises(ValueError):
        L.lsm_probe_window(words, hi, lo, _desc(chains), chains=chains)
    # the public wrappers serve every bank, by either path
    for g, w in zip(L.lsm_probe(words, hi, lo, _desc(chains), chains=chains),
                    L.lsm_probe_ref(words, hi, lo, chains=chains)):
        assert torch.equal(g, w)


def test_scratch_bytes_at_the_main_shapes():
    chains = (_chain(),) * 16
    n = 1 << 20
    units = n // W.UNIT_KEYS
    assert W.n_buckets(chains) == 1120
    assert W.window_words(chains) == 3 * 8192
    assert W.scratch_bytes(chains, n) == 4 * (3 * n * 16 + 1120 * units
                                              + 2 * 1120 + 2)
    assert 201e6 < W.scratch_bytes(chains, n) < 203e6


# where lsm_probe takes the window path: window_reason's conditions, at
# least MIN_TABLES tables and MIN_KEYS keys, scratch within
# 1/SCRATCH_SHARE of the card
CARD = 80 * 2**30
MAIN = (_chain(),) * 16
MAIN_SCRATCH = W.scratch_bytes(MAIN, 1 << 20)
PATH = [
    ("main shapes", MAIN, 1 << 20, CARD, True),
    ("window_reason refuses", (_chain(mode="uniform"),) * 16, 1 << 20, CARD,
     False),
    ("MIN_TABLES tables", (_chain(),) * W.MIN_TABLES, 1 << 20, CARD, True),
    ("one table fewer", (_chain(),) * (W.MIN_TABLES - 1), 1 << 20, CARD,
     False),
    ("one table", (_chain(),), 1 << 20, CARD, False),
    ("MIN_KEYS keys", MAIN, W.MIN_KEYS, CARD, True),
    ("one key fewer", MAIN, W.MIN_KEYS - 1, CARD, False),
    ("scratch at the share", MAIN, 1 << 20, W.SCRATCH_SHARE * MAIN_SCRATCH,
     True),
    ("scratch past the share", MAIN, 1 << 20,
     W.SCRATCH_SHARE * MAIN_SCRATCH - 1, False),
    ("a large batch on the card", MAIN, 1 << 26, CARD, False),
]


@pytest.mark.parametrize("name,chains,n,card,ok", PATH,
                         ids=[e[0] for e in PATH])
def test_path_reason_edges(name, chains, n, card, ok):
    reason = W.path_reason(chains, n, 0, card)
    assert (reason is None) == ok, reason
    if not ok and W.window_reason(chains, n, 0) is None:
        assert "too few" in reason or "scratch" in reason

