"""The roofline count on hand-worked cases, the traffic generator and the
trace reduction, without a run."""
import numpy as np
import pytest

from bench.harness import roofline, trace
from bench.traffic import generate as G


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, roofline.INT32_OPS_PER_S) == pytest.approx(1.0)
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)


def test_lsm_probe_count_by_hand():
    # 2 tables, 1000 keys: bytes 16 a key + the tables; operations per key
    # 5 + 2 * 2 (fold) + 108 (fuse) + 83 (uniform) + 48 * passes
    sizes = {"tables": [{"mode": "fuse", "bytes": 4000},
                        {"mode": "uniform", "bytes": 6000}]}
    n_bytes, n_ops = roofline.lsm_probe(1000, sizes, [0.5, 0.25])
    assert n_bytes == 16 * 1000 + 10000
    assert n_ops == 1000 * (5 + 4 + 108 + 83) + 48 * (500 + 250)


def test_bank_counts_by_hand():
    n = 100
    assert roofline.bank_probe("bloom", n, {"bytes": 64, "k": 7},
                               {"bit_tests": 2.5}) == (12 * n + 64,
                                                       5 * n + 24 * 250)
    assert roofline.bank_probe(
        "exact", n, {"bytes": 40, "mode": "fuse", "hashed_target": False},
        {}) == (12 * n + 40, (5 + 90) * n)
    assert roofline.bank_probe(
        "chained_and", n, {"bytes": 80, "stage1_mode": "fuse", "mode": "fuse",
                           "hashed_target": True},
        {"stage1_passes": 0.25}) == (16 * n + 80, 5 * n + 108 * n + 108 * 25)
    assert roofline.bank_probe(
        "cascade", n, {"bytes": 8, "layers": 3},
        {"layers_reached": 1.5, "bit_tests": 4.0}) == (
            16 * n + 8 + 48, 5 * n + 2 * 150 + 24 * 400)


def test_pools_are_seeded_and_absent_keys_stay_apart():
    stored = G.key_universe(5000, G.phase_seed(9, "keys"))
    assert stored.min() >= 1 and stored.max() < 2 ** 63
    mix = {"draw": "absent", "batch": 100, "pool_batches": 4}
    a = G.draw_pool(mix, {}, 2 ** 33 + 5)
    assert (a >= np.uint64(2 ** 63)).all()
    assert (a == G.draw_pool(mix, {}, 2 ** 33 + 5)).all()
    assert not (a == G.draw_pool(mix, {}, 2 ** 33 + 6)).all()


def test_zipf_pool_is_skewed_and_scrambled():
    stored = G.key_universe(10000, G.phase_seed(1, "keys"))
    mix = {"draw": "stored_zipf", "theta": 0.99, "batch": 1000,
           "pool_batches": 50}
    pool = G.draw_pool(mix, {"stored": stored}, 4)
    assert np.isin(pool, stored).all()
    _, counts = np.unique(pool, return_counts=True)
    assert counts.max() > 50 * counts.mean()
    # the hottest key is rank 0's scrambled place, not the first inserted
    keys, counts = np.unique(pool, return_counts=True)
    hottest = keys[np.argmax(counts)]
    assert hottest == stored[int(G.fnv1a64(np.array([0], np.uint64))[0]
                                 % np.uint64(len(stored)))]
    assert hottest != stored[0]


def test_bank_guarantees_by_hand():
    from bench.harness import compare
    cfg = {"filters": [{"type": "bloom"}, {"type": "exact", "positives": 2,
                                           "negatives": 1},
                       {"type": "chained_and"}]}
    data = {"pos": np.array([1, 2, 3], np.uint64),
            "neg": np.array([7, 8], np.uint64)}
    keys = np.array([1, 3, 7, 8, 9], np.uint64)
    truth = compare.bank_truth(cfg, data, keys)
    assert truth["bloom"][0].tolist() == [True, True, False, False, False]
    assert not truth["bloom"][1].any()           # approximate: no negatives
    assert truth["exact"][0].tolist() == [True, False, False, False, False]
    assert truth["exact"][1].tolist() == [False, False, True, False, False]
    assert truth["chained_and"][1].tolist() == [False, False, True, True,
                                                False]
    m = {"bloom": [True, False, True, True, True],      # 3 missed
         "exact": [True, False, False, True, True],     # 8, 9 are not its
         "chained_and": [True, True, True, False, True]}  # 7 admitted
    answers = {k: {"member": np.array(v)} for k, v in m.items()}
    assert compare.bank_guarantees(answers, truth) == {"false_neg": 1,
                                                       "neg_admitted": 1}


def test_batches_do_not_repeat_within_a_period():
    pool = np.arange(1000, dtype=np.uint64)
    b = G.Batches(pool, 100, 3)
    starts = [b.offset(j) for j in range(b.period)]
    assert len(set(starts)) == b.period
    assert all(len(b(j)) == 100 for j in range(20))


class _Ev:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def test_trace_busy_union_and_gaps():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Ev(trace.WINDOW_SPAN, 1000, 9000, cpu),
        _Ev(trace.CALL_SPAN, 1000, 4000, cpu),
        _Ev(trace.CALL_SPAN, 5000, 5000, cpu),
        _Ev("aten::copy_", 2000, 500, cpu),
        _Ev("k1(int)", 2000, 1000, gpu),           # 2000-3000
        _Ev("k2<3>(float)", 2500, 1000, gpu),      # overlaps: 2000-3500
        _Ev("Memcpy HtoD", 6000, 1000, gpu),       # 6000-7000
        _Ev("k1(int)", 9500, 2000, gpu),           # clipped to 9500-10000
        _Ev(trace.CALL_SPAN, 1000, 9000, gpu),     # a span's device shadow
    ]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    t = trace.parse(prof)
    assert t.window_s == pytest.approx(9e-6)
    assert t.busy_s == pytest.approx((1500 + 1000 + 500) / 1e9)
    assert t.calls == 2
    assert t.device_s(trace.is_copy) == pytest.approx(1e-6)
    assert t.top_ops()[0][0] == "k1"
    assert {"k1", "k2", "Memcpy HtoD"} == {n for n, _ in t.top_ops()}
    # the gaps: 1000-2000, 3500-6000, 7000-9500; the longest two first
    assert [round(g[1] * 1e9) for g in t.gaps] == [2500, 2500, 1000]
    assert t.gaps[2][0] == trace.CALL_SPAN
