"""Reduce a ``torch.profiler`` trace of the window to device time.

The arithmetic follows ``chip_smoke.py``'s ``device_rows`` /
``device_totals`` / ``busy`` (device-side events only: kernels, copies,
fills), taken here from the profiler's raw events so that each operation
keeps its start and end: busy time is the union of the device intervals
inside the window's span, idle gaps are what lies between them, and each
gap is named by the innermost host event (a harness span, an aten op or a
CUDA runtime call) that covers its middle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    ops: list = field(repr=False)       # (name, start_ns, end_ns), device
    gaps: list = field(repr=False)      # (label, seconds), longest first

    def device_s(self, match=lambda name: True) -> float:
        return sum(e - s for name, s, e in self.ops if match(name)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        totals: dict[str, float] = {}
        for name, s, e in self.ops:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
        return sorted(([n, t] for n, t in totals.items()),
                      key=lambda r: -r[1])[:k]


def idle_pct(run, kind: str) -> float | None:
    """Share of the traced window of a cell of configuration ``kind`` in
    which no kernel, copy or fill ran on the card, in %."""
    t = run.trace
    if run.kind != kind or t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    argument list or template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip() or name


def base_name(name: str) -> str:
    """The last component of a short name (``probe::k`` -> ``k``)."""
    return name.split("::")[-1]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def _union(intervals: np.ndarray) -> np.ndarray:
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    group = np.cumsum(new) - 1
    stops = np.zeros(len(starts), dtype=np.int64)
    np.maximum.at(stops, group, iv[:, 1])
    return np.stack([starts, stops], axis=1)


def parse(prof, n_gaps: int = 10) -> Trace:
    from torch.autograd import DeviceType
    dev, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW_SPAN:
                window = (start, end)
            host.append((start, end, name))
        else:
            dev.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = window
    # a span's shadow on the device's timeline carries the span's name
    spans = {n for _, _, n in host}
    ops = [(short_name(n), max(s, w0), min(e, w1)) for s, e, n in dev
           if e > w0 and s < w1 and n not in spans]
    calls = sum(1 for s, e, n in host if n == CALL_SPAN and w0 <= s < w1)
    busy = _union(np.array([(s, e) for _, s, e in ops], dtype=np.int64)
                  .reshape(-1, 2))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    lengths = edges[:, 1] - edges[:, 0]
    longest = np.argsort(-lengths)[:n_gaps]
    hs = np.array([(s, e) for s, e, n in host if n != WINDOW_SPAN],
                  dtype=np.int64).reshape(-1, 2)
    names = [n for s, e, n in host if n != WINDOW_SPAN]
    gaps = []
    for i in longest:
        if lengths[i] <= 0:
            continue
        mid = (edges[i, 0] + edges[i, 1]) // 2
        cover = np.flatnonzero((hs[:, 0] <= mid) & (hs[:, 1] >= mid))
        label = ("harness, outside any call" if not len(cover) else
                 names[cover[np.argmin(hs[cover, 1] - hs[cover, 0])]])
        gaps.append([label, float(lengths[i]) / 1e9])
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                 calls=calls, ops=ops, gaps=gaps)
