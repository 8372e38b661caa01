"""Liveness-based peak-memory model over a step's traced schedule
(``op_trace.trace_step``), the port's counterpart of the reference's
``hbm_model.py`` (which scans XLA's scheduled per-device HLO).

A linear scan, as the reference's: each storage the step allocates is
live from the op that defines it to its last use, and the peak is the
running sum's maximum. What the reference approximates, the trace has
exactly:

- views and aliases define nothing (0 bytes: the reference's
  ``_ALIAS_OPS``), and an in-place op defines nothing new; values are
  keyed by storage, so a view and a DTensor's local tensor are their
  base;
- arguments are left out: the caller adds them (the reference's
  ``dryrun``: ``args + liveness``);
- the port unrolls every layer loop and scans none, so there is no
  callee computation whose peak adds at its call site;
- a value no later op reads is freed after its op (``trace_step``'s
  ``free`` marker), and the step's results stay live to its end (its
  ``outputs`` marker), as the reference's ROOT keeps them.

What it does not see: the caching allocator's rounding and
fragmentation, and the workspaces a library kernel takes on the card.
"""
from __future__ import annotations


def _scan(trace):
    """(peak, the storages live at the peak) of ``trace.ops``, and each
    storage's (bytes, shape text, defining op)."""
    info, last_use = {}, {}
    for i, op in enumerate(trace.ops):
        for k in op.uses:
            if k in info:
                last_use[k] = i
        for k, b, shape in op.defs:
            info[k] = (b, shape, f"{op.name}#{i}")
    expire: dict[int, list] = {}
    for k, i in last_use.items():
        expire.setdefault(i, []).append(k)
    live = peak = 0
    live_set: set = set()
    peak_set: set = set()
    for i, op in enumerate(trace.ops):
        for k, b, _ in op.defs:
            live += b
            live_set.add(k)
        if live > peak:
            peak, peak_set = live, set(live_set)
        for k in expire.get(i, ()):
            if k in live_set:
                live -= info[k][0]
                live_set.discard(k)
    return peak, peak_set, info


def peak_hbm_bytes(trace) -> int:
    """The modelled per-device peak of the step's temporaries (add the
    argument bytes for the whole footprint)."""
    return _scan(trace)[0]


def peak_report(trace, top: int = 14) -> list[tuple]:
    """(bytes, name, shape) of the largest values live at the peak; the
    name is the defining op and its index in the schedule."""
    _, peak_set, info = _scan(trace)
    rows = sorted(((info[k][0], info[k][2], info[k][1]) for k in peak_set
                   if info[k][0] > 0), reverse=True)
    return rows[:top]
