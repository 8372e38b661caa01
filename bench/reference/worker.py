"""A process that holds the reference: it builds it from the inputs the
benchmark made, once the program's window has closed, then answers key
batches.

Protocol over a ``multiprocessing`` pipe: the worker sends
``("ready", build_seconds, sizes)`` once built (or ``("error", text)``), then
answers each ``("answer", keys, control)`` with a dict and ends on
``("stop",)``.
"""
from __future__ import annotations

import time
import traceback


def _bank_filter(cfg: dict, spec: dict, pos, neg):
    from . import bank
    f = bank.build_filter(spec, pos, neg)

    def answer(keys, control):
        return {spec["type"]: bank.answer(spec, f, keys, control)}

    def sizes():
        return {spec["type"]: bank.sizes(spec, f)}
    return answer, sizes


def _store(cfg: dict, keys, values):
    from .store import StoreReference
    ref = StoreReference(cfg, keys, values)
    return ref.answer, ref.sizes


def serve(conn, kind: str, cfg: dict, args: tuple) -> None:
    try:
        t0 = time.monotonic()
        if kind == "lsm_store":
            answer, sizes = _store(cfg, *args)
        elif kind == "filter_bank":
            answer, sizes = _bank_filter(cfg, *args)
        else:
            raise ValueError(f"no reference for {kind!r}")
        conn.send(("ready", time.monotonic() - t0, sizes()))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        return
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            break
        try:
            conn.send(("ok", answer(msg[1], msg[2])))
        except Exception:
            conn.send(("error", traceback.format_exc()))
    conn.close()
