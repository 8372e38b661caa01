"""Background compaction service: the always-on half of the LSM store.

The paper's §5.4 tail-latency claim is about a store under SUSTAINED
traffic — compactions running mid-stream, not between benchmark phases.
``BackgroundCompactor`` is the thread that makes that true here: it drives
``LsmStore._background_step`` (one size-tiered merge run or deferred-GC
sweep per mutator-lock acquisition, so flushes interleave between runs)
and parks on an event the hot paths ``kick()``:

- a flush publishes a new table (compaction debt moved);
- an admission-stalled writer needs headroom at ``table_cap``;
- the last snapshot closes with deferred tombstone GC owed.

A ``poll_s`` heartbeat backstops missed kicks. Every step's work funnels
through the store's ordinary ``_publish`` swap point, so readers observe
background compaction exactly as they observe foreground compaction: as a
sequence of immutable generations. Step failures (publish-hook errors
included) are recorded on ``errors`` and never kill the loop — a broken
secondary-index hook must not stop compaction and wedge every writer at
the cap.

Thread-safety contract: the loop takes the store's mutator lock ``_wl``
for each step and the small lock ``_mu`` only transiently inside it
(lock order ``_wl`` → ``_mu``, same as every foreground mutator); it
never blocks on the admission condition, so a stalled writer can always
be unblocked by the compactor it is waiting for.
"""
from __future__ import annotations

import threading
import time


class BackgroundCompactor:
    """Daemon thread draining an ``LsmStore``'s compaction/GC debt.

    Lifecycle: ``store.start_background()`` constructs + starts one;
    ``stop()`` (or ``store.stop_background()``) shuts it down. ``kick()``
    wakes it immediately; ``wait_idle()`` blocks until no runnable work
    remains — the quiesce point tests and benchmarks use before asserting
    on table counts."""

    def __init__(self, store, poll_s: float = 0.02):
        self.store = store
        self.poll_s = float(poll_s)
        self.steps = 0                      # completed units of work
        self.errors: list[Exception] = []   # isolated per-step failures
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread: threading.Thread | None = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="lsm-bg-compactor", daemon=True)
        self._thread.start()

    def kick(self) -> None:
        """Wake the loop now (idempotent; safe from any thread, including
        under the store's locks — this only sets an event)."""
        self._idle.clear()
        self._wake.set()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until the store has no runnable background work and no
        pending kick (False on timeout). Only meaningful once the traffic
        that creates debt has quiesced — under live writes the store may
        never go idle, by design."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._idle.is_set() and not self._wake.is_set():
                return True
            time.sleep(0.002)
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                progressed = True
                while progressed and not self._stop.is_set():
                    self._idle.clear()
                    progressed = self.store._background_step()
                    if progressed:
                        self.steps += 1
            except Exception as exc:        # isolate: the loop must survive
                self.errors.append(exc)
            finally:
                self._idle.set()
