"""Fault-tolerant training supervisor: checkpoint / crash / restart loop.

``Supervisor.run`` drives a step function under a failure injector. On any
injected (or real) exception it restarts from the last committed checkpoint
— including re-building data state (the pipeline is deterministic in the
step index, so no batch is ever skipped or repeated). This is the
single-process stand-in for the cluster controller; the restart semantics
(resume step, elastic re-shard on a new mesh) are exactly what a multi-host
deployment needs.

The reference's loop over the port's ``CheckpointStore``. A restore loads
into a fresh ``init_state()`` in place, on that template's devices, after
the failed state is dropped: one state is alive at a time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.checkpoint.store import CheckpointStore
from .straggler import StragglerMonitor


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule: fail when the global step first
    reaches each entry (models a node loss at that step)."""
    fail_at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class TrainResult:
    final_step: int
    n_restarts: int
    losses: list
    straggler_reports: list


class Supervisor:
    def __init__(self, ckpt_dir: str, save_every: int = 10,
                 max_restarts: int = 10):
        self.store = CheckpointStore(ckpt_dir)
        self.save_every = save_every
        self.max_restarts = max_restarts

    def run(self, *, init_state: Callable, step_fn: Callable, n_steps: int,
            injector: FailureInjector | None = None,
            monitor: StragglerMonitor | None = None,
            host_times: Callable | None = None) -> TrainResult:
        """init_state() -> state pytree (fresh); step_fn(state, step) ->
        (state, loss). State must contain everything needed to resume."""
        restarts = 0
        losses = []
        reports = []
        while True:
            start = self.store.latest_step()
            state = None                 # drop a failed run's state first
            if start is None:
                state = init_state()
                start = 0
            else:
                state = self.store.load(start, init_state())
            step = start
            try:
                while step < n_steps:
                    if injector is not None:
                        injector.maybe_fail(step)
                    t0 = time.perf_counter()
                    state, loss = step_fn(state, step)
                    dt = time.perf_counter() - t0
                    losses.append(float(loss))
                    if monitor is not None:
                        times = (host_times(step, dt) if host_times
                                 else {0: dt})
                        flagged = monitor.record(step, times)
                        if flagged:
                            reports.append((step, flagged))
                    step += 1
                    if step % self.save_every == 0 or step == n_steps:
                        self.store.save(step, state)
                return TrainResult(final_step=step, n_restarts=restarts,
                                   losses=losses,
                                   straggler_reports=reports)
            except InjectedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                continue   # reload from last checkpoint and resume
