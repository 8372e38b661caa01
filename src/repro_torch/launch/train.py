"""End-to-end trainer: data pipeline (+ filter dedup) → train step →
AdamW → checkpoints → fault-tolerant supervisor with failure injection
and straggler monitoring, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 30 [--device cpu] [--ckpt-dir DIR] [--fail-at 7 13]

``main`` runs f32 compute on the CPU, as the reference's ``main`` does,
and bf16 compute over f32 master weights on the card. ``build_trainer``
builds the same trainer at full width (``smoke=False``).

A restart replays the data pipeline to the step it resumes from
(``ResumableData``), so a resumed run gives an uninterrupted run's
batches and losses. The reference's trainer keeps its pipeline across a
restart, so its dedup filter drops the replayed steps' documents as
duplicates and the resumed batches differ.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import (SMOKE_SHAPES, SHAPES,
                                      draw_modality_inputs)
from repro_torch.data.pipeline import SyntheticLMData, DataConfig
from repro_torch.ft.supervisor import Supervisor, FailureInjector
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.kernels.common import as_device
from repro_torch.launch.steps import build_cell
from repro_torch.models import common as MC
from repro_torch.models.common import init_from_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.sharding.rules import distribute_tree


class ResumableData:
    """``SyntheticLMData`` as an uninterrupted run holds it before each
    step. Its batches are deterministic in the step index, but its dedup
    filter remembers every document served; so a step below the next one
    (a restart) rebuilds the pipeline, and any step replays the batches
    before it that this pipeline has not served. ``extra(rng)`` adds the
    arch's modality inputs to each batch, drawn as the reference draws
    them (one stream from seed 7, one draw a step) and replayed the same
    way."""

    def __init__(self, cfg: DataConfig, extra=None):
        self.cfg, self.extra = cfg, extra
        self._fresh()

    def _fresh(self):
        self.data = SyntheticLMData(self.cfg)
        self.rng = np.random.default_rng(7)
        self.next_step = 0

    def _draw(self) -> dict:
        return self.extra(self.rng) if self.extra else {}

    def batch(self, step: int) -> dict:
        if step < self.next_step:
            self._fresh()
        for s in range(self.next_step, step):
            self.data.batch(s)
            self._draw()
        self.next_step = step + 1
        return {**self.data.batch(step), **self._draw()}

    @property
    def n_dropped(self) -> int:
        return self.data.n_dropped


def build_trainer(arch_id: str, smoke: bool = True, device="cuda",
                  seq_len: int | None = None, batch: int | None = None,
                  lr: float = 3e-4, mesh=None):
    """(init_state, step_fn, model): ``init_state()`` is a fresh state
    (params from a seeded generator of ``device``, zero AdamW moments);
    ``step_fn(state, step)`` -> (state, loss) trains on the pipeline's
    batch for ``step`` (``step_fn.data``, a ``ResumableData``).

    With ``mesh`` (a ``DeviceMesh`` on ``device``'s type), the state is
    placed on it by the sharding rules and the step runs sharded: every
    rank draws the same global batch from its own pipeline, and the step
    places it (each rank keeps its rows), so the batch split is the
    placement; the loss is read from the replicated scalar."""
    device = as_device(device)
    arch = get_arch(arch_id)
    cell = build_cell(arch, "train_4k", device=device, smoke=smoke,
                      opt_cfg=AdamWConfig(lr=lr), mesh=mesh)
    m = cell.model
    shape = (SMOKE_SHAPES if smoke else SHAPES)["train_4k"]
    seq = seq_len or shape.seq
    bsz = batch or shape.batch
    lm = getattr(m.cfg, "lm", m.cfg)
    data = ResumableData(
        DataConfig(vocab=min(lm.vocab, 32768), seq_len=seq, global_batch=bsz,
                   seed=0),
        extra=lambda rng: draw_modality_inputs(arch, m.cfg, bsz, smoke, rng,
                                               "cpu"))

    def init_state():
        params = init_from_specs(m.param_specs(),
                                 torch.Generator(device).manual_seed(0),
                                 device)
        opt = adamw_init(params)
        if mesh is not None:
            params, opt = (distribute_tree(t, mesh, sp) for t, sp in
                           zip((params, opt), cell.arg_specs))
        return {"params": params, "opt": opt,
                "step_count": np.zeros((), np.int64)}

    def step_fn(state, step):
        b = data.batch(step)
        batch_dev = {k: torch.as_tensor(v).to(cell.device)
                     for k, v in b.items()}
        params, opt, metrics = cell.step(state["params"], state["opt"],
                                         batch_dev)
        return ({"params": params, "opt": opt,
                 "step_count": state["step_count"] + 1},
                float(metrics["loss"]))

    step_fn.data = data
    return init_state, step_fn, m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the reference's flag; the CLI always trains the "
                         "smoke config (build_trainer takes smoke=False)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, bf16 compute) or 'cpu' (f32)")
    args = ap.parse_args(argv)
    device = as_device(args.device)

    was = MC.COMPUTE_DTYPE
    MC.set_compute_dtype(torch.float32 if device.type == "cpu"
                         else torch.bfloat16)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            init_state, step_fn, model = build_trainer(
                args.arch, smoke=args.smoke, device=device,
                seq_len=args.seq_len, batch=args.batch, lr=args.lr)
            sup = Supervisor(args.ckpt_dir or tmp, save_every=args.save_every)
            mon = StragglerMonitor(n_hosts=1)
            inj = FailureInjector(tuple(args.fail_at))
            t0 = time.perf_counter()
            res = sup.run(init_state=init_state, step_fn=step_fn,
                          n_steps=args.steps, injector=inj, monitor=mon)
            dt = time.perf_counter() - t0
    finally:
        MC.set_compute_dtype(was)
    print(f"[train] arch={args.arch} steps={res.final_step} "
          f"restarts={res.n_restarts} loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f} wall={dt:.1f}s")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError("loss did not improve")
    return res


if __name__ == "__main__":
    main()
