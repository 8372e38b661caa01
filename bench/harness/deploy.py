"""Deployments: the data each configuration's kind draws from the seed, the
program under test built from it, and the reference beside it.

A configuration file (``bench/configs/<name>.json``) names its ``kind``:

- ``lsm_store``: ``repro_torch.storage.LsmStore`` filled by one
  ``put_batch`` and one ``flush`` per table of ``records / tables`` keys,
  read by ``get_batch``;
- ``filter_bank``: ``repro_torch.serving.FilterService`` over the filters
  of ``filters``, each built by the program in a process of its own, read
  by ``probe``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing

import numpy as np

from bench.traffic.generate import key_universe, phase_rngs, phase_seed


def spawn():
    return multiprocessing.get_context("spawn")


# -- data ------------------------------------------------------------------
def make_data(cfg: dict, seed: int) -> dict:
    if cfg["kind"] == "lsm_store":
        n = int(cfg["records"])
        keys = key_universe(n, phase_seed(seed, "keys"))
        (rng,) = phase_rngs(seed, "values")
        values = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
        return {"stored": keys, "values": values}
    if cfg["kind"] == "filter_bank":
        n_pos, lam = int(cfg["positives"]), int(cfg["lambda"])
        universe = key_universe(n_pos * (lam + 1) + int(cfg["fresh"]),
                                phase_seed(seed, "keys"))
        return {"universe": universe, "pos": universe[:n_pos],
                "neg": universe[n_pos:n_pos * (lam + 1)]}
    raise ValueError(f"unknown configuration kind {cfg['kind']!r}")


# -- the reference, in processes of its own --------------------------------
class Reference:
    """The reference's worker processes (``bench.reference.worker``): one
    for a store, whose flushes build on each other, and one a filter for a
    bank, so that the bank's builds run side by side."""

    def __init__(self, cfg: dict, data: dict):
        from bench.reference import worker
        ctx = spawn()
        if cfg["kind"] == "lsm_store":
            parts = [(data["stored"], data["values"])]
        else:
            parts = [(spec, data["pos"], data["neg"])
                     for spec in cfg["filters"]]
        self.workers = []
        for args in parts:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=worker.serve,
                               args=(child, cfg["kind"], cfg, args),
                               daemon=True)
            proc.start()
            child.close()
            self.workers.append((proc, parent))
        self.sizes: dict = {}
        self.build_s = 0.0

    def wait_ready(self) -> None:
        for _, conn in self.workers:
            msg = conn.recv()
            if msg[0] != "ready":
                raise RuntimeError(f"the reference failed:\n{msg[1]}")
            self.build_s = max(self.build_s, msg[1])
            self.sizes.update(msg[2])

    def answer(self, keys: np.ndarray, control: bool = False) -> dict:
        for _, conn in self.workers:
            conn.send(("answer", keys, control))
        out: dict = {}
        for _, conn in self.workers:
            msg = conn.recv()
            if msg[0] != "ok":
                raise RuntimeError(f"the reference failed:\n{msg[1]}")
            out.update(msg[1])
        return out

    def close(self) -> None:
        for proc, conn in self.workers:
            try:
                conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for proc, conn in self.workers:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
            conn.close()


# -- the program under test -------------------------------------------------
def _program_filter(spec: dict, pos: np.ndarray, neg: np.ndarray):
    """One bank filter built by the program's own builder."""
    from repro_torch.core.bloom import BloomFilter
    from repro_torch.core.bloomier import ExactBloomier, XorFilter
    from repro_torch.core.chained import ChainedFilterAnd, ChainedFilterCascade
    kind, seed = spec["type"], int(spec["seed"])
    if kind == "bloom":
        return BloomFilter.build(pos, float(spec["fpr"]), seed=seed)
    if kind == "xor":
        return XorFilter.build(pos, int(spec["alpha"]), seed=seed)
    if kind == "exact":
        return ExactBloomier.build(pos[:int(spec["positives"])],
                                   neg[:int(spec["negatives"])], seed=seed)
    if kind == "chained_and":
        return ChainedFilterAnd.build(pos, neg, seed=seed)
    if kind == "cascade":
        return ChainedFilterCascade.build(pos, neg, seed=seed)
    raise ValueError(f"unknown filter type {kind!r}")


@dataclasses.dataclass
class Program:
    kind: str
    handle: object                  # the LsmStore or the FilterService
    call: object                    # keys -> the program's answers
    counters: object                # () -> dict of the program's counters


def build_program(cfg: dict, data: dict, device: str) -> Program:
    if cfg["kind"] == "lsm_store":
        from repro_torch.storage.lsm_store import LsmStore
        store = LsmStore(filter_kind=cfg["filter_kind"],
                         fp_alpha=int(cfg["fp_alpha"]),
                         auto_compact=bool(cfg["auto_compact"]),
                         memtable_capacity=int(cfg["memtable_capacity"]),
                         device=device)
        per = int(cfg["records"]) // int(cfg["tables"])
        keys, values = data["stored"], data["values"]
        for i in range(int(cfg["tables"])):
            store.put_batch(keys[i * per:(i + 1) * per],
                            values[i * per:(i + 1) * per])
            store.flush()
        return Program("lsm_store", store, store.get_batch,
                       lambda: dataclasses.asdict(store.stats))
    from repro_torch.serving.filter_service import FilterService
    specs = cfg["filters"]
    with concurrent.futures.ProcessPoolExecutor(
            len(specs), mp_context=spawn()) as pool:
        futures = [pool.submit(_program_filter, s, data["pos"], data["neg"])
                   for s in specs]
        filters = [f.result() for f in futures]
    svc = FilterService(filters, device=device)
    del filters
    return Program("filter_bank", svc, svc.probe,
                   lambda: {"lookups": svc.stats.lookups,
                            "hits": svc.stats.hits.tolist(),
                            "probes": svc.stats.probes.tolist()})
