"""Deterministic synthetic LM data pipeline (numpy, the reference's
``repro/data/pipeline.py``).

Documents are generated from a seeded Markov-ish integer process, packed to
fixed-length sequences, and (optionally) deduplicated with the paper's
filter stack (data/dedup.py). Deterministic per (seed, step, host_shard) so
a restarted job resumes mid-epoch bit-for-bit — the fault-tolerance story
depends on it. The dedup state is the one thing a step does not rebuild:
``launch/train.py`` replays the batches before a resumed step.

A document's dedup key is Python's ``hash`` of its first 32 tokens' bytes,
as in the reference. That hash is salted per process (``PYTHONHASHSEED``),
so the dedup decisions, and with them the batches, match the reference's
within one process only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dedup: bool = True
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLMData:
    """next-token LM batches: tokens[t+1] predicts labels[t]."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        from .dedup import StreamingDedup
        self.dedup = StreamingDedup(capacity=1 << 16, seed=cfg.seed) \
            if cfg.dedup else None
        self.n_dropped = 0

    def _doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.cfg.vocab
        start = rng.integers(0, v)
        steps = rng.integers(1, 7, size=length)
        return (start + np.cumsum(steps)) % v

    def batch(self, step: int) -> dict:
        """Batch for a global step; this host materializes only its shard."""
        c = self.cfg
        per_host = c.global_batch // c.n_hosts
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 64 + c.host_id)
        toks = np.zeros((per_host, c.seq_len + 1), np.int64)
        for i in range(per_host):
            filled = 0
            while filled < c.seq_len + 1:
                L = int(rng.integers(64, 512))
                doc = self._doc(rng, L)
                if self.dedup is not None:
                    h = np.uint64(hash(doc[: min(32, L)].tobytes()) & (2**64 - 1))
                    if self.dedup.seen_before(np.array([h], np.uint64))[0]:
                        self.n_dropped += 1
                        continue
                take = min(L, c.seq_len + 1 - filled)
                toks[i, filled:filled + take] = doc[:take]
                filled += take
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
