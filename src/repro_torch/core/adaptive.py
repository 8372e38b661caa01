"""Self-adaptive hashing (paper §5.3): ChainedFilter as a trainable
hash-location predictor for Cuckoo hashing.

Items resident in T2 are positives, items in T1 negatives (λ fixed by the
load factor per Theorem 5.2). The "&~" cascade predicts residency with best
effort; false predictions *train* the predictor by flipping mapped bits
until it answers correctly — error decays exponentially per round and
converges to zero (Remark of Thm 4.3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import theory
from .chained import ChainedFilterCascade
from .cuckoo import CuckooHashTable


@dataclass
class AdaptiveCuckoo:
    table: CuckooHashTable
    predictor: ChainedFilterCascade

    @classmethod
    def build(cls, keys: np.ndarray, M: int, seed: int = 0,
              delta: float = 0.5, n_layers: int = 12) -> "AdaptiveCuckoo":
        t = CuckooHashTable(M=M, seed=seed)
        t.insert_many(keys)
        r = t.load_factor
        lam = theory.cuckoo_lambda(r)
        # positives = T2 residents; expected count = n_items / (λ+1)
        n_pos = max(1, int(round(t.n_items / (lam + 1.0))))
        pred = ChainedFilterCascade.empty(n_pos, lam, delta=delta,
                                          n_layers=n_layers, seed=seed + 1)
        return cls(table=t, predictor=pred)

    def train_rounds(self, keys: np.ndarray, max_rounds: int = 64) -> list[float]:
        """Query all items in rounds; each round fixes every misprediction
        (the paper's Figure 10a experiment). Returns error rate per round."""
        w = self.table.which_table(keys)
        labels = w == 1  # member-of-T2 = positive
        return self.predictor.train(keys, labels, max_rounds=max_rounds)

    def predicted_table(self, keys: np.ndarray) -> np.ndarray:
        return self.predictor.query(keys).astype(np.int64)  # 1 ⇒ T2

    def external_accesses(self, keys: np.ndarray) -> np.ndarray:
        return self.table.lookup_accesses(keys, self.predicted_table(keys))

    @property
    def filter_bits(self) -> int:
        return self.predictor.bits


def emoma_bits(M: int) -> int:
    """EMOMA baseline space: 8M bits (two 4-bit counters per block, §5.3)."""
    return 8 * M


def expected_access_reduction(r: float) -> float:
    """Fraction of external accesses removed by a perfect predictor vs
    always-probe-T1-first: (λ+1)^-1 (31% at r=0.4)."""
    lam = theory.cuckoo_lambda(r)
    return 1.0 / (lam + 1.0)
