"""One LSM level of SSTables with per-table two-stage chained filters.

Frozen copy of ``repro_torch/core/lsm.py``'s ``ChainedTableFilter`` and
``LsmLevelChained.flush`` (stage 1 an Xor filter over the table's keys,
stage 2 a dynamic Othello over its keys and the stage-1 false positives
among the older tables' keys; a flush excludes the new keys from every
older table's stage 2), with the seed schedule the store shares.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bloomier import XorFilter
from .othello import DynamicExactFilter


def in_sorted(sorted_keys: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Membership of ``qs`` in a sorted key array -> bool [n]."""
    if len(sorted_keys) == 0:
        return np.zeros(len(qs), dtype=bool)
    idx = np.minimum(np.searchsorted(sorted_keys, qs), len(sorted_keys) - 1)
    return sorted_keys[idx] == qs


@dataclass
class ChainedTableFilter:
    f1: XorFilter
    f2: DynamicExactFilter

    @classmethod
    def build(cls, keys: np.ndarray, other_keys: np.ndarray,
              fp_alpha: int = 7, seed1: int = 0, seed2: int = 0
              ) -> "ChainedTableFilter":
        keys = np.asarray(keys, dtype=np.uint64)
        other = np.asarray(other_keys, dtype=np.uint64)
        f1 = XorFilter.build(keys, fp_alpha, seed=seed1)
        other = other[~in_sorted(np.sort(keys), other)]
        fp = other[f1.query(other)] if len(other) else other
        f2 = DynamicExactFilter.build(keys, fp, seed=seed2)
        return cls(f1=f1, f2=f2)

    def exclude_new(self, own_keys: np.ndarray, new_keys: np.ndarray) -> None:
        new_keys = np.asarray(new_keys, dtype=np.uint64)
        fp_keys = new_keys[self.f1.query(new_keys)]
        fp_keys = fp_keys[~in_sorted(np.asarray(own_keys, dtype=np.uint64),
                                     fp_keys)]
        if len(fp_keys):
            self.f2.exclude(fp_keys)

    def query(self, keys: np.ndarray) -> np.ndarray:
        return self.f1.query(keys) & self.f2.query(keys)


class ChainedLevel:
    """Newest-first SSTable key runs and their chained filters, built by
    one flush per run."""

    def __init__(self, fp_alpha: int = 7, seed: int = 0):
        self.tables: list[np.ndarray] = []          # sorted keys, newest first
        self.filters: list[ChainedTableFilter] = []
        self.fp_alpha = fp_alpha
        self.seed = seed

    def flush(self, keys: np.ndarray) -> None:
        keys = np.sort(np.asarray(keys, dtype=np.uint64))
        k = len(self.tables)
        for own, f in zip(self.tables, self.filters):
            f.exclude_new(own, keys)
        older = (np.concatenate(self.tables) if self.tables
                 else np.empty(0, np.uint64))
        f = ChainedTableFilter.build(keys, older, fp_alpha=self.fp_alpha,
                                     seed1=self.seed + 31 * k,
                                     seed2=self.seed + 7 * k)
        self.tables.insert(0, keys)
        self.filters.insert(0, f)
