"""Bloom filter (Bloom 1970) — elementary approximate filter.

Construction and ``query`` are host-side numpy (scatter-OR / gather); the
device probe is the ``bloom_probe`` CUDA kernel over the packed uint32
bitmap words (``kernels.bloom_probe``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import hashing as H

LN2 = math.log(2.0)


def optimal_params(n: int, fpr: float) -> tuple[int, int]:
    """(m_bits, k) for n keys at target false-positive rate."""
    if not (0.0 < fpr < 1.0):
        raise ValueError(f"fpr must be in (0,1), got {fpr}")
    m = max(64, int(math.ceil(-n * math.log(fpr) / (LN2 * LN2))))
    k = max(1, int(round(m / n * LN2)))
    return m, k


@dataclass
class BloomFilter:
    """Static-or-dynamic Bloom filter over uint64 keys."""

    m_bits: int
    k: int
    seed: int = 0
    words: np.ndarray = field(default=None, repr=False)  # uint32 [ceil(m/32)]

    def __post_init__(self):
        if self.words is None:
            self.words = np.zeros((self.m_bits + 31) // 32, dtype=np.uint32)

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, keys: np.ndarray, fpr: float, seed: int = 0) -> "BloomFilter":
        n = max(1, len(keys))
        m, k = optimal_params(n, fpr)
        f = cls(m_bits=m, k=k, seed=seed)
        f.insert(keys)
        return f

    def insert(self, keys: np.ndarray) -> None:
        if len(keys) == 0:
            return
        hi, lo = H.np_split_u64(keys)
        for i in range(self.k):
            idx = H.np_hash_to_range(hi, lo, self.seed * 1000 + i, self.m_bits)
            np.bitwise_or.at(self.words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))

    def set_bits_for(self, keys: np.ndarray) -> None:
        """Adaptive-training hook (paper §5.3): force-membership of keys."""
        self.insert(keys)

    # -- query --------------------------------------------------------------
    def query(self, keys: np.ndarray) -> np.ndarray:
        """Host query -> bool [n]."""
        hi, lo = H.np_split_u64(keys)
        out = np.ones(len(keys), dtype=bool)
        for i in range(self.k):
            idx = H.np_hash_to_range(hi, lo, self.seed * 1000 + i, self.m_bits)
            out &= (self.words[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1 == 1
        return out

    # -- packed-table interchange (FilterBank, §5.2) -------------------------
    def to_tables(self):
        """(uint32 tables, BloomTable layout) — see core.tables."""
        from .tables import BloomTable, pad_words
        tables = pad_words(self.words)
        return tables, BloomTable(offset=0, width=len(tables),
                                  m_bits=self.m_bits, k=self.k, seed=self.seed)

    @classmethod
    def from_tables(cls, tables: np.ndarray, layout) -> "BloomFilter":
        n_words = (layout.m_bits + 31) // 32
        words = np.array(tables[layout.offset:layout.offset + n_words],
                         dtype=np.uint32)
        return cls(m_bits=layout.m_bits, k=layout.k, seed=layout.seed,
                   words=words)

    # -- accounting ----------------------------------------------------------
    @property
    def bits(self) -> int:
        return self.m_bits

    def fill_ratio(self) -> float:
        return float(np.unpackbits(self.words.view(np.uint8)).sum()) / (len(self.words) * 32)
