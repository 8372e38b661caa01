"""Bloom filter: host numpy build and query.

Frozen copy of ``repro_torch/core/bloom.py`` (build, insert, query), with
``probes`` added: the bit tests a reader that stops at the first zero bit
makes, which is what the roofline counts of a Bloom probe need.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import hashing as H

LN2 = math.log(2.0)


def optimal_params(n: int, fpr: float) -> tuple[int, int]:
    """(m_bits, k) for n keys at a target false-positive rate."""
    if not (0.0 < fpr < 1.0):
        raise ValueError(f"fpr must be in (0,1), got {fpr}")
    m = max(64, int(math.ceil(-n * math.log(fpr) / (LN2 * LN2))))
    k = max(1, int(round(m / n * LN2)))
    return m, k


@dataclass
class BloomFilter:
    m_bits: int
    k: int
    seed: int = 0
    words: np.ndarray = field(default=None, repr=False)  # uint32 [ceil(m/32)]

    def __post_init__(self):
        if self.words is None:
            self.words = np.zeros((self.m_bits + 31) // 32, dtype=np.uint32)

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
            np.bitwise_or.at(self.words, idx >> 5,
                             np.uint32(1) << (idx & 31).astype(np.uint32))

    def bit_matrix(self, keys: np.ndarray) -> np.ndarray:
        """bool [n, k]: hash i's bit is set for key n."""
        hi, lo = H.np_split_u64(keys)
        out = np.empty((len(keys), self.k), dtype=bool)
        for i in range(self.k):
            idx = H.np_hash_to_range(hi, lo, self.seed * 1000 + i, self.m_bits)
            out[:, i] = (self.words[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1 == 1
        return out

    def query(self, keys: np.ndarray) -> np.ndarray:
        return self.bit_matrix(keys).all(axis=1)

    def probes(self, keys: np.ndarray) -> np.ndarray:
        """int [n]: bit tests up to and including the first zero bit."""
        bits = self.bit_matrix(keys)
        return np.where(bits.all(axis=1), self.k, np.argmin(bits, axis=1) + 1)
