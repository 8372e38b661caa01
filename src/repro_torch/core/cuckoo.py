"""Cuckoo hashing (Pagh & Rodler 2004) and Cuckoo filter (Fan et al. 2014).

Used by the paper in §5.3 (self-adaptive hash-location prediction) and as a
dynamic elementary filter option (§4.3.1). Construction/insertion are
host-side (inherently sequential eviction chains); queries are vectorized.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import hashing as H

EMPTY = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


class CuckooFull(RuntimeError):
    pass


@dataclass
class CuckooHashTable:
    """Two-table cuckoo hash over uint64 keys (values = table residency).

    ``which_table(keys)`` is the membership-style question the paper's
    predictor answers: items resident in T1 are 'negative', items in T2
    'positive' (Theorem 5.2 fixes the induced λ from the load factor r).
    """

    M: int                      # buckets per table
    seed: int = 0
    t1: np.ndarray = field(default=None, repr=False)
    t2: np.ndarray = field(default=None, repr=False)
    n_items: int = 0
    max_kicks: int = 500

    def __post_init__(self):
        if self.t1 is None:
            self.t1 = np.full(self.M, EMPTY, dtype=np.uint64)
            self.t2 = np.full(self.M, EMPTY, dtype=np.uint64)

    def _h(self, keys: np.ndarray, which: int) -> np.ndarray:
        hi, lo = H.np_split_u64(np.atleast_1d(np.asarray(keys, dtype=np.uint64)))
        return H.np_hash_to_range(hi, lo, self.seed * 2 + which, self.M)

    def insert(self, key: np.uint64) -> None:
        key = np.uint64(key)
        cur, table = key, 0
        for _ in range(self.max_kicks):
            h = int(self._h(cur, table)[0])
            t = self.t1 if table == 0 else self.t2
            if t[h] == EMPTY:
                t[h] = cur
                self.n_items += 1
                return
            cur, t[h] = t[h], cur
            table ^= 1
        raise CuckooFull("eviction chain exceeded max_kicks; rebuild needed")

    def insert_many(self, keys: np.ndarray) -> None:
        for k in np.asarray(keys, dtype=np.uint64):
            self.insert(k)

    def which_table(self, keys: np.ndarray) -> np.ndarray:
        """0 if resident in T1, 1 if in T2, -1 if absent."""
        keys = np.asarray(keys, dtype=np.uint64)
        h1 = self._h(keys, 0)
        h2 = self._h(keys, 1)
        in1 = self.t1[h1] == keys
        in2 = self.t2[h2] == keys
        return np.where(in1, 0, np.where(in2, 1, -1))

    def lookup_accesses(self, keys: np.ndarray,
                        predicted: np.ndarray | None = None) -> np.ndarray:
        """External memory accesses per query. Without a predictor we probe
        T1 then T2 (avg 1+P[in T2]); with a (possibly wrong) prediction we
        probe the predicted table first."""
        w = self.which_table(keys)
        if predicted is None:
            return np.where(w == 0, 1, 2)  # absent keys also cost 2
        pred = np.asarray(predicted).astype(np.int64)
        correct = (w >= 0) & (pred == w)
        return np.where(correct, 1, 2)

    @property
    def load_factor(self) -> float:
        return self.n_items / (2 * self.M)


@dataclass
class CuckooFilter:
    """Approximate dynamic filter: 1.05·(2+log2 1/eps) bits/item (paper §6.1).

    4-slot buckets, partial-key cuckoo: alternate bucket = i ⊕ hash(fp).
    """

    n_buckets: int
    fp_bits: int
    seed: int = 0
    slots: np.ndarray = field(default=None, repr=False)  # uint32 [n_buckets,4]
    n_items: int = 0
    max_kicks: int = 500

    def __post_init__(self):
        if self.slots is None:
            self.slots = np.zeros((self.n_buckets, 4), dtype=np.uint32)

    @classmethod
    def build(cls, keys: np.ndarray, fpr: float, seed: int = 0) -> "CuckooFilter":
        fp_bits = max(2, int(math.ceil(math.log2(2.0 / fpr))))
        n_b = 1 << max(3, int(math.ceil(math.log2(len(keys) / 4.0 / 0.95))))
        f = cls(n_buckets=n_b, fp_bits=fp_bits, seed=seed)
        for k in np.asarray(keys, dtype=np.uint64):
            f.insert(k)
        return f

    def _fp_and_i1(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        hi, lo = H.np_split_u64(np.atleast_1d(np.asarray(keys, dtype=np.uint64)))
        fp = (H.np_hash_u32(hi, lo, self.seed + 11) % np.uint32((1 << self.fp_bits) - 1)) + 1
        i1 = H.np_hash_to_range(hi, lo, self.seed + 13, self.n_buckets)
        return fp.astype(np.uint32), i1

    def _alt(self, i: np.ndarray, fp: np.ndarray) -> np.ndarray:
        fh = H.np_fmix32(fp) & np.uint32(self.n_buckets - 1)
        return (i ^ fh).astype(np.int64)

    def insert(self, key: np.uint64) -> None:
        fp, i1 = self._fp_and_i1(key)
        fp, i = np.uint32(fp[0]), int(i1[0])
        for _ in range(self.max_kicks):
            row = self.slots[i]
            free = np.nonzero(row == 0)[0]
            if free.size:
                self.slots[i, free[0]] = fp
                self.n_items += 1
                return
            j = np.random.randint(4)
            fp, self.slots[i, j] = self.slots[i, j], fp
            i = int(self._alt(np.array([i]), np.array([fp], dtype=np.uint32))[0])
        raise CuckooFull("cuckoo filter full")

    def query(self, keys: np.ndarray) -> np.ndarray:
        fp, i1 = self._fp_and_i1(keys)
        i2 = self._alt(i1, fp)
        in1 = (self.slots[i1] == fp[:, None]).any(axis=1)
        in2 = (self.slots[i2] == fp[:, None]).any(axis=1)
        return in1 | in2

    @property
    def bits(self) -> int:
        return self.n_buckets * 4 * self.fp_bits
