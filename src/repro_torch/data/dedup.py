"""Streaming document dedup — the paper's "filter in front of expensive
storage" pattern applied to the training data pipeline.

A dynamic Bloom pre-filter absorbs the ~always-new case with one cheap
in-cache probe; only Bloom-positive hashes touch the exact verification
table (a python set standing in for the remote dedup DB). This is the
ChainedFilter staging idea (§4): stage-1 approximate, stage-2 exact over
the survivors, zero false drops overall.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bloom import BloomFilter, optimal_params


class StreamingDedup:
    def __init__(self, capacity: int, fpr: float = 0.01, seed: int = 0):
        m, k = optimal_params(capacity, fpr)
        self.bloom = BloomFilter(m_bits=m, k=k, seed=seed)
        self.exact: set = set()
        self.bloom_probes = 0
        self.exact_probes = 0

    def seen_before(self, hashes: np.ndarray) -> np.ndarray:
        """Vector query-and-insert: True where the hash was already seen.
        Zero false drops: a Bloom positive is verified in the exact table."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        self.bloom_probes += len(hashes)
        maybe = self.bloom.query(hashes)
        out = np.zeros(len(hashes), dtype=bool)
        for i in np.nonzero(maybe)[0]:
            self.exact_probes += 1
            out[i] = int(hashes[i]) in self.exact
        # insert everything new
        self.bloom.insert(hashes[~out])
        for h in hashes[~out]:
            self.exact.add(int(h))
        return out

    @property
    def filter_efficiency(self) -> float:
        """Fraction of probes that never left the cache-resident filter."""
        if self.bloom_probes == 0:
            return 1.0
        return 1.0 - self.exact_probes / self.bloom_probes
