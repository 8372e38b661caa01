"""Tiered prefix-KV cache with per-tier exact ChainedFilters — paper §5.4
mapped from LSM SSTables to LM-serving cache tiers.

Tiers model the serving memory hierarchy (HBM → host DRAM → SSD), each with
a probe cost. A naive design probes tiers in order, paying a miss cost per
tier crossed. Here every tier carries a dynamic exact ChainedFilter (Bloom
stage-1 + Othello stage-2) whose *negatives are the keys of later tiers* —
exactly the paper's SSTable construction. Consequences (Thm 4.1 / §5.4):

- a filter fires only for keys in ITS tier and not in any later tier;
- probing fired tiers in order, the first false positive proves all later
  fired filters are false positives too ⇒ ≤ 1 wasted tier probe per lookup.

Eviction demotes entries a tier down: the entry's key becomes a negative
of the upper tier (stage-2 exclude) and a positive of the lower one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.bloom import BloomFilter, optimal_params
from repro_torch.core.othello import DynamicExactFilter, Othello
from repro_torch.kernels.common import as_device

from .filter_service import FilterService


@dataclass(frozen=True)
class TierSpec:
    name: str
    capacity: int                  # number of prefix entries
    probe_cost_us: float           # cost of actually probing the tier


@dataclass
class _TierFilter:
    """Dynamic exact ChainedFilter ('&' with dynamic parts, §4.3.1)."""
    bloom: BloomFilter
    exact: DynamicExactFilter

    @classmethod
    def fresh(cls, capacity: int, seed: int) -> "_TierFilter":
        m, k = optimal_params(max(64, capacity), 0.02)
        oth = Othello(ma=max(64, capacity * 2), mb=max(64, capacity * 2),
                      seed=seed + 5)
        return cls(bloom=BloomFilter(m_bits=m, k=k, seed=seed),
                   exact=DynamicExactFilter(oth=oth))

    def add_positive(self, key: np.uint64) -> None:
        k = np.array([key], np.uint64)
        self.bloom.insert(k)
        self.exact.include(k)

    def add_negative(self, key: np.uint64) -> None:
        """A key that lives in a LATER tier (or was demoted out of this
        one): ensure this tier's filter answers 'no' exactly."""
        k = np.array([key], np.uint64)
        if self.bloom.query(k)[0]:       # stage-1 false positive: whitelist
            self.exact.exclude(k)

    def query(self, key: np.uint64) -> bool:
        k = np.array([key], np.uint64)
        return bool(self.bloom.query(k)[0]) and bool(self.exact.query(k)[0])

    @property
    def bits(self) -> int:
        return self.bloom.bits + self.exact.bits


class TieredPrefixCache:
    """Tiers of prefix entries, each behind its exact ChainedFilter. The
    batched stage-1 probe (``lookup_batch``) runs on ``device``: the card
    by default, ``"cpu"`` for the plain versions."""

    def __init__(self, tiers: list[TierSpec], seed: int = 0, *,
                 device="cuda"):
        self.device = as_device(device)
        self.specs = tiers
        self.filters = [_TierFilter.fresh(t.capacity, seed + 31 * i)
                        for i, t in enumerate(tiers)]
        self.store: list[dict] = [dict() for _ in tiers]   # key -> payload
        self.lru: list[list] = [[] for _ in tiers]
        self.probes = 0            # actual tier probes paid
        self.wasted_probes = 0     # probes that found nothing
        self.lookups = 0
        self.batched_lookups = 0
        self.probe_cost_paid_us = 0.0
        # batched stage-1 probing through a packed FilterBank (§5.2):
        # rebuilt lazily whenever a tier filter mutates.
        self._service = None
        self._service_dirty = True

    # ------------------------------------------------------------- insert
    def insert(self, key: int, payload, tier: int = 0) -> None:
        key = np.uint64(key)
        self._insert_at(key, payload, tier)

    def _insert_at(self, key: np.uint64, payload, ti: int) -> None:
        if ti >= len(self.specs):
            return                                    # dropped off the end
        self._service_dirty = True
        spec = self.specs[ti]
        if len(self.store[ti]) >= spec.capacity:
            victim = self.lru[ti].pop(0)
            vp = self.store[ti].pop(victim)
            # demotion: upper tier must now answer 'no' for the victim...
            self.filters[ti].add_negative(victim)
            # ...and earlier tiers must keep answering 'no' (victim is now
            # in a later tier) — they already do, it was below them.
            self._insert_at(victim, vp, ti + 1)
        self.store[ti][key] = payload
        self.lru[ti].append(key)
        self.filters[ti].add_positive(key)
        # every EARLIER tier treats this key as a negative (paper Fig 11a)
        for fj in range(ti):
            self.filters[fj].add_negative(key)

    # ------------------------------------------------------------- lookup
    def lookup(self, key: int):
        """Returns (payload | None, tier_index | None). Accounting mirrors
        the paper: fired filters are probed in order; the first probe that
        misses proves the rest are false positives (stop)."""
        key = np.uint64(key)
        self.lookups += 1
        fired = [i for i, f in enumerate(self.filters) if f.query(key)]
        return self._probe_fired(key, fired)

    def _probe_fired(self, key: np.uint64, fired: list[int]):
        for ti in fired:
            self.probes += 1
            self.probe_cost_paid_us += self.specs[ti].probe_cost_us
            if key in self.store[ti]:
                self.lru[ti].remove(key)
                self.lru[ti].append(key)
                return self.store[ti][key], ti
            self.wasted_probes += 1
            break                       # §5.4: later hits are false too
        return None, None

    # ------------------------------------------------- batched lookup (§5.2)
    def _refresh_service(self):
        if self._service is None or self._service_dirty:
            blooms = [f.bloom for f in self.filters]
            if self._service is None:
                self._service = FilterService(blooms, device=self.device)
            else:
                # inserts only flip bits — layouts are invariant, so re-pack
                # the bank's contents into a new state on the device
                self._service.refresh_tables(blooms)
            self._service_dirty = False
        return self._service

    def lookup_batch(self, keys: list[int]) -> list[tuple]:
        """Batched lookup for a stream of keys: ONE probe of the packed
        bank of tier stage-1 Bloom filters (one ``bloom_probe`` launch per
        tier) decides candidate tiers
        for every key; the exact stage-2 whitelist and the in-order store
        probing (same ≤ 1 wasted-probe accounting as ``lookup``) stay
        host-side. Returns [(payload | None, tier | None)] per key."""
        if not keys:
            return []
        service = self._refresh_service()
        arr = np.array([np.uint64(k) for k in keys], dtype=np.uint64)
        stage1, _ = service.probe(arr)          # bool [n_tiers, n]
        results = []
        for j, key in enumerate(arr):
            self.lookups += 1
            fired = [i for i in range(len(self.filters))
                     if stage1[i, j]
                     and bool(self.filters[i].exact.query(arr[j:j + 1])[0])]
            results.append(self._probe_fired(key, fired))
        self.batched_lookups += len(arr)
        return results

    # ---------------------------------------------------------- accounting
    @property
    def filter_bits(self) -> int:
        return sum(f.bits for f in self.filters)

    def stats(self) -> dict:
        return {"lookups": self.lookups, "probes": self.probes,
                "wasted_probes": self.wasted_probes,
                "batched_lookups": self.batched_lookups,
                "avg_probe_cost_us": (self.probe_cost_paid_us
                                      / max(1, self.lookups)),
                "filter_KiB": self.filter_bits / 8 / 1024}
