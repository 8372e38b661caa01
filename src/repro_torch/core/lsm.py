"""LSM-tree point-query acceleration (paper §5.4), as a discrete-event model.

One LSM level holds N SSTables (newest = index 0 ... oldest = N-1, matching
the paper's "later SSTables" = older data already present when a newer table
is flushed). Each SSTable i carries an exact ChainedFilter whose positives
are its own keys and whose negatives are keys of *later* (older) tables
i+1..N-1 not in table i.

Query strategy (Fig 11b): probe filters newest→oldest; read each SSTable
whose filter fires; the first read that turns out to be a false positive
proves all remaining fired filters are also false positives ⇒ stop. Worst
case extra reads per level: 1 (vs N for Bloom filters).

No disk here — we count SSTable reads exactly and convert to latency with a
calibrated per-read cost, reproducing the shape of Figure 12.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bloom import BloomFilter
from .othello import DynamicExactFilter
from .bloomier import XorFilter


@dataclass
class SSTable:
    """Immutable sorted run. Membership is binary search on the sorted key
    array (no Python-set mirror); ``vals`` optionally carries the payloads
    aligned with ``keys`` (the storage engine's read path); ``tombs``
    optionally marks tombstone records (bool, aligned with ``keys``) — a
    tombstone is a *physical* record that shadows every older version of its
    key and means "deleted"."""

    keys: np.ndarray                      # sorted uint64
    vals: np.ndarray | None = field(repr=False, default=None)
    tombs: np.ndarray | None = field(repr=False, default=None)

    def freeze(self) -> "SSTable":
        """Mark the run's arrays read-only (idempotent) and return self.

        Generation-publish contract: once an SSTable is part of a published
        ``repro_torch.storage`` Generation its arrays never mutate again — scans,
        probes and compactions only READ them; compaction writes brand-new
        arrays for the next generation. Freezing turns an accidental
        in-place write into an immediate ``ValueError`` instead of a
        silently-corrupted pinned snapshot."""
        for a in (self.keys, self.vals, self.tombs):
            if a is not None:
                a.setflags(write=False)
        return self

    def contains(self, key: int) -> bool:
        """Physical membership (live OR tombstone record)."""
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        return i < len(self.keys) and self.keys[i] == np.uint64(key)

    def contains_many(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized physical membership -> bool [n] (batched read path)."""
        return _in_sorted(self.keys, np.asarray(keys, dtype=np.uint64))

    def get_many(self, keys: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(live bool [n], values uint64 [n], dead bool [n]).

        ``live`` — a live record for the key exists here; ``dead`` — the
        record here is a tombstone (the key is deleted as of this table and
        the search must STOP: older versions are shadowed). Values are 0
        where the key is absent, dead, or the table carries no payloads."""
        keys = np.asarray(keys, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=np.uint64)
        none = np.zeros(len(keys), dtype=bool)
        if len(self.keys) == 0:
            return none, out, none.copy()
        idx = np.searchsorted(self.keys, keys)
        idx_c = np.minimum(idx, len(self.keys) - 1)
        hit = self.keys[idx_c] == keys
        if self.tombs is None:
            dead = none
            live = hit
        else:
            dead = hit & self.tombs[idx_c]
            live = hit & ~dead
        if self.vals is not None:
            out[live] = self.vals[idx_c[live]]
        return live, out, dead

    # -- min/max fences ------------------------------------------------------
    # Filters cannot prune RANGE reads (a range is not a key); the sorted
    # run's endpoints can: a scan skips any table whose [min_key, max_key]
    # span misses the scan window.
    @property
    def min_key(self) -> int:
        return int(self.keys[0]) if len(self.keys) else 0

    @property
    def max_key(self) -> int:
        return int(self.keys[-1]) if len(self.keys) else 0

    def overlaps_range(self, lo: int, hi: int) -> bool:
        """Fence check: does [min_key, max_key] intersect [lo, hi)?"""
        return bool(len(self.keys)) and self.min_key < hi and self.max_key >= lo

    def slice_range(self, lo: int, hi: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, vals, tombs) of all physical records with lo <= key < hi
        (tombstones included — the caller's k-way merge masks them).
        ``hi`` may be 2**64, making the window end-inclusive of the maximum
        uint64 key."""
        a = int(np.searchsorted(self.keys, np.uint64(lo), side="left"))
        b = (len(self.keys) if hi >= 2 ** 64
             else int(np.searchsorted(self.keys, np.uint64(hi), side="left")))
        return self._slice(a, b)

    def slice_page(self, lo: int, hi: int, limit: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int | None]:
        """At most ``limit`` physical records from the START of the window
        ``lo <= key < hi`` -> (keys, vals, tombs, truncated_last):
        ``truncated_last`` is the slice's last key when window records
        remain beyond it (the caller's paged merge must not emit past it —
        this run's contribution above that key is unknown), else None.
        Shares ``slice_range``'s window-boundary semantics (``hi`` may be
        2**64, end-inclusive of the maximum uint64 key)."""
        a = int(np.searchsorted(self.keys, np.uint64(lo), side="left"))
        e = (len(self.keys) if hi >= 2 ** 64
             else int(np.searchsorted(self.keys, np.uint64(hi), side="left")))
        if a >= e:                       # no records in the window
            return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                    np.empty(0, bool), None)
        b = min(a + limit, e)
        ks, vs, ts = self._slice(a, b)
        return ks, vs, ts, (int(self.keys[b - 1]) if b < e else None)

    def _slice(self, a: int, b: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ks = self.keys[a:b]
        vs = (self.vals[a:b] if self.vals is not None
              else np.zeros(b - a, dtype=np.uint64))
        ts = (self.tombs[a:b] if self.tombs is not None
              else np.zeros(b - a, dtype=bool))
        return ks, vs, ts


def _in_sorted(sorted_keys: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Membership of ``qs`` in an already-sorted key array -> bool [n];
    O(n log m) binary search instead of ``np.isin``'s sort-merge over both
    arrays (the same trick ``SSTable.contains_many`` uses)."""
    if len(sorted_keys) == 0:
        return np.zeros(len(qs), dtype=bool)
    idx = np.minimum(np.searchsorted(sorted_keys, qs), len(sorted_keys) - 1)
    return sorted_keys[idx] == qs


@dataclass
class ChainedTableFilter:
    """One SSTable's two-stage ChainedFilter (§5.4.3): stage-1 approximate
    XorFilter over the table's keys, stage-2 *dynamic* exact Othello filter
    (positives = own keys, negatives = stage-1 false positives among the rest
    of the level), so newly flushed tables can be excluded online."""

    f1: XorFilter
    f2: DynamicExactFilter

    @classmethod
    def build(cls, keys: np.ndarray, other_keys: np.ndarray,
              fp_alpha: int = 7, seed1: int = 0, seed2: int = 0
              ) -> "ChainedTableFilter":
        """``other_keys``: the rest of the level's key universe at build time
        (older tables on flush; every other table on compaction)."""
        keys = np.asarray(keys, dtype=np.uint64)
        other = np.asarray(other_keys, dtype=np.uint64)
        f1 = XorFilter.build(keys, fp_alpha, seed=seed1)
        other = other[~_in_sorted(np.sort(keys), other)]
        fp = other[f1.query(other)] if len(other) else other
        f2 = DynamicExactFilter.build(keys, fp, seed=seed2)
        return cls(f1=f1, f2=f2)

    def exclude_new(self, own_keys: np.ndarray, new_keys: np.ndarray) -> None:
        """RocksDB-style online exclusion: ``new_keys`` just entered the
        level; whitelist-out the ones that stage-1 false-positives (unless
        they are also this table's own keys). ``own_keys`` must be sorted
        (SSTable key arrays always are); membership is binary search and
        the exclusion is ONE batched stage-2 union-find pass."""
        new_keys = np.asarray(new_keys, dtype=np.uint64)
        fp_keys = new_keys[self.f1.query(new_keys)]
        fp_keys = fp_keys[~_in_sorted(np.asarray(own_keys, dtype=np.uint64),
                                      fp_keys)]
        if len(fp_keys):
            self.f2.exclude(fp_keys)

    def exclude_deleted(self, deleted_keys: np.ndarray) -> None:
        """Tombstone semantics (the chain-rule step updates cannot skip):
        ``deleted_keys`` are dead store-wide, so this filter must never fire
        for them again — even where they are this table's OWN keys (a true
        positive, which ``exclude_new`` deliberately leaves alone). Every
        deleted key whose stage-1 fingerprint matches is pinned as an
        explicit stage-2 negative; keys stage-1 rejects can never fire (the
        Xor stage is immutable), so no edge is spent on them."""
        deleted = np.asarray(deleted_keys, dtype=np.uint64)
        if len(deleted) == 0:
            return
        fp_keys = deleted[self.f1.query(deleted)]
        if len(fp_keys):
            self.f2.exclude(fp_keys)

    def query(self, keys: np.ndarray) -> np.ndarray:
        return self.f1.query(keys) & self.f2.query(keys)

    # -- packed-table interchange (FilterBank, §5.2) -------------------------
    def to_tables(self):
        from .tables import LsmChainLayout, concat_tables
        tables, (xor_lay, oth_lay) = concat_tables(
            [self.f1.to_tables(), self.f2.to_tables()])
        return tables, LsmChainLayout(xor=xor_lay, oth=oth_lay,
                                      n_keys=self.f1.tbl.n_keys)

    @classmethod
    def from_tables(cls, tables: np.ndarray, layout) -> "ChainedTableFilter":
        """Query-only reconstruction (stage-2 Othello loses its adjacency)."""
        return cls(f1=XorFilter.from_tables(tables, layout.xor),
                   f2=DynamicExactFilter.from_tables(tables, layout.oth))

    @property
    def bits(self) -> int:
        return self.f1.bits + self.f2.bits


class LsmLevelChained:
    """One level with per-SSTable exact ChainedFilter (dynamic 2nd stage:
    Othello, so newly flushed tables can exclude their keys from older
    tables' filters online — §5.4.3's construction)."""

    def __init__(self, fp_alpha: int = 7, seed: int = 0):
        self.tables: list[SSTable] = []
        self.filters: list[ChainedTableFilter] = []
        self.fp_alpha = fp_alpha
        self.seed = seed

    # seed derivations are shared with repro_torch.storage.LsmStore so that a store
    # fed the same flush sequence builds bit-identical filters (the property
    # tests' parity contract).
    def _seeds(self, flush_idx: int) -> tuple[int, int]:
        return self.seed + 31 * flush_idx, self.seed + 7 * flush_idx

    @classmethod
    def from_parts(cls, tables: list[SSTable],
                   filters: list[ChainedTableFilter], fp_alpha: int = 7,
                   seed: int = 0) -> "LsmLevelChained":
        """Wrap existing (newest-first) tables + filters — e.g. a batched
        LsmStore's state — as a host-side reference model."""
        lvl = cls(fp_alpha=fp_alpha, seed=seed)
        lvl.tables = list(tables)
        lvl.filters = list(filters)
        return lvl

    @property
    def stage1(self) -> list[XorFilter]:
        return [f.f1 for f in self.filters]

    @property
    def stage2(self) -> list[DynamicExactFilter]:
        return [f.f2 for f in self.filters]

    def flush(self, keys: np.ndarray) -> None:
        """Add a NEW newest SSTable. Mirrors RocksDB: for each key of the new
        table, query older tables' stage-1 filters; false positives there get
        excluded via the older tables' dynamic stage-2 filters."""
        keys = np.asarray(np.sort(keys), dtype=np.uint64)
        new_idx = len(self.tables)
        # exclude this table's keys from every older table's filter
        for i in range(new_idx):
            self.filters[i].exclude_new(self.tables[i].keys, keys)
        # stage-2 starts with the table's own keys as positives and the
        # *current* false positives of stage-1 among older tables' keys
        older_keys = (np.concatenate([t.keys for t in self.tables])
                      if self.tables else np.empty(0, np.uint64))
        s1, s2 = self._seeds(new_idx)
        f = ChainedTableFilter.build(keys, older_keys, fp_alpha=self.fp_alpha,
                                     seed1=s1, seed2=s2)
        # newest-first ordering
        self.tables.insert(0, SSTable(keys))
        self.filters.insert(0, f)

    def _filter_hits(self, key: int) -> list[int]:
        hits = []
        k = np.array([key], dtype=np.uint64)
        for i in range(len(self.tables)):
            if bool(self.filters[i].query(k)[0]):
                hits.append(i)
        return hits

    def point_query(self, key: int) -> tuple[bool, int, int]:
        """Returns (found, sstable_reads, filter_probes)."""
        hits = self._filter_hits(key)
        reads = 0
        for idx in hits:
            reads += 1
            if self.tables[idx].contains(key):
                return True, reads, len(self.tables)
            # first false positive ⇒ all later hits are false positives too
            break
        return False, reads, len(self.tables)

    @property
    def filter_bits(self) -> int:
        return (sum(f.bits for f in self.stage1)
                + sum(f.bits for f in self.stage2))


class LsmLevelBloom:
    """Baseline: per-SSTable Bloom filter at a given bits/key budget."""

    def __init__(self, bits_per_key: float = 10.0, seed: int = 0):
        self.tables: list[SSTable] = []
        self.filters: list[BloomFilter] = []
        self.bits_per_key = bits_per_key
        self.seed = seed

    def flush(self, keys: np.ndarray) -> None:
        keys = np.asarray(np.sort(keys), dtype=np.uint64)
        if self.bits_per_key <= 0:
            f = None
        else:
            fpr = max(1e-9, 2.0 ** (-self.bits_per_key * np.log(2)))
            f = BloomFilter.build(keys, float(fpr), seed=self.seed + len(self.filters))
        self.tables.insert(0, SSTable(keys))
        self.filters.insert(0, f)

    def point_query(self, key: int) -> tuple[bool, int, int]:
        k = np.array([key], dtype=np.uint64)
        reads = 0
        for i, t in enumerate(self.tables):
            if self.filters[i] is not None and not bool(self.filters[i].query(k)[0]):
                continue
            reads += 1
            if t.contains(key):
                return True, reads, len(self.tables)
        return False, reads, len(self.tables)

    @property
    def filter_bits(self) -> int:
        return sum(f.bits for f in self.filters if f is not None)


def latency_model(reads: np.ndarray, probes_cost_us: float = 2.0,
                  read_cost_us: float = 9.0) -> np.ndarray:
    """Calibrated against the paper's Fig 12: ~12µs floor (memtable+index
    probes) + ~9µs per SSTable read."""
    return probes_cost_us * 6.0 + read_cost_us * reads
