"""Batched LSM storage engine with fused filter-guarded point queries (§5.4).

The paper's headline systems result: ChainedFilter-guarded LSM point
queries pay ≤ 1 wasted SSTable read per query (Fig 11b), cutting P99 tail
latency vs Bloom filters at equal space (Fig 12). ``core.lsm`` models one
level per-key on the host; this module is the serving-scale engine on top
of the FilterBank probe stack. It is the port of ``repro.storage.lsm_store``
and follows it operation for operation; the bank and the probes live on
``device`` (the card by default) and every read goes through the
``lsm_probe`` CUDA kernel there:

- **Write path.** ``put_batch`` merges each batch into a sorted-array
  memtable (newest-wins, one vectorized merge — no Python dict); ``flush``
  freezes it into the newest immutable ``SSTable`` and builds that table's
  two-stage ChainedFilter (stage-1 Xor, stage-2 dynamic Othello —
  ``core.lsm.ChainedTableFilter``, the same construction and seed schedule
  as ``LsmLevelChained``, so a store and the host model fed the same flush
  sequence are bit-identical). Both filter stages build as bulk array
  passes (Bloomier peeling / Othello bipartite peeling), and older tables'
  filters exclude the new keys online (§5.4.3) with ONE batched union-find
  pass per table instead of per-key component walks. Size-tiered
  compaction merges age-adjacent runs of similar size and rebuilds ONLY
  the merged table's filter, with negatives drawn from every other table
  so per-table exactness over the store's key universe survives.

- **Read path: generations.** Every flush/compaction/deferred-GC sweep
  funnels through ONE swap point (``_publish``): the build-side
  (sstables, filters) lists are frozen into an immutable ``Generation``
  — packed FilterBank buffer, static probe descriptors and pre-packed
  per-table param lanes, all marked read-only — and installed with a
  single reference assignment. ``get_batch`` probes ALL SSTable filters
  of the current generation for the whole key batch in one fused
  ``lsm_probe`` launch, then resolves the newest-first first-hit per key
  with one vectorized ``searchsorted`` read: found ⇒ 1 read,
  miss-but-fired ⇒ exactly 1 wasted read, else 0. The bank refresh is
  double-buffered through ``FilterService`` (build the next ``BankState``
  while the old stays probe-able, then publish).

- **Snapshots.** ``snapshot()`` pins the current generation (refcounted)
  plus a frozen memtable image; the handle's ``get_batch``/``scan``/
  ``scan_iter`` resolve against the pinned state only, so long-lived
  cursors and pagination finish on their generation while flushes and
  compactions publish newer ones. Tombstones a snapshot can still observe
  are exempt from compaction GC until release (**deferred GC**); the last
  snapshot's release collects them.

- **Deletes (tombstones).** ``delete_batch`` writes tombstone records that
  ride the same memtable/flush machinery (newest-wins merge makes them
  shadow older versions). A flushed tombstone is *excluded* from every
  chained filter — never enrolled in its own table's filter and pinned to
  stage-2 zero in older filters via ``exclude_deleted`` (true positives
  too) — so a deleted key fires nothing and costs 0 reads; compaction
  garbage-collects the record once no older run can still hold the key
  AND no open snapshot still observes the tombstone.

- **Range scans.** ``scan(lo, hi)`` k-way merges memtable + SSTable slices
  newest-first over the half-open window with newest-wins/tombstone
  masking. Filters cannot prune a range; each sorted run's min/max fences
  can, and do. ``scan_iter`` is the paged, snapshot-pinned variant.

Per-table Bloom (``filter_kind='bloom'``) and filterless
(``filter_kind='none'``) baselines share the same probe kernel and batched
read path via the kernel's ``hits_mask`` output — they just read every
fired table until the key's newest record (live or tombstone) turns up,
which is precisely the tail the chain rule removes.
"""
from __future__ import annotations

import threading
import time
import types
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.lsm import SSTable, ChainedTableFilter, _in_sorted
from repro_torch.core.tables import TABLE_ALIGN, BloomTable, LsmChainLayout
from repro_torch.kernels.common import as_device
from repro_torch.kernels.lsm_probe import MAX_TABLES
from repro_torch.serving.filter_service import FilterService
from repro_torch.storage.generation import Generation, Snapshot

FILTER_KINDS = ("chained", "bloom", "none")


class WriteStall(RuntimeError):
    """Typed backpressure: the write path could not obtain SSTable headroom
    — ``table_cap`` tables exist and compaction created none within
    ``stall_timeout_s`` (background mode), or the store has no compactor to
    wait for (foreground ``auto_compact=False`` overflow). Subclasses
    ``RuntimeError`` so pre-typed callers keep working; new callers can
    distinguish backpressure (catch, ``compact()``/back off, retry — the
    drained batch is never lost) from corruption (don't)."""

    def __init__(self, msg: str, *, n_tables: int | None = None,
                 waited_s: float | None = None):
        super().__init__(msg)
        self.n_tables = n_tables
        self.waited_s = waited_s


class PublishHookError(RuntimeError):
    """One or more publish hooks raised — AFTER the generation swap and
    after every other hook still ran (failures are isolated per hook, so a
    broken secondary index can never leave later tag banks unenrolled).
    The new generation is installed and consistent; ``errors`` carries
    ``[(hook, exception), ...]`` for the caller to triage."""

    def __init__(self, errors: list):
        self.errors = list(errors)
        names = ", ".join(getattr(h, "__qualname__", repr(h))
                          for h, _ in self.errors)
        super().__init__(f"{len(self.errors)} publish hook(s) failed after "
                         f"the generation swap: {names}")


class _ScanCursor:
    """Iterator of (keys, vals) pages that OWNS a snapshot pin. A plain
    wrapper generator cannot guarantee release: closing or abandoning a
    never-started generator skips its ``finally`` entirely, leaking the
    pin (and blocking deferred tombstone GC) forever. This object releases
    on exhaustion, on ``close()``, on error, and — last resort — on GC."""

    def __init__(self, snap, inner):
        self._snap = snap
        self._inner = inner

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:       # StopIteration included: pin released
            self.close()
            raise

    def close(self) -> None:
        self._inner.close()
        self._snap.close()          # idempotent

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass                    # interpreter teardown

    def __enter__(self) -> "_ScanCursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _chain_descriptor(layout) -> tuple:
    """Static per-table descriptor for ``lsm_probe`` from a bank layout."""
    if isinstance(layout, LsmChainLayout):
        return layout.probe_params()
    if isinstance(layout, BloomTable):
        return ("bloom", (layout.m_bits, layout.k, layout.seed, layout.offset))
    raise TypeError(f"no lsm_probe descriptor for {type(layout).__name__}")


@dataclass
class StoreStats:
    puts: int = 0
    deletes: int = 0
    gets: int = 0
    scans: int = 0
    flushes: int = 0
    compactions: int = 0
    memtable_hits: int = 0
    probed: int = 0                  # keys that reached the filter bank
    sstable_reads: int = 0
    wasted_reads: int = 0            # reads that found nothing
    tombstones_gced: int = 0         # tombstone records dropped (flush+compact)
    tombstones_gc_deferred: int = 0  # GC-able tombstones kept for a snapshot
    scan_tables_read: int = 0        # table slices merged by scans
    scan_tables_pruned: int = 0      # table slices skipped by min/max fences
    generations_published: int = 0   # swap-point count (flush/compact/GC)
    snapshots_opened: int = 0
    snapshots_closed: int = 0
    write_stalls: int = 0            # admission waits entered at table_cap
    stall_time_s: float = 0.0        # total wall time spent in those waits
    stall_timeouts: int = 0          # waits that expired into WriteStall
    bg_compactions: int = 0          # merge runs executed by _background_step
    bg_gc_sweeps: int = 0            # deferred-GC sweeps run off the close path
    publish_hook_errors: int = 0     # hook failures isolated by _run_publish_hooks

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["avg_reads_per_get"] = self.sstable_reads / max(1, self.gets)
        return d


@dataclass
class LsmStore:
    """Point-query LSM store: memtable + newest-first immutable SSTables,
    batched filter-guarded reads through one fused kernel launch against
    generation-tagged immutable banks.

    ``mesh`` is handed to the store's ``FilterService``, whose bank probes
    (``service.probe``) it splits by rows; ``get_batch``'s fused
    ``lsm_probe`` runs over the whole batch on every rank, as in the JAX
    package."""

    filter_kind: str = "chained"
    memtable_capacity: int = 4096
    fp_alpha: int = 7                 # chained: stage-1 fingerprint bits
    bits_per_key: float = 10.0        # bloom baseline space budget
    seed: int = 0
    compact_min_run: int = 4          # size-tiered: merge runs >= this long
    compact_size_ratio: float = 4.0   # ... of tables within this size ratio
    auto_compact: bool = True
    table_cap: int = MAX_TABLES       # admission control: stall/fail at this
    stall_timeout_s: float = 5.0      # bounded admission wait before WriteStall
    device: object = "cuda"           # bank + probes; "cpu" = plain versions
    mesh: object = None               # service.probe's row split (DeviceMesh)

    sstables: list = field(default_factory=list, repr=False)   # newest first
    filters: list = field(default_factory=list, repr=False)    # parallel
    service: FilterService | None = field(default=None, repr=False)
    stats: StoreStats = field(default_factory=StoreStats, repr=False)
    # snapshot-handle traffic accumulates HERE, not in ``stats`` — gated
    # benchmark metrics derived from live-read accounting must not be
    # contaminated by pinned-view reads (same isolation rule as
    # FilterService.probe on non-current states)
    snap_stats: StoreStats = field(default_factory=StoreStats, repr=False)

    def __post_init__(self):
        if self.filter_kind not in FILTER_KINDS:
            raise ValueError(f"filter_kind must be one of {FILTER_KINDS}")
        if not (2 <= self.table_cap <= MAX_TABLES):
            raise ValueError(f"table_cap must be in [2, {MAX_TABLES}] "
                             "(the fused probe kernel's table limit)")
        self.device = as_device(self.device)
        self._flush_count = 0
        self._compact_count = 0
        # two-lock protocol (lock order: _wl then _mu, never the reverse):
        # - _mu is the SMALL lock — memtable/flushing arrays, the _gen swap,
        #   snapshot bookkeeping and stall signalling. Readers take only _mu
        #   and only briefly (overlay resolution / part slicing); generation
        #   probing runs lock-free against immutable state.
        # - _wl is the MUTATOR lock — serializes flush / compaction / GC
        #   sweeps, so build-side list edits and in-place filter exclusions
        #   never interleave. Readers never take it; the background
        #   compactor releases it between merge runs so flushes interleave.
        self._mu = threading.RLock()
        self._stall_cv = threading.Condition(self._mu)
        self._wl = threading.RLock()
        self._stall_waiters = 0
        self._bg = None                           # BackgroundCompactor | None
        # generation-tagged read state: reads resolve against the last
        # PUBLISHED generation; the dataclass lists above are the private
        # build-side copies every mutation path edits before one publish.
        self._gen = Generation.empty(0, device=self.device)
        self._next_gen_id = 1
        # publish hooks: called AFTER each generation swap with the newly
        # published Generation — the secondary-index enrollment point (the
        # query layer's tag banks rebuild here, reading live rows through
        # Generation.live_items, never the private build-side lists)
        self._on_publish: list = []
        self._snapshots: list[Snapshot] = []      # open handles, any order
        self._pinned: dict[int, int] = {}         # gen_id -> snapshot refs
        self._gc_pending = False                  # deferred tombstones exist
        # array-backed memtable: parallel sorted key/value/tombstone arrays,
        # merged on every put_batch/delete_batch (newest-wins) — flush drains
        # them with zero copies. A True tombstone row means "deleted here".
        self._mt_keys = np.empty(0, dtype=np.uint64)
        self._mt_vals = np.empty(0, dtype=np.uint64)
        self._mt_tombs = np.empty(0, dtype=bool)
        # FLUSHING slot (LevelDB's immutable memtable): flush moves the
        # drained arrays here so readers keep resolving them — memtable →
        # flushing → generation, newest wins — for the whole filter build,
        # then the publish that installs the table clears the slot. Frozen
        # (read-only) while occupied; None otherwise.
        self._fl_keys = None
        self._fl_vals = None
        self._fl_tombs = None

    @property
    def memtable_len(self) -> int:
        """Records not yet in a published SSTable: live memtable plus any
        in-flight flushing run (the write queue depth)."""
        with self._mu:
            fl = 0 if self._fl_keys is None else len(self._fl_keys)
            return len(self._mt_keys) + fl

    @property
    def memtable(self) -> "types.MappingProxyType":
        """Read-only dict view of the sorted-array memtable's LIVE entries
        — any in-flight flushing run folded underneath (memtable newer) —
        (debugging / introspection; mutation raises — write through
        ``put_batch``/``delete_batch``)."""
        with self._mu:
            if self._fl_keys is not None and len(self._fl_keys):
                cat_k = np.concatenate([self._mt_keys, self._fl_keys])
                cat_v = np.concatenate([self._mt_vals, self._fl_vals])
                cat_t = np.concatenate([self._mt_tombs, self._fl_tombs])
                ks, fi = np.unique(cat_k, return_index=True)
                vs, ts = cat_v[fi], cat_t[fi]
            else:
                ks, vs, ts = self._mt_keys, self._mt_vals, self._mt_tombs
            live = ~ts
            return types.MappingProxyType(
                dict(zip(ks[live].tolist(), vs[live].tolist())))

    # ------------------------------------------------------------- write path
    def _memtable_merge(self, keys: np.ndarray, values: np.ndarray,
                        tombs: bool) -> None:
        """Newest-wins merge of one (deduped-last) record batch into the
        sorted array memtable; ``tombs`` marks the whole batch as tombstones
        (deletes) or live (puts)."""
        # dedupe within the batch (reversed + unique keeps the LAST write)
        uk, first_idx = np.unique(keys[::-1], return_index=True)
        uv = values[::-1][first_idx]
        ut = np.full(len(uk), tombs, dtype=bool)
        with self._mu:
            m = len(self._mt_keys)
            if m < 16384 or len(uk) * 8 >= m:
                # small memtable / large relative batch: one combined unique
                # (newest occurrence first ⇒ batch shadows old)
                cat_k = np.concatenate([uk, self._mt_keys])
                cat_v = np.concatenate([uv, self._mt_vals])
                cat_t = np.concatenate([ut, self._mt_tombs])
                mk, fi = np.unique(cat_k, return_index=True)
                self._mt_keys, self._mt_vals = mk, cat_v[fi]
                self._mt_tombs = cat_t[fi]
            else:
                # big memtable, small batch: overwrite hits in place and
                # splice misses by position — O(batch log + memtable), no
                # full re-sort. Open snapshots hold COPIES of these arrays
                # and concurrent readers resolve the overlay entirely under
                # _mu, so the in-place writes never leak into any view.
                pos = np.searchsorted(self._mt_keys, uk)
                pos_c = np.minimum(pos, m - 1)
                hit = self._mt_keys[pos_c] == uk
                self._mt_vals[pos_c[hit]] = uv[hit]
                self._mt_tombs[pos_c[hit]] = tombs
                if (~hit).any():
                    self._mt_keys = np.insert(self._mt_keys, pos[~hit],
                                              uk[~hit])
                    self._mt_vals = np.insert(self._mt_vals, pos[~hit],
                                              uv[~hit])
                    self._mt_tombs = np.insert(self._mt_tombs, pos[~hit],
                                               tombs)
            over = len(self._mt_keys) >= self.memtable_capacity
        if over:            # flush takes _wl (and may stall) — not under _mu
            self.flush()

    def put_batch(self, keys: np.ndarray, values: np.ndarray | None = None
                  ) -> None:
        """Upsert a key batch (newest write wins): one vectorized sorted
        merge into the array memtable. Auto-flushes whenever the memtable
        reaches capacity."""
        keys = np.asarray(keys, dtype=np.uint64)
        values = (np.zeros(len(keys), dtype=np.uint64) if values is None
                  else np.asarray(values, dtype=np.uint64))
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        self.stats.puts += len(keys)
        if len(keys):
            self._memtable_merge(keys, values, tombs=False)

    def put(self, key: int, value: int = 0) -> None:
        self.put_batch(np.array([key], np.uint64), np.array([value], np.uint64))

    def delete_batch(self, keys: np.ndarray) -> None:
        """Delete a key batch: tombstone records enter the memtable exactly
        like puts (the newest-wins merge makes them shadow any older write,
        in memory or on any SSTable) and flow to SSTables at flush. Deleting
        a key that was never written is legal (a no-op once its tombstone is
        garbage-collected)."""
        keys = np.asarray(keys, dtype=np.uint64)
        self.stats.deletes += len(keys)
        if len(keys):
            self._memtable_merge(keys, np.zeros(len(keys), dtype=np.uint64),
                                 tombs=True)

    def delete(self, key: int) -> None:
        self.delete_batch(np.array([key], np.uint64))

    # seed schedule shared with LsmLevelChained._seeds → bit-identical
    # filters for identical flush sequences (the parity-test contract).
    def _flush_seeds(self) -> tuple[int, int]:
        return self.seed + 31 * self._flush_count, self.seed + 7 * self._flush_count

    def _compact_seeds(self) -> tuple[int, int]:
        # disjoint from the flush schedule (compacted tables are new filters)
        s = self.seed + 10007 + 131 * self._compact_count
        return s, s + 1

    def _build_filter(self, live_keys: np.ndarray, dead_keys: np.ndarray,
                      other_keys: np.ndarray, seeds: tuple[int, int],
                      gone_keys: np.ndarray | None = None):
        """Per-table filter over a physical run split into ``live_keys`` and
        ``dead_keys`` (tombstones / keys shadowed by newer tombstones).

        - chained: ONLY live keys enroll as positives — a deleted key must
          never burn filter space or short-circuit the fused probe's
          first-hit mask; dead keys join the negative universe so their
          stage-1 fingerprint collisions are pinned to stage-2 zeros.
        - bloom: every physical record enrolls (Bloom cannot exclude; the
          read path discovers the tombstone by reading the table).

        ``gone_keys`` (chained only) are keys with NO physical record left
        (GC'd tombstones) pinned as extra negatives, so "deleted keys never
        fire rebuilt filters" stays exact instead of false-positive-unlikely.
        """
        if self.filter_kind == "chained":
            assert (len(dead_keys) == 0 or
                    not np.intersect1d(live_keys, dead_keys).size), \
                "tombstoned keys must never enroll as filter positives"
            extra = [dead_keys] if len(dead_keys) else []
            if gone_keys is not None and len(gone_keys):
                extra.append(gone_keys)
            other = (np.concatenate([other_keys, *extra]) if extra
                     else other_keys)
            return ChainedTableFilter.build(live_keys, other,
                                            fp_alpha=self.fp_alpha,
                                            seed1=seeds[0], seed2=seeds[1])
        if self.filter_kind == "bloom":
            if self.bits_per_key <= 0:
                return None
            fpr = max(1e-9, 2.0 ** (-self.bits_per_key * np.log(2)))
            phys = (np.concatenate([live_keys, dead_keys])
                    if len(dead_keys) else live_keys)
            return BloomFilter.build(phys, float(fpr), seed=seeds[0])
        return None

    def _admit(self, bg) -> None:
        """Admission control (background mode only): block — bounded by
        ``stall_timeout_s`` — while the store already holds ``table_cap``
        SSTables, waiting for the background compactor to create headroom.
        Called BEFORE the mutator lock is taken, so the compactor is never
        blocked by the very waiter it must unblock. Raises ``WriteStall``
        on timeout; stall entry/duration/timeout counts land in ``stats``."""
        with self._stall_cv:                      # == self._mu
            if len(self.sstables) < self.table_cap:
                return
            self.stats.write_stalls += 1
            self._stall_waiters += 1
            t0 = time.monotonic()
            deadline = t0 + self.stall_timeout_s
            try:
                while len(self.sstables) >= self.table_cap:
                    bg.kick()
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.stats.stall_timeouts += 1
                        raise WriteStall(
                            f"write stalled {self.stall_timeout_s:.3f}s at "
                            f"{len(self.sstables)} SSTables (cap "
                            f"{self.table_cap}) — background compaction made "
                            "no headroom; call compact() or back off",
                            n_tables=len(self.sstables),
                            waited_s=time.monotonic() - t0)
                    self._stall_cv.wait(min(remaining, 0.05))
            finally:
                self._stall_waiters -= 1
                self.stats.stall_time_s += time.monotonic() - t0

    def flush(self) -> None:
        """Freeze the memtable into the newest SSTable, build its filter
        (live keys only), exclude its keys from older chained filters online
        — live keys via ``exclude_new`` (stage-1 false positives), deleted
        keys via ``exclude_deleted`` (true positives too: a tombstone kills
        every older table's filter for its key) — compact if a size-tiered
        run formed, and publish ONE new generation. Readers (and pinned
        snapshots) resolve against the previous generation until the swap;
        DURING the build the drained records stay readable through the
        flushing slot, so a concurrent reader never sees them vanish.

        With a background compactor running, inline compaction is skipped
        (the compactor owns it) and a flush that would exceed ``table_cap``
        BLOCKS in ``_admit`` until headroom appears (``WriteStall`` after
        ``stall_timeout_s``). Without one, the pre-PR semantics hold:
        ``auto_compact`` compacts inline, and the overflow path installs the
        build-side state then raises the (now typed) ``WriteStall``."""
        while True:
            with self._mu:
                if not len(self._mt_keys):
                    return
            bg = self._bg
            bg_active = bg is not None and bg.running
            if bg_active:
                self._admit(bg)
            with self._wl:
                if bg_active and len(self.sstables) >= self.table_cap:
                    continue    # a racing flush refilled the cap: re-admit
                self._flush_locked(bg_active)
                return

    def _flush_locked(self, bg_active: bool) -> None:
        """The flush body, under the mutator lock ``_wl``."""
        with self._mu:
            if not len(self._mt_keys):
                return
            # the array memtable IS the sorted, deduped run — drain it into
            # the flushing slot (readers resolve it there until the publish)
            keys, vals, tombs = self._mt_keys, self._mt_vals, self._mt_tombs
            self._fl_keys, self._fl_vals, self._fl_tombs = keys, vals, tombs
            self._mt_keys = np.empty(0, dtype=np.uint64)
            self._mt_vals = np.empty(0, dtype=np.uint64)
            self._mt_tombs = np.empty(0, dtype=bool)
        for a in (keys, vals, tombs):
            a.setflags(write=False)       # frozen while readers overlay them
        try:
            if tombs.any():
                # flush-time GC: a tombstone only earns its SSTable row if
                # some older table still physically holds the key it
                # shadows. (No snapshot deferral needed here: open snapshots
                # carry their own frozen memtable image, so the record was
                # never theirs to lose.)
                dead = keys[tombs]
                shadowing = np.zeros(len(dead), dtype=bool)
                for t in self.sstables:
                    shadowing |= t.contains_many(dead)
                keep = ~tombs.copy()
                keep[tombs] = shadowing
                self.stats.tombstones_gced += int(len(dead) - shadowing.sum())
                keys, vals, tombs = keys[keep], vals[keep], tombs[keep]
                dead = dead[shadowing]
            else:
                dead = np.empty(0, dtype=np.uint64)
            if not len(keys):
                return                # every record was a useless tombstone
            live = keys[~tombs] if len(dead) else keys
            # one batched stage-2 exclusion pass per older table (vs
            # per-key); these mutate the BUILD-side filter objects only —
            # every published generation already packed its own frozen copy
            # of the bank
            for tbl, filt in zip(self.sstables, self.filters):
                if isinstance(filt, ChainedTableFilter):
                    filt.exclude_new(tbl.keys, live)
                    filt.exclude_deleted(dead)
            other = (np.concatenate([t.keys for t in self.sstables])
                     if self.sstables else np.empty(0, np.uint64))
            f = self._build_filter(live, dead, other, self._flush_seeds())
            tables = [SSTable(keys, vals, tombs if len(dead) else None)]
            tables += self.sstables
            filters = [f] + list(self.filters)
            self._flush_count += 1
            self.stats.flushes += 1
            if self.auto_compact and not bg_active:
                tables, filters = self._compact_all(tables, filters)
                if len(tables) > self.table_cap:
                    # probe-kernel/admission cap: force-merge the oldest
                    # tables into one run even when no size-tiered run
                    # qualifies
                    tables, filters = self._merge_run(
                        tables, filters, self.table_cap - 1, len(tables) - 1)
            elif len(tables) > self.table_cap and not bg_active:
                # install the build-side lists BEFORE raising so the drained
                # batch (and its tombstones' filter exclusions) is never
                # lost: reads keep serving the last published generation —
                # stale but CONSISTENT — and the compact() this error
                # demands merges below the cap and publishes everything
                self.sstables, self.filters = tables, filters
                raise WriteStall(
                    f"more than {self.table_cap} SSTables without "
                    "compaction; call compact()", n_tables=len(tables))
            self.sstables, self.filters = tables, filters
            self._publish()
            if bg_active:
                self._bg.kick()           # new table: compaction debt moved
        finally:
            # the publish installed the run as a table (or the flush
            # failed and the records are in the build-side lists / lost to
            # the error) — either way the overlay slot retires
            with self._mu:
                self._fl_keys = self._fl_vals = self._fl_tombs = None

    # ------------------------------------------------------------- compaction
    def _find_run(self, tables: list) -> tuple[int, int] | None:
        """Longest age-adjacent run of >= compact_min_run tables whose sizes
        stay within compact_size_ratio (size-tiered policy; adjacency keeps
        newest-wins shadowing intact)."""
        sizes = [len(t.keys) for t in tables]
        n = len(sizes)
        for i in range(n):
            j, mn, mx = i, sizes[i], sizes[i]
            while j + 1 < n:
                mn2, mx2 = min(mn, sizes[j + 1]), max(mx, sizes[j + 1])
                if mx2 > self.compact_size_ratio * max(mn2, 1):
                    break
                j, mn, mx = j + 1, mn2, mx2
            # a run must actually shrink the table count (length >= 2),
            # whatever compact_min_run says — a 1-table "merge" would loop
            if j - i + 1 >= max(self.compact_min_run, 2):
                return i, j
        return None

    def _merge_run(self, tables: list, filters: list, i: int, j: int,
                   tomb_shadowing: np.ndarray | None = None
                   ) -> tuple[list, list]:
        """Merge ``tables[i:j+1]`` into one run on the PRIVATE build-side
        lists and return the edited lists — nothing is published here, so
        half-merged states are never observable by readers.

        ``tomb_shadowing`` lets a caller that already probed the older
        tables (``_collect_deferred``'s eligibility sweep) pass its result
        in instead of paying the searchsorted pass twice; it must be the
        older-run physical-membership mask for exactly the merged run's
        ascending tombstoned keys (always true for a single-table merge)."""
        run = tables[i:j + 1]
        cat_k = np.concatenate([t.keys for t in run])          # newest first
        cat_v = np.concatenate([
            t.vals if t.vals is not None else np.zeros(len(t.keys), np.uint64)
            for t in run])
        cat_t = np.concatenate([
            t.tombs if t.tombs is not None else np.zeros(len(t.keys), bool)
            for t in run])
        # np.unique keeps the FIRST occurrence → newest-wins shadowing
        # (a tombstone shadows older live rows of its key inside the run)
        uk, first_idx = np.unique(cat_k, return_index=True)
        uv, ut = cat_v[first_idx], cat_t[first_idx]
        # tombstone GC: a surviving tombstone is still needed only while an
        # OLDER run can physically hold its key; once nothing older remains,
        # the record — and the key — leave the store for good. DEFERRED for
        # tombstones an open snapshot still observes: dropping their record
        # here would mean the new generation forgets a deletion the pinned
        # readers still rely on seeing retained store-wide.
        gced = np.empty(0, dtype=np.uint64)
        if ut.any():
            tomb_keys = uk[ut]               # probe ONLY the tombstoned rows
            if tomb_shadowing is not None:
                assert len(tomb_shadowing) == len(tomb_keys)
                shadowing_t = tomb_shadowing
            else:
                shadowing_t = np.zeros(len(tomb_keys), dtype=bool)
                for t in tables[j + 1:]:
                    shadowing_t |= t.contains_many(tomb_keys)
            drop = np.zeros(len(uk), dtype=bool)
            drop[ut] = ~shadowing_t
            if drop.any() and self._snapshots:
                cand = uk[drop]
                visible = self._visible_to_any_snapshot(cand)
                if visible.any():
                    keep_idx = np.flatnonzero(drop)[visible]
                    drop[keep_idx] = False
                    self.stats.tombstones_gc_deferred += int(visible.sum())
                    with self._mu:
                        self._gc_pending = True
            if drop.any():
                gced = uk[drop]
                self.stats.tombstones_gced += int(drop.sum())
                uk, uv, ut = uk[~drop], uv[~drop], ut[~drop]
        if not len(uk):
            # the whole run was GC-able tombstones — drop the tables outright
            tables = tables[:i] + tables[j + 1:]
            filters = filters[:i] + filters[j + 1:]
            self._compact_count += 1
            self.stats.compactions += 1
            return tables, filters
        merged = SSTable(uk, uv, ut if ut.any() else None)
        others = tables[:i] + tables[j + 1:]
        other_keys = (np.concatenate([t.keys for t in others])
                      if others else np.empty(0, np.uint64))
        # a merged live row may still be shadowed by a tombstone in a NEWER
        # table (outside the run): it must not enroll as a positive, or the
        # first-hit probe would resurrect the deleted key from this table
        shadowed = np.zeros(len(uk), dtype=bool)
        for t in tables[:i]:
            if t.tombs is not None and t.tombs.any():
                shadowed |= _in_sorted(t.keys[t.tombs], uk)
        live_mask = ~ut & ~shadowed
        # fresh filter, exact over the WHOLE current universe: unlike flush
        # (older keys at build + online exclusions later), every other
        # table already exists, so its keys all land in the negative set.
        # Dead rows = own tombstones + newer-tombstoned live rows; the
        # just-GC'd keys ride along as negatives-only.
        f = self._build_filter(uk[live_mask], uk[~live_mask], other_keys,
                               self._compact_seeds(), gone_keys=gced)
        tables = tables[:i] + [merged] + tables[j + 1:]
        filters = filters[:i] + [f] + filters[j + 1:]
        self._compact_count += 1
        self.stats.compactions += 1
        return tables, filters

    def _compact_all(self, tables: list, filters: list) -> tuple[list, list]:
        while True:
            run = self._find_run(tables)
            if run is None:
                return tables, filters
            tables, filters = self._merge_run(tables, filters, *run)

    def compact(self) -> None:
        """Run size-tiered compaction to a fixed point against a PRIVATE
        copy of the table/filter lists, then publish the result as ONE new
        generation — the single swap point shared with flush. A scan or
        probe stream that started (or a snapshot that was pinned) before
        this call keeps resolving against the pre-compaction generation.
        Serialized with flushes and the background compactor under the
        mutator lock."""
        with self._wl:
            tables, filters = self._compact_all(list(self.sstables),
                                                list(self.filters))
            self.sstables, self.filters = tables, filters
            self._publish()

    # ---------------------------------------------------- generation publish
    def _publish(self) -> None:
        """THE one swap point: pack the build-side (sstables, filters) into
        a new immutable ``Generation`` and install it with a single
        reference assignment under the small lock (the bank prep runs
        before it, outside any reader-visible state). The FilterService
        refresh is double-buffered — in place (``refresh_tables``) when
        every layout is unchanged (Othello exclusions that did not resize),
        prepare+publish (``rebuild``) on structural change — and in either
        case the PREVIOUS generation keeps its own frozen buffers, so
        pinned snapshots and in-flight probe streams are never torn.
        Installing notifies admission-stalled writers; hooks run after the
        swap, failure-isolated (``_run_publish_hooks``)."""
        tables_bs, filters_bs = self.sstables, self.filters
        live = [f for f in filters_bs if f is not None]
        bank_state = None
        if not live:
            self.service = None
            chains = tuple(("always",) for _ in tables_bs)
            tables = np.zeros(TABLE_ALIGN, dtype=np.uint32)
        else:
            if len(live) != len(tables_bs):
                raise RuntimeError("mixed filtered/filterless tables unsupported")
            if self.service is None:
                self.service = FilterService(live, device=self.device,
                                             mesh=self.mesh)
            elif len(live) != self.service.bank.n_filters:
                # filter added/removed: layouts certainly changed — skip the
                # refresh_tables attempt (it would pack the whole bank once
                # just to find out)
                self.service.rebuild(live)
            else:
                try:
                    self.service.refresh_tables(live)
                except ValueError:
                    self.service.rebuild(live)
            bank_state = self.service.state
            chains = tuple(_chain_descriptor(lay)
                           for lay in bank_state.bank.layouts)
            tables = bank_state.bank.tables
        gen = Generation.create(
            self._next_gen_id, tables_bs, chains, tables, bank_state,
            sum(f.bits for f in live), device=self.device)
        with self._mu:
            self._gen = gen
            self._next_gen_id += 1
            self.stats.generations_published += 1
            self._stall_cv.notify_all()   # headroom may have appeared
        self._run_publish_hooks(gen)

    def _run_publish_hooks(self, gen: Generation) -> None:
        """Run every publish hook against the just-installed generation,
        isolating failures: a raising hook no longer aborts the hooks after
        it (which left later tag banks serving a stale generation). All
        failures are collected, counted in ``stats.publish_hook_errors``
        and re-raised together as ``PublishHookError`` AFTER the last hook
        ran — the store itself is already consistent at that point."""
        errors = []
        for hook in list(self._on_publish):
            try:
                hook(self, gen)
            except Exception as exc:
                errors.append((hook, exc))
                self.stats.publish_hook_errors += 1
        if errors:
            raise PublishHookError(errors)

    def add_publish_hook(self, hook) -> None:
        """Register ``hook(store, generation)`` to run after EVERY publish
        (flush / compact / deferred-GC sweep), with the new generation
        already installed. Secondary indexes enroll here: one hook call per
        swap means a tag bank can never lag the generation it serves."""
        self._on_publish.append(hook)

    def remove_publish_hook(self, hook) -> None:
        self._on_publish.remove(hook)

    @property
    def generation(self) -> Generation:
        """The currently published immutable read state."""
        return self._gen

    @property
    def _chains(self) -> tuple:
        return self._gen.chains

    @property
    def _tables_dev(self):
        return self._gen.tables_dev

    # -------------------------------------------------------------- snapshots
    def snapshot(self) -> Snapshot:
        """Open a pinned point-in-time read handle: the current generation
        (refcounted — compaction may neither mutate nor free its tables)
        plus a frozen copy of the memtable. Close it (or use ``with``) to
        release; GC of tombstones the snapshot still observes is deferred
        until then. Atomic under the small lock: the frozen memtable image
        (any in-flight flushing run folded underneath, memtable newer) and
        the pinned generation are one consistent cut."""
        with self._mu:
            if self._fl_keys is not None and len(self._fl_keys):
                cat_k = np.concatenate([self._mt_keys, self._fl_keys])
                cat_v = np.concatenate([self._mt_vals, self._fl_vals])
                cat_t = np.concatenate([self._mt_tombs, self._fl_tombs])
                mt_k, fi = np.unique(cat_k, return_index=True)
                mt_v, mt_t = cat_v[fi], cat_t[fi]
            else:
                mt_k, mt_v, mt_t = (self._mt_keys.copy(),
                                    self._mt_vals.copy(),
                                    self._mt_tombs.copy())
            for a in (mt_k, mt_v, mt_t):
                a.setflags(write=False)
            snap = Snapshot(self, self._gen, mt_k, mt_v, mt_t)
            self._snapshots.append(snap)
            gid = self._gen.gen_id
            self._pinned[gid] = self._pinned.get(gid, 0) + 1
            self.stats.snapshots_opened += 1
        return snap

    @property
    def open_snapshots(self) -> int:
        with self._mu:
            return len(self._snapshots)

    @property
    def pinned_generations(self) -> dict:
        """{gen_id: open-snapshot refcount} — empty when nothing is pinned."""
        with self._mu:
            return dict(self._pinned)

    def _release(self, snap: Snapshot) -> None:
        """Snapshot close path (idempotent, thread-safe — the closed
        check-and-set happens HERE under the small lock, so racing closers
        release exactly once): drop the pin and, once the LAST snapshot is
        gone, collect tombstones whose GC compaction deferred — inline in
        foreground mode, delegated to the background compactor when one is
        running (a reader thread closing a snapshot must not inherit a
        compaction under the mutator lock)."""
        with self._mu:
            if snap.closed:
                return
            snap.closed = True
            self._snapshots.remove(snap)
            self.stats.snapshots_closed += 1
            gid = snap.gen.gen_id
            self._pinned[gid] -= 1
            if not self._pinned[gid]:
                del self._pinned[gid]
            sweep = self._gc_pending and not self._snapshots
        if not sweep:
            return
        bg = self._bg
        if bg is not None and bg.running:
            bg.kick()
        else:
            with self._wl:
                self._collect_deferred()

    def _visible_to_any_snapshot(self, keys: np.ndarray) -> np.ndarray:
        """bool [n]: some open snapshot's newest record for the key is a
        tombstone (its GC must be deferred until that snapshot releases)."""
        vis = np.zeros(len(keys), dtype=bool)
        with self._mu:
            snaps = list(self._snapshots)
        for s in snaps:
            vis |= s.sees_tombstone(keys)
            if vis.all():
                break
        return vis

    def _collect_deferred(self) -> None:
        """Last snapshot released: rewrite (single-table merge) every table
        still carrying now-GC-able tombstones, then publish ONE new
        generation for the whole sweep. Caller holds the mutator lock."""
        with self._mu:
            if not self._gc_pending or self._snapshots:
                return                    # a snapshot re-opened: defer again
            self._gc_pending = False
        tables, filters = list(self.sstables), list(self.filters)
        i, changed = 0, False
        while i < len(tables):
            t = tables[i]
            if t.tombs is not None and t.tombs.any():
                tomb_keys = t.keys[t.tombs]
                shadowing = np.zeros(len(tomb_keys), dtype=bool)
                for o in tables[i + 1:]:
                    shadowing |= o.contains_many(tomb_keys)
                if not shadowing.all():
                    n_before = len(tables)
                    tables, filters = self._merge_run(
                        tables, filters, i, i, tomb_shadowing=shadowing)
                    changed = True
                    if len(tables) < n_before:
                        continue      # the table was all GC-able tombstones
            i += 1
        if changed:
            self.sstables, self.filters = tables, filters
            self._publish()

    # -------------------------------------------------------------- read path
    def probe_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Fused probe of every SSTable filter of the CURRENT generation for
        the whole batch in ONE kernel launch -> (first_hit int32 [n] ∈
        [0, N], hits_mask int32 [n]); first_hit == N means no filter fired."""
        return self._gen.probe_batch(keys)

    def _resolve_chained(self, stats, sstables, keys, first, found, vals,
                         reads, idx):
        """Chain rule (Fig 11b): read ONLY the newest-first first hit; a miss
        there proves every other fired filter is a false positive too.
        Tombstone records never fire chained filters (they are excluded at
        build and by ``exclude_deleted``), but a read landing on one is
        still resolved as a miss — the key is deleted."""
        n_tables = len(sstables)
        hit = first < n_tables
        reads[idx[hit]] = 1
        for t in np.unique(first[hit]):
            sel = first == t
            live, v, _dead = sstables[int(t)].get_many(keys[sel])
            found[idx[sel]] = live
            vals[idx[sel]] = v
        stats.sstable_reads += int(hit.sum())
        stats.wasted_reads += int(hit.sum() - found[idx].sum())

    def _resolve_masked(self, stats, sstables, keys, mask, found, vals,
                        reads, idx):
        """Baseline policy (per-table Bloom / no filter): read EVERY fired
        table newest→oldest until the key's newest record turns up — live
        (found) or tombstone (deleted; STOP, older versions are shadowed)."""
        alive = np.ones(len(keys), dtype=bool)
        for t in range(len(sstables)):
            cand = alive & (((mask >> t) & 1) == 1)
            if not cand.any():
                continue
            reads[idx[cand]] += 1
            stats.sstable_reads += int(cand.sum())
            live, v, dead = sstables[t].get_many(keys[cand])
            hit_idx = idx[cand][live]
            found[hit_idx] = True
            vals[hit_idx] = v[live]
            resolved = live | dead
            stats.wasted_reads += int((~live).sum())
            alive[cand] &= ~resolved

    @staticmethod
    def _overlay_resolve(mt_keys, mt_vals, mt_tombs, keys, found, vals,
                         resolved, stats: StoreStats) -> None:
        """Resolve a key batch against ONE sorted (keys, vals, tombs)
        overlay run, in place. Entries a NEWER overlay already resolved are
        skipped (newest wins); a tombstone RESOLVES its key (deleted, 0
        reads) — it must not fall through to the SSTables, whose stale
        versions it shadows; live hits resolve as found."""
        if not len(mt_keys):
            return
        pos = np.minimum(np.searchsorted(mt_keys, keys), len(mt_keys) - 1)
        inmem = (mt_keys[pos] == keys) & ~resolved
        live = inmem & ~mt_tombs[pos]
        vals[live] = mt_vals[pos[live]]
        found |= live
        resolved |= inmem
        stats.memtable_hits += int(inmem.sum())

    def _gen_resolve(self, gen: Generation, keys, found, vals, reads,
                     resolved, stats: StoreStats) -> None:
        """Resolve the overlay leftovers against one immutable generation:
        ONE fused probe launch, then the policy resolver. Lock-free — the
        generation's buffers are frozen at publish."""
        rest = ~resolved
        if not rest.any() or not gen.sstables:
            return
        idx = np.flatnonzero(rest)
        sub = keys[idx]
        stats.probed += len(sub)
        first, mask = gen.probe_batch(sub)
        if self.filter_kind == "chained":
            self._resolve_chained(stats, gen.sstables, sub, first, found,
                                  vals, reads, idx)
        else:
            self._resolve_masked(stats, gen.sstables, sub, mask, found,
                                 vals, reads, idx)

    def _view_get_batch(self, gen: Generation, mt_keys, mt_vals, mt_tombs,
                        keys: np.ndarray, stats: StoreStats
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched point queries against ONE (generation, frozen memtable
        image) view — the resolution path for snapshot reads (pinned
        generation + frozen copy, accounted in ``self.snap_stats``) and
        white-box single-view probes. Live reads go through ``get_batch``,
        which overlays the mutable memtable (and any flushing run) under
        the small lock first."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        found = np.zeros(n, dtype=bool)
        vals = np.zeros(n, dtype=np.uint64)
        reads = np.zeros(n, dtype=np.int32)
        stats.gets += n
        if n == 0:
            return found, vals, reads
        resolved = np.zeros(n, dtype=bool)
        self._overlay_resolve(mt_keys, mt_vals, mt_tombs, keys, found, vals,
                              resolved, stats)
        self._gen_resolve(gen, keys, found, vals, reads, resolved, stats)
        return found, vals, reads

    def get_batch(self, keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched point queries -> (found bool [n], values uint64 [n],
        sstable_reads int32 [n]). Memtable hits cost 0 reads; with chained
        filters every other key costs ≤ 1 read (found or wasted). The
        overlay resolution (memtable → flushing run, newest wins) completes
        under the small lock — the in-place memtable merge can therefore
        never tear it — and the generation is captured in the same critical
        section, so a publish racing this call can never tear the probe
        across two bank versions; the probe itself runs lock-free against
        the captured generation's frozen buffers."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        found = np.zeros(n, dtype=bool)
        vals = np.zeros(n, dtype=np.uint64)
        reads = np.zeros(n, dtype=np.int32)
        resolved = np.zeros(n, dtype=bool)
        with self._mu:
            gen = self._gen
            self.stats.gets += n
            if n:
                self._overlay_resolve(self._mt_keys, self._mt_vals,
                                      self._mt_tombs, keys, found, vals,
                                      resolved, self.stats)
                if self._fl_keys is not None:
                    self._overlay_resolve(self._fl_keys, self._fl_vals,
                                          self._fl_tombs, keys, found, vals,
                                          resolved, self.stats)
        if n:
            self._gen_resolve(gen, keys, found, vals, reads, resolved,
                              self.stats)
        return found, vals, reads

    def get(self, key: int) -> tuple[bool, int, int]:
        """(found, value, reads) for one key."""
        f, v, r = self.get_batch(np.array([key], np.uint64))
        return bool(f[0]), int(v[0]), int(r[0])

    # -------------------------------------------------------------- range scan
    @staticmethod
    def _check_scan_bounds(lo: int, hi: int) -> tuple[int, int]:
        lo_u, hi_u = int(lo), int(hi)
        if not (0 <= lo_u < 2 ** 64 and 0 <= hi_u <= 2 ** 64):
            raise ValueError("scan bounds: 0 <= lo < 2**64, 0 <= hi <= 2**64")
        return lo_u, hi_u

    def _scan_merge(self, gen: Generation, parts_k, parts_v, parts_t,
                    lo_u: int, hi_u: int, stats: StoreStats
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Slice every overlapping SSTable of ``gen`` (min/max fence
        pruning) behind the overlay parts already collected (newest first),
        then one ``np.unique`` newest-wins merge with tombstone masking.
        Lock-free — the generation and its tables are immutable."""
        if lo_u < hi_u:
            for t in gen.sstables:                        # newest → oldest
                if not t.overlaps_range(lo_u, hi_u):
                    stats.scan_tables_pruned += 1
                    continue
                stats.scan_tables_read += 1
                ks, vs, ts = t.slice_range(lo_u, hi_u)
                parts_k.append(ks)
                parts_v.append(vs)
                parts_t.append(ts)
        if not parts_k:
            return np.empty(0, np.uint64), np.empty(0, np.uint64)
        cat_k = np.concatenate(parts_k)
        uk, first_idx = np.unique(cat_k, return_index=True)
        live = ~np.concatenate(parts_t)[first_idx]
        return uk[live], np.concatenate(parts_v)[first_idx][live]

    def _view_scan(self, gen: Generation, mt_keys, mt_vals, mt_tombs,
                   lo: int, hi: int, stats: StoreStats
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Full-window k-way merge against ONE (generation, frozen memtable
        image) view — the snapshot scan path."""
        lo_u, hi_u = self._check_scan_bounds(lo, hi)
        stats.scans += 1
        parts_k, parts_v, parts_t = [], [], []
        if lo_u < hi_u and len(mt_keys):
            # the memtable IS a sorted run — reuse the SSTable slicer
            # (single home for the window-boundary logic, 2**64 incl.)
            mt = SSTable(mt_keys, mt_vals, mt_tombs)
            ks, vs, ts = mt.slice_range(lo_u, hi_u)
            if len(ks):
                parts_k.append(ks)
                parts_v.append(vs)
                parts_t.append(ts)
        return self._scan_merge(gen, parts_k, parts_v, parts_t, lo_u, hi_u,
                                stats)

    def scan(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Range scan over the half-open window ``[lo, hi)`` -> (keys
        ascending uint64 [m], values uint64 [m]), live records only.
        ``hi`` may be 2**64, so ``scan(0, 2**64)`` covers the whole key
        space including the maximum uint64 key.

        K-way merge across memtable (+ any in-flight flushing run) + every
        SSTable of the CURRENT generation with newest-wins / tombstone
        masking: sources concatenate newest-first and one ``np.unique``
        (keeps the FIRST = newest record per key) resolves shadowing, then
        tombstoned survivors drop out. Filters cannot prune a range — a
        window is not a key — but each sorted run's min/max fences can:
        tables whose span misses the window are never sliced. The overlay
        slices are cut (and, for the mutable memtable, copied) under the
        small lock in the same critical section that captures the
        generation; the table merge itself runs lock-free."""
        lo_u, hi_u = self._check_scan_bounds(lo, hi)
        parts_k, parts_v, parts_t = [], [], []
        with self._mu:
            gen = self._gen
            self.stats.scans += 1
            if lo_u < hi_u:
                if len(self._mt_keys):
                    mt = SSTable(self._mt_keys, self._mt_vals, self._mt_tombs)
                    ks, vs, ts = mt.slice_range(lo_u, hi_u)
                    if len(ks):
                        # copies: slice_range returns views and the in-place
                        # memtable merge may mutate the backing arrays the
                        # moment the lock drops
                        parts_k.append(ks.copy())
                        parts_v.append(vs.copy())
                        parts_t.append(ts.copy())
                if self._fl_keys is not None and len(self._fl_keys):
                    fl = SSTable(self._fl_keys, self._fl_vals, self._fl_tombs)
                    ks, vs, ts = fl.slice_range(lo_u, hi_u)
                    if len(ks):       # flushing arrays are frozen: no copy
                        parts_k.append(ks)
                        parts_v.append(vs)
                        parts_t.append(ts)
        return self._scan_merge(gen, parts_k, parts_v, parts_t, lo_u, hi_u,
                                self.stats)

    def _view_scan_iter(self, gen: Generation, mt_keys, mt_vals, mt_tombs,
                        lo: int, hi: int, page_size: int, stats: StoreStats):
        """Lazy paged k-way merge against ONE pinned view (bounds validated
        EAGERLY; this is a plain function returning the page generator, so
        bad arguments fail at the call site, not at first iteration). Per
        page each overlapping source contributes at most ``page_size``
        physical records from the cursor position (``SSTable.slice_page``,
        the single home for the window-boundary logic); the page's emit
        bound is the smallest last-key among TRUNCATED slices, so every
        emitted key's newest-wins resolution is complete before it leaves
        the cursor. (Fence-prune accounting is left to full scans — a
        cursor re-visits sources once per page and would skew the gated
        prune fraction.)"""
        lo_u, hi_u = self._check_scan_bounds(lo, hi)
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        stats.scans += 1
        sources = []
        if len(mt_keys):
            sources.append(SSTable(mt_keys, mt_vals, mt_tombs))
        sources.extend(gen.sstables)                      # newest → oldest

        def pages():
            pos = lo_u
            while pos < hi_u:
                parts_k, parts_v, parts_t = [], [], []
                trunc_last = []
                for t in sources:
                    ks, vs, ts, trunc = t.slice_page(pos, hi_u, page_size)
                    if not len(ks):
                        continue
                    parts_k.append(ks)
                    parts_v.append(vs)
                    parts_t.append(ts)
                    if trunc is not None:
                        trunc_last.append(trunc)
                if not parts_k:
                    return
                bound = (hi_u if not trunc_last
                         else min(hi_u, min(trunc_last) + 1))
                cat_k = np.concatenate(parts_k)
                uk, first_idx = np.unique(cat_k, return_index=True)
                uv = np.concatenate(parts_v)[first_idx]
                keep = ~np.concatenate(parts_t)[first_idx]
                if bound < 2 ** 64:
                    keep &= uk < np.uint64(bound)
                if keep.any():
                    yield uk[keep], uv[keep]
                pos = bound

        return pages()

    def scan_iter(self, lo: int, hi: int, page_size: int = 4096
                  ) -> _ScanCursor:
        """Paged range-scan cursor over ``[lo, hi)``: an iterator of
        ``(keys, vals)`` pages pinned to a snapshot opened EAGERLY at call
        time (not at first iteration) — puts, deletes, flushes,
        compactions and rebuilds between the call and any page cannot
        change what the cursor yields; it finishes on its generation while
        newer ones publish. The pin releases on exhaustion, ``close()``
        (context-manager exit included), error, or — for an abandoned
        cursor — garbage collection."""
        snap = self.snapshot()
        try:
            inner = self._view_scan_iter(
                snap.gen, snap._mt_keys, snap._mt_vals, snap._mt_tombs,
                lo, hi, page_size, self.stats)
        except Exception:
            snap.close()
            raise
        return _ScanCursor(snap, inner)

    # ------------------------------------------------------- background service
    def start_background(self, poll_s: float = 0.02):
        """Start (or return) the background compaction service: a daemon
        thread running size-tiered merge runs and deferred-GC sweeps off
        the write path (``BackgroundCompactor`` driving
        ``_background_step``). While it runs, flushes skip inline
        compaction (the compactor owns it) and an over-``table_cap`` flush
        BLOCKS in admission control — bounded by ``stall_timeout_s``, then
        ``WriteStall`` — instead of failing outright. Idempotent; returns
        the (possibly already running) compactor."""
        from repro_torch.storage.compactor import BackgroundCompactor
        with self._mu:
            bg = self._bg
            if bg is not None and bg.running:
                return bg
            bg = BackgroundCompactor(self, poll_s=poll_s)
            self._bg = bg
        bg.start()
        return bg

    def stop_background(self, timeout_s: float = 10.0) -> None:
        """Stop the background compactor (no-op without one). Pending
        compaction debt stays on disk — drain it first with
        ``wait_compaction_idle`` if the test/benchmark needs a quiesced
        store."""
        bg = self._bg
        if bg is not None:
            bg.stop(timeout_s=timeout_s)

    @property
    def background_active(self) -> bool:
        bg = self._bg
        return bg is not None and bg.running

    @property
    def background_errors(self) -> list:
        """Exceptions recorded by the background compactor (publish-hook
        failures included) — empty without one / when all steps succeeded."""
        bg = self._bg
        return [] if bg is None else list(bg.errors)

    def _background_step(self) -> bool:
        """ONE unit of background work under the mutator lock — a deferred
        GC sweep if one is runnable, else a single merge run (size-tiered
        when one qualifies; at/over ``table_cap`` a forced oldest-pair
        merge guarantees headroom even when no run qualifies). Returns
        whether anything changed. One run per acquisition keeps the
        mutator-lock hold short, so flushes interleave between runs."""
        with self._wl:
            with self._mu:
                sweep = self._gc_pending and not self._snapshots
            if sweep:
                self._collect_deferred()
                self.stats.bg_gc_sweeps += 1
                return True
            tables, filters = list(self.sstables), list(self.filters)
            run = self._find_run(tables)
            if run is None:
                if len(tables) >= self.table_cap and len(tables) >= 2:
                    run = (len(tables) - 2, len(tables) - 1)
                else:
                    return False
            tables, filters = self._merge_run(tables, filters, *run)
            self.sstables, self.filters = tables, filters
            self.stats.bg_compactions += 1
            self._publish()
            return True

    def wait_compaction_idle(self, timeout_s: float = 30.0) -> bool:
        """Drain background work: returns True once no merge run qualifies,
        no forced merge is needed and no GC sweep is runnable (False on
        timeout). Without a running compactor the debt drains inline —
        the deterministic variant tests use."""
        bg = self._bg
        if bg is None or not bg.running:
            with self._wl:
                while self._background_step():
                    pass
            return True
        return bg.wait_idle(timeout_s)

    # ------------------------------------------------------------- accounting
    @property
    def n_tables(self) -> int:
        return len(self.sstables)

    @property
    def key_count(self) -> int:
        """Distinct LIVE keys across memtable (+ any in-flight flushing
        run) + SSTables: each key counts by its newest record, and a
        newest-record tombstone means gone."""
        with self._mu:
            parts_k = [self._mt_keys]
            parts_t = [self._mt_tombs.copy()]
            if self._fl_keys is not None:
                parts_k.append(self._fl_keys)
                parts_t.append(self._fl_tombs)
            tables = list(self.sstables)
        # a record may transiently sit in BOTH the flushing slot and the
        # newest table (publish installed, slot not yet cleared) — the
        # newest-wins unique below double-counts nothing
        parts_k += [t.keys for t in tables]
        parts_t += [
            t.tombs if t.tombs is not None else np.zeros(len(t.keys), bool)
            for t in tables]
        cat_k = np.concatenate(parts_k)
        if not len(cat_k):
            return 0
        uk, first_idx = np.unique(cat_k, return_index=True)
        return int((~np.concatenate(parts_t)[first_idx]).sum())

    @property
    def filter_bits(self) -> int:
        return sum(f.bits for f in list(self.filters) if f is not None)

    @property
    def pressure(self) -> dict:
        """Point-in-time admission-control gauges (cumulative counters live
        in ``stats``): table count vs cap, compaction debt (tables a
        pending size-tiered merge would remove), write queue depth
        (memtable + flushing records not yet in a published table), live
        stall waiters and whether a deferred-GC sweep is owed."""
        with self._mu:
            tables = list(self.sstables)
            fl = 0 if self._fl_keys is None else len(self._fl_keys)
            depth = len(self._mt_keys) + fl
            waiters = self._stall_waiters
            gc_pending = self._gc_pending
        run = self._find_run(tables)
        return {
            "n_tables": len(tables),
            "table_cap": self.table_cap,
            "compaction_debt": 0 if run is None else run[1] - run[0],
            "write_queue_depth": depth,
            "stall_waiters": waiters,
            "gc_pending": gc_pending,
        }
