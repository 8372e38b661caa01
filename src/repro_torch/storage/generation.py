"""Generation-tagged immutable read states + snapshot-pinned handles.

The paper's §5.4 LSM application treats the filter cascade as immutable
per query; static-function structures (Xor/Bloomier stage 1, Othello
stage 2 — Dietzfelbinger & Pagh; Graf & Lemire) are cheap to rebuild but
cannot be mutated mid-probe. Correctness under concurrent
compaction/rebuild therefore comes from **versioned immutable
generations**, not locks inside the kernels:

- ``Generation`` freezes one (SSTables, packed FilterBank buffer, probe
  params) triple under a monotonically increasing id. Every array is
  marked read-only at publish; the fused ``lsm_probe`` launch receives the
  generation's OWN device buffers, so probing an old generation after a
  newer one publishes is bit-identical to probing it before — and a probe
  can never observe a half-refreshed params array, because each
  generation's params lanes are packed exactly once.

- ``Snapshot`` pins a generation (refcounted through the owning
  ``LsmStore``) plus a frozen copy of the memtable, giving long-lived
  cursors and pagination a stable point-in-time view while flushes,
  compactions and bank rebuilds keep publishing newer generations
  underneath. Tombstones a snapshot can still observe are exempt from
  compaction GC until the snapshot releases (deferred GC — see
  ``LsmStore._merge_run`` / ``_collect_deferred``).

Lifecycle: ``store.snapshot()`` → pin → ``get_batch``/``scan``/
``scan_iter`` against the pinned state → ``close()`` (or context-manager
exit) → refcount release → deferred tombstone GC once the last snapshot
lets go.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.lsm import SSTable
from repro_torch.core.tables import TABLE_ALIGN
from repro_torch.kernels import common
from repro_torch.kernels.lsm_probe import (chain_descriptors, lsm_probe,
                                           pack_chain_params)


@dataclass(frozen=True)
class Generation:
    """One immutable published read state of an ``LsmStore``.

    Everything a batched read needs travels together: the newest-first
    SSTable tuple, the per-table probe descriptors, the packed uint32 bank
    buffer (host numpy + device int32 tensor of the same bits), the
    pre-packed per-table probe-param lanes (host, as the JAX package
    publishes them) and the kernel's table descriptors (device). ``bank_state`` keeps the
    ``FilterService.BankState`` this generation published; it is ``None``
    for filterless stores and the empty generation."""

    gen_id: int                  # monotonically increasing publish counter
    sstables: tuple              # newest first, frozen (arrays read-only)
    chains: tuple                # lsm_probe descriptors, newest first
    tables: np.ndarray           # packed uint32 bank buffer (read-only)
    tables_dev: torch.Tensor     # int32 device mirror of ``tables``
    params: np.ndarray           # pack_chain_params(chains) (read-only)
    desc_dev: torch.Tensor       # chain_descriptors(chains) on the device
    bank_state: object           # serving BankState | None
    filter_bits: int             # total filter bits at publish time

    @classmethod
    def create(cls, gen_id: int, sstables, chains, tables: np.ndarray,
               bank_state, filter_bits: int, *, device="cuda"
               ) -> "Generation":
        """Freeze (sstables, bank buffer, params) into a publishable
        generation: packs the probe-param lanes ONCE, marks every host
        array read-only, and mirrors the bank and the kernel's table
        descriptors onto ``device``. When a ``bank_state`` is supplied its
        device tensor of the same bank buffer is reused — one
        host-to-device copy per publish, not two."""
        device = common.as_device(device)
        chains = tuple(chains)
        params = pack_chain_params(chains)
        tables = np.ascontiguousarray(tables, dtype=np.uint32)
        tables.setflags(write=False)
        params.setflags(write=False)
        frozen = tuple(t.freeze() for t in sstables)
        desc_dev = torch.from_numpy(chain_descriptors(chains)).to(device)
        tables_dev = getattr(bank_state, "tables", None)
        if tables_dev is None:
            tables_dev = common.to_device(tables, device)
        return cls(gen_id=gen_id, sstables=frozen, chains=chains,
                   tables=tables, tables_dev=tables_dev, params=params,
                   desc_dev=desc_dev, bank_state=bank_state, filter_bits=int(filter_bits))

    @classmethod
    def from_numpy(cls, gen_id: int, sstables, chains, tables: np.ndarray,
                   filter_bits: int, *, device="cuda") -> "Generation":
        """A generation from plain arrays and tuples — e.g. what another
        package's store published: ``sstables`` as newest-first ``(keys,
        vals, tombs)`` triples (``vals``/``tombs`` may be None), ``chains``
        as ``lsm_probe`` descriptor tuples, ``tables`` the packed uint32
        bank. The arrays are copied."""
        ssts = [SSTable(np.array(k, dtype=np.uint64),
                        None if v is None else np.array(v, dtype=np.uint64),
                        None if t is None else np.array(t, dtype=bool))
                for k, v, t in sstables]
        return cls.create(gen_id, ssts, chains, np.array(tables, np.uint32),
                          None, filter_bits, device=device)

    @classmethod
    def empty(cls, gen_id: int = 0, *, device="cuda") -> "Generation":
        """The pre-first-flush generation: no tables, a zero bank."""
        return cls.create(gen_id, (), (),
                          np.zeros(TABLE_ALIGN, dtype=np.uint32), None, 0,
                          device=device)

    @property
    def n_tables(self) -> int:
        return len(self.sstables)

    def live_items(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys ascending uint64 [m], values uint64 [m]) — every LIVE
        record of this generation after newest-wins / tombstone masking."""
        if not self.sstables:
            return np.empty(0, np.uint64), np.empty(0, np.uint64)
        cat_k = np.concatenate([t.keys for t in self.sstables])  # newest 1st
        cat_v = np.concatenate([
            t.vals if t.vals is not None else np.zeros(len(t.keys), np.uint64)
            for t in self.sstables])
        cat_t = np.concatenate([
            t.tombs if t.tombs is not None else np.zeros(len(t.keys), bool)
            for t in self.sstables])
        uk, first_idx = np.unique(cat_k, return_index=True)
        live = ~cat_t[first_idx]
        return uk[live], cat_v[first_idx][live]

    def probe_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Fused probe of every SSTable filter of THIS generation for the
        whole key batch in ONE ``lsm_probe`` launch -> (first_hit int32 [n]
        ∈ [0, N], hits_mask int32 [n]); first_hit == N means no filter
        fired. Reads only the generation's own frozen buffers — probing an
        old generation after newer ones publish is bit-identical."""
        keys = np.asarray(keys, dtype=np.uint64)
        if not self.sstables:
            raise RuntimeError("no SSTables; flush first")
        hi, lo = common.key_lanes(keys, self.tables_dev.device)
        first, mask = lsm_probe(self.tables_dev, hi, lo, self.desc_dev,
                                chains=self.chains)
        both = torch.stack([first, mask]).cpu().numpy()   # one host pull
        return both[0], both[1]


class Snapshot:
    """Pinned point-in-time read handle: one generation + a frozen
    memtable image.

    ``get_batch``/``get``/``scan``/``scan_iter`` resolve against the
    pinned state only — flushes, compactions and bank rebuilds that
    publish newer generations are invisible. Close the snapshot (or use
    it as a context manager) to release the generation pin; the last
    release triggers collection of tombstones whose GC was deferred on
    this snapshot's behalf."""

    def __init__(self, store, gen: Generation, mt_keys: np.ndarray,
                 mt_vals: np.ndarray, mt_tombs: np.ndarray):
        self._store = store
        self.gen = gen
        self._mt_keys = mt_keys
        self._mt_vals = mt_vals
        self._mt_tombs = mt_tombs
        self.closed = False

    @property
    def gen_id(self) -> int:
        """The pinned generation's id — the cheap fence a multi-store query
        plan records at open time to prove no publish tore its view."""
        return self.gen.gen_id

    def memtable_probe(self, keys: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(inmem bool [n], live bool [n], values uint64 [n]) against the
        FROZEN memtable image only — the overlay half of the probe-only
        view API: a query stage consults this before the pinned
        generation's filter bank, because a memtable record (live or
        tombstone) shadows every generation-resident version of its key."""
        self._check_open()
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        inmem = np.zeros(n, dtype=bool)
        vals = np.zeros(n, dtype=np.uint64)
        if n and len(self._mt_keys):
            pos = np.minimum(np.searchsorted(self._mt_keys, keys),
                             len(self._mt_keys) - 1)
            inmem = self._mt_keys[pos] == keys
            live = inmem & ~self._mt_tombs[pos]
            vals[live] = self._mt_vals[pos[live]]
        else:
            live = np.zeros(n, dtype=bool)
        return inmem, live, vals

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release the generation pin (idempotent, thread-safe: the owning
        store performs the closed check-and-set under its small lock, so
        two racing closers release exactly once). After the store's last
        open snapshot closes, deferred tombstone GC runs — inline, or on
        the background compactor when one is active."""
        self._store._release(self)

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("snapshot is closed")

    # ------------------------------------------------------------- read path
    def get_batch(self, keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched point queries against the pinned state -> (found,
        values, sstable_reads) — same contract as ``LsmStore.get_batch``,
        including the chained ≤ 1-read bound (the pinned filters are exact
        over the pinned tables by construction). Accounted in the store's
        ``snap_stats``, never in the live-read ``stats``."""
        self._check_open()
        return self._store._view_get_batch(
            self.gen, self._mt_keys, self._mt_vals, self._mt_tombs, keys,
            self._store.snap_stats)

    def get(self, key: int) -> tuple[bool, int, int]:
        f, v, r = self.get_batch(np.array([key], np.uint64))
        return bool(f[0]), int(v[0]), int(r[0])

    def scan(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Range scan of the pinned state over ``[lo, hi)``."""
        self._check_open()
        return self._store._view_scan(
            self.gen, self._mt_keys, self._mt_vals, self._mt_tombs, lo, hi,
            self._store.snap_stats)

    def scan_iter(self, lo: int, hi: int, page_size: int = 4096):
        """Lazy paged scan of the pinned state: yields ``(keys, vals)``
        pages of at most ~``page_size`` physical records per source
        (bounds validated eagerly here, not at first iteration). Because
        every page resolves against the same pinned generation, compactions
        between pages cannot tear the cursor."""
        self._check_open()
        return self._store._view_scan_iter(
            self.gen, self._mt_keys, self._mt_vals, self._mt_tombs,
            lo, hi, page_size, self._store.snap_stats)

    # ----------------------------------------------------------- visibility
    def sees_tombstone(self, keys: np.ndarray) -> np.ndarray:
        """bool [n]: is this snapshot's newest physical record for each key
        a tombstone? (The deferred-GC visibility test: such a tombstone
        must survive compaction GC until this snapshot releases.)"""
        keys = np.asarray(keys, dtype=np.uint64)
        out = np.zeros(len(keys), dtype=bool)
        undecided = np.ones(len(keys), dtype=bool)
        sources = []
        if len(self._mt_keys):
            sources.append(SSTable(self._mt_keys, self._mt_vals,
                                   self._mt_tombs))
        sources.extend(self.gen.sstables)
        for t in sources:                                 # newest → oldest
            if not undecided.any():
                break
            live, _, dead = t.get_many(keys)
            out |= undecided & dead
            undecided &= ~(live | dead)
        return out
