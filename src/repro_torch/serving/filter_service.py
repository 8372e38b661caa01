"""Batched multi-filter probe engine: FilterBank + FilterService.

Paper mapping
-------------
- **§5.2 (shared address / locality).** The paper speeds up the two-stage
  ChainedFilter by making both stages' probes land in the same cache line.
  Here the same idea is lifted one level: ``FilterBank.pack`` flattens N
  heterogeneous filters into ONE 128-word-aligned uint32 buffer plus
  layout descriptors (core.tables), held on the card as one int32 tensor,
  so every probe kernel gathers from a single buffer that the card's L2
  keeps close.
- **§5.4 (LSM lookups).** An LSM store's bank holds one ``LsmChainLayout``
  per SSTable (or one ``BloomTable`` for the Bloom baseline); the service
  probes each filter with its kernel (``lsm_chain_probe`` /
  ``bloom_probe``) and reports the sequential probe count — 1 + stage-1
  pass for a chain — mirroring the paper's memory-access accounting
  (Fig. 7b).
- **§5.1–§5.3 (the paper's combiners).** Xor filters, exact Bloomiers,
  ChainedFilterAnd and ChainedFilterCascade banks are probed by
  ``xor_probe``, ``exact_probe``, ``chained_probe`` (both stages, probes
  = 1 + stage-1 pass) and ``cascade_probe`` (every layer and the
  first-zero parity rule in one launch, probes = min(first_zero, L)). A
  cascade's int32 layer descriptor, and the narrow planes (the low α bits
  of each slot) of the Xor, exact and ChainedFilterAnd tables that the
  Bloomier kernels' on-chip path reads, are built once per published
  ``BankState`` from its contents, not per probe.

The service runs on one device. The JAX package splits key rows across
devices with ``shard_map``; a multi-GPU row split is still to be ported
(ROADMAP).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.bloomier import ExactBloomier, XorFilter
from repro_torch.core.chained import ChainedFilterAnd, ChainedFilterCascade
from repro_torch.core.lsm import ChainedTableFilter
from repro_torch.core.othello import DynamicExactFilter
from repro_torch.core.tables import (BloomTable, XorTable, ExactTable,
                                     OthelloTable, ChainedAndLayout,
                                     CascadeLayout, LsmChainLayout,
                                     concat_tables)
from repro_torch.kernels import bloomier_onchip, common
from repro_torch.kernels.bloom_probe import bloom_probe
from repro_torch.kernels.cascade_probe import cascade_descriptors, cascade_probe
from repro_torch.kernels.chained_probe import chained_probe
from repro_torch.kernels.lsm_probe import lsm_chain_probe, othello_hit
from repro_torch.kernels.ops import chained_and_params
from repro_torch.kernels.xor_probe import exact_probe, xor_probe

_LAYOUT_TO_CLASS = {
    BloomTable: BloomFilter,
    XorTable: XorFilter,
    ExactTable: ExactBloomier,
    OthelloTable: DynamicExactFilter,
    ChainedAndLayout: ChainedFilterAnd,
    CascadeLayout: ChainedFilterCascade,
    LsmChainLayout: ChainedTableFilter,
}


# ---------------------------------------------------------------------------
# FilterBank — N heterogeneous filters in one packed buffer
# ---------------------------------------------------------------------------

@dataclass
class FilterBank:
    tables: np.ndarray                  # uint32 [W], 128-word aligned
    layouts: tuple                      # one FilterLayout per filter

    @classmethod
    def pack(cls, filters: list) -> "FilterBank":
        tables, layouts = concat_tables([f.to_tables() for f in filters])
        return cls(tables=tables, layouts=layouts)

    def unpack(self) -> list:
        """Reconstruct the filter objects (bit-identical query behaviour)."""
        out = []
        for lay in self.layouts:
            klass = _LAYOUT_TO_CLASS[type(lay)]
            out.append(klass.from_tables(self.tables, lay))
        return out

    @property
    def n_filters(self) -> int:
        return len(self.layouts)

    @property
    def nbytes(self) -> int:
        return self.tables.nbytes


# ---------------------------------------------------------------------------
# per-layout dispatch
# ---------------------------------------------------------------------------

def layout_descriptors(layouts: tuple, device) -> tuple:
    """The device-side descriptor each layout's kernel takes, aligned with
    ``layouts``: int32 [L, 4] layer descriptors for a cascade, None for a
    layout whose kernel takes its fields as arguments."""
    return tuple(
        torch.from_numpy(cascade_descriptors(lay.probe_params())).to(device)
        if isinstance(lay, CascadeLayout) else None for lay in layouts)


def _table(lay) -> tuple:
    return (lay.mode, lay.seed, lay.seg_len, lay.n_seg, lay.offset)


def _stage_planes(tables, stages: tuple) -> tuple | None:
    """The planes of (layout, α) stages, or None where one has none."""
    if any(bloomier_onchip.field_width(a) is None for _, a in stages):
        return None
    return tuple(bloomier_onchip.pack_plane(tables, _table(t), a)
                 for t, a in stages)


def layout_planes(layouts: tuple, tables: torch.Tensor) -> tuple:
    """The narrow planes (``bloomier_onchip.pack_plane``) each layout's
    Bloomier kernel reads from the device bank ``tables``, aligned with
    ``layouts``: a tuple of one plane a stage for an Xor (α ≤ 16), exact
    or ChainedFilterAnd table, None for any other. Planes hold table
    contents: a bank with new contents needs new planes."""
    out = []
    for lay in layouts:
        if isinstance(lay, XorTable):
            out.append(_stage_planes(tables, ((lay, lay.alpha),)))
        elif isinstance(lay, ExactTable):
            out.append(_stage_planes(tables, ((lay, 1),)))
        elif isinstance(lay, ChainedAndLayout):
            stages = ((lay.exact, 1),) if lay.xor is None else (
                (lay.xor, lay.xor.alpha), (lay.exact, 1))
            out.append(_stage_planes(tables, stages))
        else:
            out.append(None)
    return tuple(out)


def _probe_one(tables, hi, lo, lay, desc, planes=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (member, probes) int32 of hi's shape for one filter layout;
    ``desc`` is its ``layout_descriptors`` entry, ``planes`` its
    ``layout_planes`` entry."""
    if isinstance(lay, BloomTable):
        m = bloom_probe(tables, hi, lo, m_bits=lay.m_bits, k=lay.k,
                        seed=lay.seed, offset=lay.offset)
        return m, torch.ones_like(m)
    if isinstance(lay, XorTable):
        m = xor_probe(tables, hi, lo, mode=lay.mode, seed=lay.seed,
                      seg_len=lay.seg_len, n_seg=lay.n_seg, alpha=lay.alpha,
                      fp_seed=lay.fp_seed, offset=lay.offset,
                      plane=None if planes is None else planes[0])
        return m, torch.ones_like(m)
    if isinstance(lay, ExactTable):
        m = exact_probe(tables, hi, lo, mode=lay.mode, seed=lay.seed,
                        seg_len=lay.seg_len, n_seg=lay.n_seg,
                        strategy=lay.strategy, bit_seed=lay.bit_seed,
                        offset=lay.offset,
                        plane=None if planes is None else planes[0])
        return m, torch.ones_like(m)
    if isinstance(lay, OthelloTable):
        m = othello_hit(tables, hi, lo, ma=lay.ma, mb=lay.mb, seed=lay.seed,
                        offset_a=lay.offset,
                        offset_b=lay.offset_b).to(torch.int32)
        return m, torch.ones_like(m)
    if isinstance(lay, LsmChainLayout):
        return lsm_chain_probe(tables, hi, lo, chain=lay.probe_params())
    if isinstance(lay, ChainedAndLayout):
        return chained_probe(tables, hi, lo, **chained_and_params(lay),
                             planes=planes)
    if isinstance(lay, CascadeLayout):
        return cascade_probe(tables, hi, lo, desc, layers=lay.probe_params())
    raise TypeError(f"unknown filter layout {type(lay).__name__}")


def bank_probe(tables, hi, lo, *, layouts: tuple, descs: tuple,
               planes: tuple | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe every filter in the bank on one key batch; ``descs`` are the
    layouts' ``layout_descriptors`` on the bank's device, ``planes`` their
    ``layout_planes`` of this bank (None: packed per call where a probe
    takes the on-chip path). -> (member, probes) int32 [F, *hi.shape]."""
    members, probes = [], []
    planes = (None,) * len(layouts) if planes is None else planes
    for lay, desc, pl in zip(layouts, descs, planes):
        m, p = _probe_one(tables, hi, lo, lay, desc, pl)
        members.append(m)
        probes.append(p)
    return torch.stack(members), torch.stack(probes)


# ---------------------------------------------------------------------------
# FilterService — batched query streams, double-buffered
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BankState:
    """One immutable published bank version: the packed buffer, its
    layouts, its device tensor and the device buffers derived from them,
    swapped as a UNIT. A reader that
    captured a ``BankState`` keeps probing it bit-identically no matter how
    many newer versions publish after it."""

    bank: FilterBank
    tables: torch.Tensor               # int32 [W] on the service's device
    version: int                       # monotonically increasing
    descs: tuple                       # layout_descriptors(bank.layouts)
    planes: tuple                      # layout_planes(bank.layouts, tables)

    @property
    def n_filters(self) -> int:
        return self.bank.n_filters


@dataclass
class ServiceStats:
    lookups: int = 0
    hits: np.ndarray = None            # int64 [F]
    probes: np.ndarray = None          # int64 [F] — sequential probe count

    def as_dict(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits.tolist(),
            "hit_rate": [h / max(1, self.lookups) for h in self.hits],
            "avg_probes": [p / max(1, self.lookups) for p in self.probes],
        }


class FilterService:
    """Serve batched membership queries against a packed FilterBank on one
    device (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain
    versions).

    ``probe(keys)`` evaluates every filter in the bank on the whole key
    batch. The service is **double-buffered**: the complete read state
    (packed buffer + layouts + device tensor) lives in one immutable
    ``BankState``, and ``rebuild`` = ``prepare`` (build the new bank while
    the old state stays probe-able) + ``publish`` (ONE reference swap)."""

    def __init__(self, filters: list, *, device="cuda"):
        self.device = common.as_device(device)
        # guards the (state, stats) PAIR: publishes swap both, and a probe
        # must attribute its counts to the version it actually probed even
        # when a background rebuild lands mid-call (always-on store)
        self._swap_lock = threading.Lock()
        self._state: BankState | None = None
        self.publish(self.prepare(filters))

    # -- double-buffered bank states -----------------------------------------
    @property
    def state(self) -> BankState:
        """The currently published BankState. Capture it to keep probing
        this exact bank version across later rebuilds (``probe(keys,
        state=captured)``)."""
        return self._state

    @property
    def version(self) -> int:
        return self._state.version if self._state is not None else -1

    @property
    def bank(self) -> FilterBank:
        return self._state.bank

    def prepare(self, filters: list, *, warm: bool = False) -> BankState:
        """Build the NEXT bank version off to the side while the published
        state keeps serving. With ``warm=True`` the bank is probed once on a
        dummy key block, which builds the kernels it needs, so the first
        probe after ``publish`` pays no build stall. Nothing is visible to
        readers until ``publish``."""
        bank = FilterBank.pack(filters)
        bank.tables.setflags(write=False)      # immutable once staged
        tables = common.to_device(bank.tables, self.device)
        descs = layout_descriptors(bank.layouts, self.device)
        planes = layout_planes(bank.layouts, tables)
        if warm:
            z = torch.zeros(common.BLOCK, dtype=torch.int32, device=self.device)
            bank_probe(tables, z, z, layouts=bank.layouts, descs=descs,
                       planes=planes)
        return BankState(bank=bank, tables=tables, version=self.version + 1,
                         descs=descs, planes=planes)

    def publish(self, state: BankState) -> None:
        """Atomically install a staged state as the serving bank — the
        (state, stats) pair swaps under one small lock; in-flight readers
        that captured the previous state finish against it. Stats reset
        (the caller owns cross-version accounting)."""
        stats = ServiceStats(
            hits=np.zeros(state.bank.n_filters, np.int64),
            probes=np.zeros(state.bank.n_filters, np.int64))
        with self._swap_lock:
            self._state = state
            self.stats = stats

    # -- batched probing -----------------------------------------------------
    def probe(self, keys: np.ndarray, state: BankState | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
        """-> (member bool [F, n], probes int32 [F, n]) for n keys across
        the bank's F filters; updates hit/probe stats. Pass a captured
        ``state`` to probe an OLDER published bank version bit-identically
        (stats are left untouched for non-current states)."""
        with self._swap_lock:              # capture the PAIR coherently
            cur_state = self._state
            cur_stats = self.stats
        current = state is None or state is cur_state
        if state is None:
            state = cur_state
        n = len(keys)
        if n == 0:
            shape = (state.n_filters, 0)
            return np.zeros(shape, bool), np.zeros(shape, np.int32)
        hi, lo = common.key_lanes(keys, self.device)
        member, probes = bank_probe(state.tables, hi, lo,
                                    layouts=state.bank.layouts,
                                    descs=state.descs, planes=state.planes)
        member = member.cpu().numpy().astype(bool)
        probes = probes.cpu().numpy()
        if current:
            with self._swap_lock:
                cur_stats.lookups += n
                cur_stats.hits += member.sum(axis=1)
                cur_stats.probes += probes.sum(axis=1)
        return member, probes

    def probe_filter(self, index: int, keys: np.ndarray) -> np.ndarray:
        """Membership for ONE filter of the bank -> bool [n]. Dispatches only
        that filter's kernel and leaves the aggregate stats untouched."""
        if len(keys) == 0:
            return np.zeros(0, bool)
        state = self._state
        hi, lo = common.key_lanes(keys, self.device)
        member, _ = _probe_one(state.tables, hi, lo, state.bank.layouts[index],
                               state.descs[index], state.planes[index])
        return member.cpu().numpy().astype(bool)

    def refresh_tables(self, filters: list) -> None:
        """Re-pack mutated filter contents into a NEW published state. Valid
        only while every filter's layout (sizes, seeds, offsets) is
        unchanged — e.g. Bloom bit-flips from inserts or Othello exclusions
        that did not resize. Packing calls each filter's ``to_tables``,
        which is where batched Othello exclusions materialize their lazily
        flipped components. The previous state's buffer is never touched:
        readers pinned to it keep probing the old contents. The layouts'
        device descriptors carry over; the narrow planes hold contents and
        are packed anew from the new buffer. Stats are kept (content-only
        refresh)."""
        old = self._state
        bank = FilterBank.pack(filters)
        if bank.layouts != old.bank.layouts:
            raise ValueError("filter layouts changed; build a new FilterService")
        bank.tables.setflags(write=False)
        tables = common.to_device(bank.tables, self.device)
        state = BankState(bank=bank, tables=tables, version=old.version + 1,
                          descs=old.descs,
                          planes=layout_planes(bank.layouts, tables))
        with self._swap_lock:
            self._state = state

    def rebuild(self, filters: list, *, warm: bool = False) -> None:
        """Structural refresh (filters added/removed/resized), double-
        buffered: ``prepare`` builds the next state while the published one
        keeps serving, then ``publish`` swaps one reference. Stats reset."""
        self.publish(self.prepare(filters, warm=warm))

    def unpack(self) -> list:
        return self.bank.unpack()


# ---------------------------------------------------------------------------
# BankRegistry — named multi-tenant FilterServices
# ---------------------------------------------------------------------------

class BankRegistry:
    """Named FilterServices under one roof — the multi-tenant bank surface.
    Registration is by reference — rebuilds/publishes on the service are
    visible immediately; the registry never copies bank state."""

    def __init__(self):
        self._services: dict[str, FilterService] = {}

    def register(self, name: str, service: FilterService) -> None:
        if name in self._services:
            raise ValueError(f"bank {name!r} already registered")
        self._services[name] = service

    def unregister(self, name: str) -> None:
        del self._services[name]

    def get(self, name: str) -> FilterService:
        try:
            return self._services[name]
        except KeyError:
            raise KeyError(
                f"no bank named {name!r}; registered: {self.names()}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._services

    def names(self) -> list[str]:
        return sorted(self._services)

    def stats(self) -> dict:
        """{name: per-service stats dict} across every registered bank."""
        return {name: svc.stats.as_dict()
                for name, svc in sorted(self._services.items())}
