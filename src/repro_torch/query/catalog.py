"""Catalog: named collections + secondary-index tag banks.

A ``Collection`` is an ``LsmStore`` plus zero or more ``TagIndex``es — a
key→tag retrieval structure in the style of an expression index: the
indexed tag is ``tag_fn(keys, vals)`` masked to ``tag_bits`` bits, and
the index stores it as ``tag_bits`` 1-bit Othello retrieval planes
(Dietzfelbinger & Pagh's construction, the same machinery the paper's
stage-2 dynamic exact filter uses) over the generation's live keys.

Enrollment rides the store's publish hook: every flush / compaction /
deferred-GC sweep that swaps in a new ``Generation`` immediately rebuilds
the tag planes from ``Generation.live_items()`` — the probe-only view,
never the store's private build-side lists — and double-buffers them
through a ``FilterService`` (``prepare`` + ``publish``, the PR-5 swap
discipline). The captured ``BankState`` of every generation that is still
pinned by an open snapshot is retained, so a plan that pinned gen G keeps
probing G's tag bank bit-identically while newer generations publish.

Retrieval semantics (why this is safe): an Othello retrieval answers
exactly for enrolled keys and arbitrarily for everything else. Tag stages
therefore only ever *narrow* a candidate set whose membership is settled
elsewhere — the pipeline executor guarantees every plan ends
membership-resolved (see ``pipeline.PlanExecution``), so a dead or absent
key can never surface no matter what the planes answer for it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.othello import Othello
from repro_torch.kernels.common import as_device
from repro_torch.serving.filter_service import (BankRegistry, BankState,
                                                FilterService)
from repro_torch.storage.lsm_store import LsmStore


class _Missing:
    """Sentinel: no BankState captured for a generation (index created
    after the generation published, or state already pruned)."""

    def __repr__(self):
        return "<no bank state>"


MISSING = _Missing()


class TagIndex:
    """Secondary index: key → ``tag_bits``-bit tag, served as bit-planes.

    One ``Othello`` plane per tag bit, all planes packed into one
    ``FilterBank`` and published through a ``FilterService`` on ``device``
    (the card by default; ``"cpu"`` serves the planes with the plain torch
    ops), its rows split over the ``data`` ranks of ``mesh`` where one is
    given. The index keeps ``{gen_id: BankState | None}``: ``None`` marks an
    empty generation (nothing enrolled — every generation-resident probe is
    vacuously False), a ``BankState`` is the immutable bank version that
    serves that generation. States for generations that are neither
    current nor pinned are pruned at each enrollment."""

    def __init__(self, name: str, tag_fn, *, tag_bits: int = 4,
                 seed: int = 0, device="cuda", mesh=None):
        if not (1 <= tag_bits <= 16):
            raise ValueError("tag_bits must be in [1, 16]")
        self.name = name
        self.tag_fn = tag_fn
        self.tag_bits = int(tag_bits)
        self.seed = int(seed)
        self.device = as_device(device)
        self.mesh = mesh
        self.service: FilterService | None = None
        self.enrollments = 0
        self._states: dict[int, BankState | None] = {}
        self._registry: BankRegistry | None = None
        self._qualname: str | None = None

    @property
    def tag_mask(self) -> int:
        return (1 << self.tag_bits) - 1

    def host_tags(self, keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """The ground-truth tag of each (key, value) row — ``tag_fn``
        masked to the index width. Used at enrollment AND by the memtable
        overlay at query time, so both sides compute the same function."""
        tags = np.asarray(self.tag_fn(np.asarray(keys, np.uint64),
                                      np.asarray(vals, np.uint64)))
        return tags.astype(np.uint64) & np.uint64(self.tag_mask)

    # -- enrollment (publish-hook side) -------------------------------------
    def enroll(self, store: LsmStore, gen) -> None:
        """Rebuild the tag planes for a freshly published generation and
        retain the captured state under its gen_id. Runs inside the
        store's publish hook — one enrollment per swap means the current
        bank can never lag the current generation."""
        keys, vals = gen.live_items()
        if len(keys) == 0:
            state = None
        else:
            tags = self.host_tags(keys, vals)
            planes = [
                Othello.build(keys, ((tags >> np.uint64(j)) & np.uint64(1)
                                     ).astype(np.uint8),
                              seed=self.seed + 7919 * gen.gen_id + 131 * j)
                for j in range(self.tag_bits)
            ]
            if self.service is None:
                self.service = FilterService(planes, device=self.device,
                                             mesh=self.mesh)
                if self._registry is not None:
                    self._registry.register(self._qualname, self.service)
            else:
                self.service.rebuild(planes)
            state = self.service.state
        self._states[gen.gen_id] = state
        self.enrollments += 1
        self._prune(store, gen.gen_id)

    def _prune(self, store: LsmStore, current_gen_id: int) -> None:
        keep = set(store.pinned_generations) | {current_gen_id}
        self._states = {g: s for g, s in self._states.items() if g in keep}

    # -- probe side ----------------------------------------------------------
    def state_for(self, gen_id: int):
        """BankState | None | MISSING for a pinned generation. ``None``
        means the generation had no live rows; ``MISSING`` means no state
        was captured (caller must fall back to exact resolution)."""
        return self._states.get(gen_id, MISSING)

    def bank_tags(self, state: BankState, keys: np.ndarray) -> np.ndarray:
        """uint64 [n] tags reassembled from one fused probe of all
        ``tag_bits`` planes. Exact for keys enrolled in ``state``'s
        generation; arbitrary for all others (see module docstring)."""
        member, _ = self.service.probe(keys, state=state)
        tags = np.zeros(len(keys), np.uint64)
        for j in range(self.tag_bits):
            tags |= member[j].astype(np.uint64) << np.uint64(j)
        return tags


class Collection:
    """One named store plus its secondary indexes, wired to the publish
    hook: every generation swap re-enrolls every index before the swap
    returns to the caller."""

    def __init__(self, name: str, store: LsmStore, *,
                 registry: BankRegistry | None = None):
        self.name = name
        self.store = store
        self.indexes: dict[str, TagIndex] = {}
        self._registry = registry
        store.add_publish_hook(self._on_publish)

    def _on_publish(self, store: LsmStore, gen) -> None:
        for idx in self.indexes.values():
            idx.enroll(store, gen)

    def create_index(self, name: str, tag_fn, *, tag_bits: int = 4,
                     seed: int = 0) -> TagIndex:
        """Create a tag index and enroll the CURRENT generation
        immediately, so probes never race index creation."""
        if name in self.indexes:
            raise ValueError(f"index {name!r} already exists on "
                             f"collection {self.name!r}")
        idx = TagIndex(name, tag_fn, tag_bits=tag_bits,
                       seed=seed, device=self.store.device,
                       mesh=self.store.mesh)
        if self._registry is not None:
            idx._registry = self._registry
            idx._qualname = f"{self.name}/{name}"
        self.indexes[name] = idx
        idx.enroll(self.store, self.store.generation)
        return idx

    def drop_index(self, name: str) -> None:
        idx = self.indexes.pop(name)
        if idx._registry is not None and idx.service is not None:
            idx._registry.unregister(idx._qualname)

    def snapshot(self):
        return self.store.snapshot()


class Catalog:
    """Named collections + one shared ``BankRegistry`` for every tag
    bank the catalog owns ("collection/index" names)."""

    def __init__(self):
        self.registry = BankRegistry()
        self._collections: dict[str, Collection] = {}

    def create_collection(self, name: str, store: LsmStore | None = None,
                          **store_kwargs) -> Collection:
        if name in self._collections:
            raise ValueError(f"collection {name!r} already exists")
        if store is None:
            store = LsmStore(**store_kwargs)
        coll = Collection(name, store, registry=self.registry)
        self._collections[name] = coll
        return coll

    def drop_collection(self, name: str) -> None:
        coll = self._collections.pop(name)
        for idx_name in list(coll.indexes):
            coll.drop_index(idx_name)
        coll.store.remove_publish_hook(coll._on_publish)

    def __getitem__(self, name: str) -> Collection:
        try:
            return self._collections[name]
        except KeyError:
            raise KeyError(f"no collection named {name!r}; have: "
                           f"{sorted(self._collections)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._collections

    def names(self) -> list[str]:
        return sorted(self._collections)
