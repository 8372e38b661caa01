"""Othello hashing, the dynamic exact stage 2 of the LSM chained filters.

Frozen copy of ``repro_torch/core/othello.py`` (``Othello``'s bulk build,
batched inserts over the parity union-find, lookups, and
``DynamicExactFilter``) without the packed-table interchange.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import hashing as H
from .bloomier import PeelingFailed, bulk_peel2


@dataclass
class Othello:
    ma: int
    mb: int
    seed: int = 0
    bits_a: np.ndarray = field(default=None, repr=False)
    bits_b: np.ndarray = field(default=None, repr=False)
    n_keys: int = 0

    # Dynamic state:
    # edges sorted by key, plus a parity union-find over the ma+mb nodes.
    # Invariant: bit(x) = _pot[x] ⊕ pot-path to root ⊕ _rootbit[root(x)];
    # _pot[root] == 0. ``bits_a``/``bits_b`` cache the materialized bits and
    # are stale while ``_dirty`` (lookup/pack re-materialize on demand).
    _ekeys: np.ndarray = field(default=None, init=False, repr=False)
    _eu: np.ndarray = field(default=None, init=False, repr=False)
    _ev: np.ndarray = field(default=None, init=False, repr=False)
    _eval: np.ndarray = field(default=None, init=False, repr=False)
    _parent: np.ndarray = field(default=None, init=False, repr=False)
    _pot: np.ndarray = field(default=None, init=False, repr=False)
    _rootbit: np.ndarray = field(default=None, init=False, repr=False)
    _dirty: bool = field(default=False, init=False, repr=False)

    def __post_init__(self):
        if self.bits_a is None:
            self.bits_a = np.zeros(self.ma, dtype=np.uint8)
            self.bits_b = np.zeros(self.mb, dtype=np.uint8)
            self._init_dynamic_state()

    def _init_dynamic_state(self) -> None:
        m2 = self.ma + self.mb
        self._ekeys = np.empty(0, dtype=np.uint64)
        self._eu = np.empty(0, dtype=np.int64)
        self._ev = np.empty(0, dtype=np.int64)
        self._eval = np.empty(0, dtype=np.uint8)
        self._parent = np.arange(m2, dtype=np.int64)
        self._pot = np.zeros(m2, dtype=np.uint8)
        self._rootbit = np.zeros(m2, dtype=np.uint8)
        self._dirty = False

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, keys: np.ndarray, values: np.ndarray, seed: int = 0,
              load: float = 0.75, max_retries: int = 24) -> "Othello":
        """values ∈ {0,1}. ma=mb=⌈n/load⌉ ⇒ ~2/load = 2.66 slots ≈ 2.33+
        effective bits/key at the paper's operating point.

        Bulk-synchronous construction: hash all keys to edges at once, peel
        the bipartite graph round-by-round, assign bits in reverse round
        order. Duplicate keys keep the LAST value (insert-then-update
        semantics of the sequential reference); any surviving cycle
        reseeds."""
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint8) & 1
        # dedupe keep-last; np.unique also key-sorts the edge arrays
        uk, fi = np.unique(keys[::-1], return_index=True)
        uv = (values[::-1][fi] if len(values) else
              np.empty(0, np.uint8))
        n = max(1, len(uk))
        m = max(16, int(np.ceil(n / load)))
        hi, lo = H.np_split_u64(uk)
        last = None
        for attempt in range(max_retries):
            s = seed + attempt * 37
            u = H.np_hash_to_range(hi, lo, s * 3 + 1, m).astype(np.int64)
            v = H.np_hash_to_range(hi, lo, s * 3 + 2, m).astype(np.int64) + m
            try:
                rounds = bulk_peel2(u, v, 2 * m)
            except PeelingFailed as e:
                last = e
                if attempt % 6 == 5:
                    m = int(m * 1.15)
                continue
            oth = cls(ma=m, mb=m, seed=s)
            oth._adopt_peeled(uk, uv, u, v, rounds)
            return oth
        raise RuntimeError(f"othello build failed: {last}")

    def _adopt_peeled(self, ekeys, evals, u, v, rounds) -> None:
        """Install edge arrays + bits + a fully compressed union-find from a
        successful peel of this instance's (ma, mb, seed) graph.

        The peel order orients the forest: each round's pivot is the unique
        owner of its singleton node and hangs off the far endpoint with the
        edge's value as parity. With roots anchored at bit 0, the tree
        constraints have a unique solution — bit(x) = XOR of edge values on
        the path to the root — so the reverse-round XOR assignment of
        ``bulk_assign`` is exactly the parity fold ``_materialize`` performs
        (in O(log depth) pointer-doubling passes instead of one pass per
        peel round), which also leaves every path fully compressed."""
        m2 = self.ma + self.mb
        parent = np.arange(m2, dtype=np.int64)
        pot = np.zeros(m2, dtype=np.uint8)
        for p, ip in rounds:
            parent[ip] = u[p] + v[p] - ip
            pot[ip] = evals[p]
        self._ekeys, self._eval = ekeys, evals
        self._eu, self._ev = u, v
        self._parent = parent
        self._pot = pot
        self._rootbit = np.zeros(m2, dtype=np.uint8)
        self.n_keys = len(ekeys)
        self._dirty = True
        self._materialize()

    # ------------------------------------------------------------- hashing
    def _nodes_many(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        hi, lo = H.np_split_u64(keys)
        u = H.np_hash_to_range(hi, lo, self.seed * 3 + 1, self.ma)
        v = H.np_hash_to_range(hi, lo, self.seed * 3 + 2, self.mb) + self.ma
        return u.astype(np.int64), v.astype(np.int64)

    # ---------------------------------------------------------- union-find
    def _find_many(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized find-with-parity -> (root, parity x→root). Paths are
        short: fully compressed at every materialization, length ≤ unions
        since."""
        par, pot = self._parent, self._pot
        r = x.copy()
        p = np.zeros(len(x), dtype=np.uint8)
        while True:
            nxt = par[r]
            moved = nxt != r
            if not moved.any():
                return r, p
            p ^= np.where(moved, pot[r], np.uint8(0))
            r = np.where(moved, nxt, r)

    def _materialize(self) -> None:
        """Fold lazy component flips into the bit arrays: one vectorized
        pointer-doubling pass over all ma+mb nodes, which also re-compresses
        every union-find path to length 1."""
        if not self._dirty:
            return
        p = self._parent
        off = self._pot
        while True:
            nxt = p[p]
            if np.array_equal(nxt, p):
                break
            off = off ^ off[p]
            p = nxt
        bits = off ^ self._rootbit[p]
        self._parent = p
        self._pot = off
        self._rootbit = bits.copy()
        self.bits_a = bits[:self.ma].copy()
        self.bits_b = bits[self.ma:].copy()
        self._dirty = False

    # --------------------------------------------------------------- insert
    def insert_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Insert/update a whole key batch in bulk array passes.

        Classifies every new edge against the parity union-find per round
        (vectorized find, all root-disjoint unions applied at once, lazy
        component flips) and drops consistent duplicates. Value updates of
        encoded keys re-solve the unchanged graph in one bulk
        peel+reassign (seed and layout stable); only an inconsistent or
        unpeelable cycle falls back to ONE reseeding rebuild for the whole
        batch."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return
        values = np.broadcast_to(np.asarray(values, dtype=np.uint8) & 1,
                                 keys.shape)
        # dedupe within the batch, newest-wins
        uk, fi = np.unique(keys[::-1], return_index=True)
        uv = values[::-1][fi]
        # classify against existing edges
        ne = len(self._ekeys)
        pos = np.searchsorted(self._ekeys, uk)
        pos_c = np.minimum(pos, max(ne - 1, 0))
        exists = (self._ekeys[pos_c] == uk) if ne else np.zeros(len(uk), bool)
        flips = exists.copy()
        if exists.any():
            flips[exists] = self._eval[pos_c[exists]] != uv[exists]
        if flips.any():
            # value updates on encoded keys (e.g. a prefix-cache eviction
            # demoting a positive): overwrite the edge values and re-solve
            # the UNCHANGED graph — same hashes, same seed, no retry loop —
            # via one bulk peel+reassign; only a graph that genuinely
            # carries cycle edges falls back to the reseeding rebuild
            self._eval[pos_c[flips]] = uv[flips]
            new = ~exists
            if new.any():
                self._append_edges(uk[new], uv[new])
            self._reassign()
            return
        new = ~exists
        if new.any():
            self._insert_new_edges(uk[new], uv[new])

    def _append_edges(self, nk: np.ndarray, nv: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Splice new key-sorted edges into the flat arrays; returns the
        (u, v) endpoints of the added edges."""
        u, v = self._nodes_many(nk)
        ins = np.searchsorted(self._ekeys, nk)
        self._ekeys = np.insert(self._ekeys, ins, nk)
        self._eu = np.insert(self._eu, ins, u)
        self._ev = np.insert(self._ev, ins, v)
        self._eval = np.insert(self._eval, ins, nv)
        self.n_keys += len(nk)
        return u, v

    def _reassign(self) -> None:
        """Re-solve bit assignment for the CURRENT edge arrays with the
        current values: one bulk peel over the unchanged graph (w.h.p. a
        forest — always solvable, whatever the values), keeping ma/mb/seed
        so packed-table layouts stay stable across value updates. Falls
        back to the reseeding rebuild only when recorded consistent-cycle
        edges make the graph unpeelable.

        Cost is O(total edges) vectorized per flip batch — cheap for the
        per-tier prefix-cache filters that churn values, and LsmStore's
        flush exclusions never flip; an O(component) incremental flip
        would need a maintained adjacency (the dict design this module
        replaced)."""
        try:
            rounds = bulk_peel2(self._eu, self._ev, self.ma + self.mb)
        except PeelingFailed:
            self._bulk_rebuild()
            return
        self._adopt_peeled(self._ekeys, self._eval, self._eu, self._ev,
                           rounds)

    def _insert_new_edges(self, nk: np.ndarray, nv: np.ndarray) -> None:
        # record the edges up front so a rebuild fallback mid-way already
        # sees the complete key set
        u, v = self._append_edges(nk, nv)
        pend = np.arange(len(nk))
        while pend.size:
            ru, pu = self._find_many(u[pend])
            rv, pv = self._find_many(v[pend])
            same = ru == rv
            if same.any():
                if ((pu[same] ^ pv[same]) != nv[pend[same]]).any():
                    self._bulk_rebuild()                 # inconsistent cycle
                    return
            cand = ~same            # consistent cycles: recorded, no union
            if not cand.any():
                return
            ci = pend[cand]
            cru, crv = ru[cand], rv[cand]
            cpu, cpv = pu[cand], pv[cand]
            k = ci.size
            # root-disjoint union selection: an edge may merge this round
            # only if BOTH its roots appear here for the first time, so all
            # selected unions touch pairwise-distinct components
            rr = np.concatenate([cru, crv])
            uniq, first = np.unique(rr, return_index=True)
            firstocc = first[np.searchsorted(uniq, rr)]
            ar = np.arange(k)
            sel = (firstocc[:k] == ar) & (firstocc[k:] == k + ar)
            if not sel.any():
                # root-sharing deadlock (e.g. two edges over the same two
                # components): serialize one edge to guarantee progress
                sel = np.zeros(k, dtype=bool)
                sel[0] = True
            newpot = nv[ci[sel]] ^ cpu[sel] ^ cpv[sel]
            rv_s, ru_s = crv[sel], cru[sel]
            # a union leaves bits unchanged iff the edge was already
            # consistent; otherwise the grafted component flips lazily
            if (newpot != (self._rootbit[ru_s] ^ self._rootbit[rv_s])).any():
                self._dirty = True
            self._parent[rv_s] = ru_s
            self._pot[rv_s] = newpot
            pend = ci[~sel]

    def _bulk_rebuild(self) -> None:
        """Reseed-rebuild from the flat edge arrays (already holding the
        batch's keys and values) — ONE rebuild per batch, the bulk
        replacement for the sequential per-key reseed."""
        fresh = Othello.build(self._ekeys, self._eval, seed=self.seed + 1)
        self.ma, self.mb = fresh.ma, fresh.mb
        self.seed = fresh.seed
        self.bits_a, self.bits_b = fresh.bits_a, fresh.bits_b
        self.n_keys = fresh.n_keys
        self._ekeys, self._eu = fresh._ekeys, fresh._eu
        self._ev, self._eval = fresh._ev, fresh._eval
        self._parent, self._pot = fresh._parent, fresh._pot
        self._rootbit, self._dirty = fresh._rootbit, fresh._dirty

    # ---------------------------------------------------------------- query
    def lookup(self, keys: np.ndarray) -> np.ndarray:
        self._materialize()
        keys = np.asarray(keys, dtype=np.uint64)
        hi, lo = H.np_split_u64(keys)
        u = H.np_hash_to_range(hi, lo, self.seed * 3 + 1, self.ma)
        v = H.np_hash_to_range(hi, lo, self.seed * 3 + 2, self.mb)
        return (self.bits_a[u] ^ self.bits_b[v]).astype(bool)


@dataclass
class DynamicExactFilter:
    """Exact membership with dynamic updates: Othello over pos ∪ neg keys
    (value 1 = positive). Drop-in dynamic replacement for ExactBloomier in
    ChainedFilter stage 2 (paper §4.3.1 / §5.4)."""

    oth: Othello

    @classmethod
    def build(cls, pos_keys: np.ndarray, neg_keys: np.ndarray, seed: int = 0
              ) -> "DynamicExactFilter":
        pos = np.asarray(pos_keys, dtype=np.uint64)
        neg = np.asarray(neg_keys, dtype=np.uint64)
        keys = np.concatenate([pos, neg])
        vals = np.concatenate([np.ones(len(pos), np.uint8), np.zeros(len(neg), np.uint8)])
        return cls(oth=Othello.build(keys, vals, seed=seed))

    def exclude(self, keys: np.ndarray) -> None:
        """Dynamically whitelist-out new negatives (no false negatives ever)
        — one batched union-find pass for the whole key array."""
        keys = np.asarray(keys, dtype=np.uint64)
        if len(keys):
            self.oth.insert_batch(keys, np.zeros(len(keys), np.uint8))

    def query(self, keys: np.ndarray) -> np.ndarray:
        return self.oth.lookup(keys)
