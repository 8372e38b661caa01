"""Bloomier / XOR filter family with bulk-synchronous peeling.

The paper's Bloomier filter (§3) peels a random 3-uniform hypergraph with a
sequential stack — a pointer-chasing algorithm with no data-parallel
analogue. We re-express it as **bulk-synchronous peeling**: each round scatter-adds slot
degrees, then peels *every* item that owns a degree-1 slot simultaneously
(O(log n) rounds w.h.p.). The reverse-round XOR encode is likewise a bulk
gather/XOR/scatter per round. This is exactly equivalent to sequential
peeling (proof sketch in DESIGN.md §3): within a round, peeled items own
distinct singleton slots and never read a same-round written slot, and no
later-assigned item can touch an earlier-assigned item's slots.

Two slot layouts:
  - ``uniform``: 3 equal segments (3-partite), threshold C≈1.23;
  - ``fuse``: spatially-coupled consecutive segments (Walzer 2021 / binary
    fuse), threshold C≈1.13 — the paper's experimental setting (j=3, C=1.13).

``BloomierTable`` is the general α-bit static function (retrieval) encoder;
``XorFilter`` (approximate membership; the LSM ChainedFilter's stage 1) and
``ExactBloomier`` (exact membership over a finite universe; the
ChainedFilterAnd's stage 2) specialize it per the paper. Builds are host numpy, identical to the
JAX package's; the probes are the CUDA kernels in ``repro_torch.kernels``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import hashing as H


class PeelingFailed(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# slot layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlotLayout:
    mode: str          # 'uniform' | 'fuse'
    m: int             # total slots
    seg_len: int       # segment length
    n_seg: int         # number of segments
    seed: int

    def slots_np(self, hi: np.ndarray, lo: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = self.seed
        if self.mode == "uniform":
            L = self.seg_len
            return tuple(
                i * L + H.np_hash_to_range(hi, lo, s * 7919 + i, L) for i in range(3)
            )
        # fuse: window of 3 consecutive segments chosen by h3
        L = self.seg_len
        start = H.np_hash_to_range(hi, lo, s * 7919 + 3, self.n_seg - 2)
        return tuple(
            (start + i) * L + H.np_hash_to_range(hi, lo, s * 7919 + i, L) for i in range(3)
        )


def make_layout(n: int, mode: str, C: float, seed: int) -> SlotLayout:
    n = max(n, 1)
    if mode == "uniform":
        seg = max(8, int(math.ceil(C * n / 3.0)))
        return SlotLayout("uniform", 3 * seg, seg, 3, seed)
    if mode == "fuse":
        # binary-fuse-style heuristics (Graf & Lemire 2022, 3-wise)
        seg_len = 1 << max(3, int(math.floor(math.log(max(n, 2)) / math.log(3.33) + 2.25)))
        size_factor = max(C, 0.875 + 0.25 * math.log(1e6) / math.log(max(n, 5)))
        cap = int(round(n * size_factor))
        n_seg = max(3, (cap + seg_len - 1) // seg_len + 2)
        return SlotLayout("fuse", n_seg * seg_len, seg_len, n_seg, seed)
    raise ValueError(f"unknown layout mode {mode!r}")


# ---------------------------------------------------------------------------
# bulk-synchronous peeling
# ---------------------------------------------------------------------------

def bulk_peel(h0: np.ndarray, h1: np.ndarray, h2: np.ndarray, m: int,
              max_rounds: int = 512) -> list[tuple[np.ndarray, np.ndarray]]:
    """Peel the 3-uniform hypergraph. Returns per-round (item_idx, ip_slot)
    in peel order; raises PeelingFailed if the 2-core is non-empty."""
    n = h0.shape[0]
    alive = np.ones(n, dtype=bool)
    deg = np.zeros(m, dtype=np.int32)
    for h in (h0, h1, h2):
        np.add.at(deg, h, 1)
    rounds: list[tuple[np.ndarray, np.ndarray]] = []
    idx_all = np.arange(n)
    for _ in range(max_rounds):
        if not alive.any():
            return rounds
        a = idx_all[alive]
        d0, d1, d2 = deg[h0[a]], deg[h1[a]], deg[h2[a]]
        peel = (d0 == 1) | (d1 == 1) | (d2 == 1)
        if not peel.any():
            raise PeelingFailed("non-empty 2-core (raise C or reseed)")
        p = a[peel]
        ip = np.where(deg[h0[p]] == 1, h0[p], np.where(deg[h1[p]] == 1, h1[p], h2[p]))
        rounds.append((p, ip))
        alive[p] = False
        for h in (h0, h1, h2):
            np.add.at(deg, h[p], -1)
    raise PeelingFailed("max_rounds exceeded")


def bulk_peel2(u: np.ndarray, v: np.ndarray, m: int,
               max_rounds: int = 4096) -> list[tuple[np.ndarray, np.ndarray]]:
    """Bipartite (2-uniform) variant of :func:`bulk_peel` for Othello's
    acyclic A–B graph: each round peels every edge owning a degree-1 node.
    Returns per-round (edge_idx, pivot_node); raises PeelingFailed when a
    2-core (i.e. any cycle) survives — Othello reseeds in that case.

    Rounds peel paths from both ends, so a length-L path costs L/2 rounds;
    random subcritical graphs have O(log n) longest paths w.h.p., but the
    bound is generous because a round is one cheap vector pass."""
    n = u.shape[0]
    alive = np.ones(n, dtype=bool)
    deg = np.zeros(m, dtype=np.int32)
    np.add.at(deg, u, 1)
    np.add.at(deg, v, 1)
    rounds: list[tuple[np.ndarray, np.ndarray]] = []
    idx_all = np.arange(n)
    for _ in range(max_rounds):
        if not alive.any():
            return rounds
        a = idx_all[alive]
        peel = (deg[u[a]] == 1) | (deg[v[a]] == 1)
        if not peel.any():
            raise PeelingFailed("non-empty 2-core (cyclic — reseed)")
        p = a[peel]
        ip = np.where(deg[u[p]] == 1, u[p], v[p])
        rounds.append((p, ip))
        alive[p] = False
        np.add.at(deg, u[p], -1)
        np.add.at(deg, v[p], -1)
    raise PeelingFailed("max_rounds exceeded")


def bulk_assign(rounds: list[tuple[np.ndarray, np.ndarray]],
                h0, h1, h2, values: np.ndarray, m: int) -> np.ndarray:
    """Reverse-round bulk XOR encode. ``values`` are the α-bit targets."""
    table = np.zeros(m, dtype=np.uint32)
    for p, ip in reversed(rounds):
        acc = table[h0[p]] ^ table[h1[p]] ^ table[h2[p]]  # table[ip]==0 still
        table[ip] = acc ^ values[p].astype(np.uint32)
    return table


# ---------------------------------------------------------------------------
# BloomierTable — α-bit static function (retrieval structure)
# ---------------------------------------------------------------------------

@dataclass
class BloomierTable:
    layout: SlotLayout
    alpha: int
    table: np.ndarray = field(repr=False)   # uint32 [m], low alpha bits used
    n_keys: int = 0
    build_rounds: int = 0

    @classmethod
    def build(cls, keys: np.ndarray, values: np.ndarray, alpha: int,
              mode: str = "fuse", C: float = 1.13, seed: int = 0,
              max_retries: int = 12) -> "BloomierTable":
        """Encode keys→values (values < 2^alpha). Retries with new seeds,
        gently bumping C, until peeling succeeds (w.h.p. first try)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if len(np.unique(keys)) != len(keys):
            raise ValueError("BloomierTable requires distinct keys")
        values = np.asarray(values)
        hi, lo = H.np_split_u64(keys)
        c = C
        last = None
        for attempt in range(max_retries):
            layout = make_layout(len(keys), mode, c, seed + attempt * 101)
            h0, h1, h2 = layout.slots_np(hi, lo)
            try:
                rounds = bulk_peel(h0, h1, h2, layout.m)
            except PeelingFailed as e:
                last = e
                c *= 1.05
                continue
            table = bulk_assign(rounds, h0, h1, h2, values, layout.m)
            return cls(layout=layout, alpha=alpha, table=table,
                       n_keys=len(keys), build_rounds=len(rounds))
        raise PeelingFailed(f"construction failed after {max_retries} retries: {last}")

    # -- lookup (returns the α-bit decoded value; arbitrary for non-keys) ----
    def lookup(self, keys: np.ndarray) -> np.ndarray:
        hi, lo = H.np_split_u64(keys)
        h0, h1, h2 = self.layout.slots_np(hi, lo)
        mask = np.uint32((1 << self.alpha) - 1)
        return (self.table[h0] ^ self.table[h1] ^ self.table[h2]) & mask

    @property
    def bits(self) -> int:
        """Logical space: m slots × α bits (physical uint32 array is an
        implementation convenience; benchmarks account logical bits)."""
        return self.layout.m * self.alpha


# ---------------------------------------------------------------------------
# Approximate membership: XOR filter (approximate Bloomier)
# ---------------------------------------------------------------------------

@dataclass
class XorFilter:
    """α-bit-fingerprint approximate filter: fpr = 2^-α, zero false negatives."""

    tbl: BloomierTable
    fp_seed: int

    @classmethod
    def build(cls, keys: np.ndarray, alpha: int, mode: str = "fuse",
              C: float = 1.13, seed: int = 0) -> "XorFilter":
        if alpha < 1 or alpha > 32:
            raise ValueError("alpha must be in [1,32]")
        hi, lo = H.np_split_u64(np.asarray(keys, dtype=np.uint64))
        fp_seed = seed * 31 + 17
        fps = H.np_hash_u32(hi, lo, fp_seed) & np.uint32((1 << alpha) - 1)
        tbl = BloomierTable.build(keys, fps, alpha, mode=mode, C=C, seed=seed)
        return cls(tbl=tbl, fp_seed=fp_seed)

    def query(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        hi, lo = H.np_split_u64(keys)
        fps = H.np_hash_u32(hi, lo, self.fp_seed) & np.uint32((1 << self.alpha) - 1)
        return self.tbl.lookup(keys) == fps

    # -- packed-table interchange (FilterBank, §5.2) -------------------------
    def to_tables(self):
        from .tables import XorTable, pad_words
        lay = self.tbl.layout
        tables = pad_words(self.tbl.table)
        return tables, XorTable(offset=0, width=len(tables), mode=lay.mode,
                                seed=lay.seed, seg_len=lay.seg_len,
                                n_seg=lay.n_seg, alpha=self.tbl.alpha,
                                fp_seed=self.fp_seed)

    @classmethod
    def from_tables(cls, tables: np.ndarray, layout) -> "XorFilter":
        slot_layout = SlotLayout(layout.mode, layout.n_seg * layout.seg_len,
                                 layout.seg_len, layout.n_seg, layout.seed)
        table = np.array(tables[layout.offset:layout.offset + slot_layout.m],
                         dtype=np.uint32)
        tbl = BloomierTable(layout=slot_layout, alpha=layout.alpha, table=table)
        return cls(tbl=tbl, fp_seed=layout.fp_seed)

    @property
    def alpha(self) -> int:
        return self.tbl.alpha

    @property
    def bits(self) -> int:
        return self.tbl.bits


# ---------------------------------------------------------------------------
# Exact membership over a finite universe (1-bit Bloomier, §3 / §4.2)
# ---------------------------------------------------------------------------

@dataclass
class ExactBloomier:
    """Encodes *every* item of a finite universe with a 1-bit fingerprint.

    strategy 'a' (P[h1=1]=1/2): positives get f=h1(e), negatives f=~h1(e);
      un-encoded items match with prob 1/2.
    strategy 'b' (P[h1=1]=1): positives f=1, negatives f=0; un-encoded items
      match with prob ≈ P[3-xor of table bits == 1].
    """

    tbl: BloomierTable
    strategy: str
    bit_seed: int

    @classmethod
    def build(cls, pos_keys: np.ndarray, neg_keys: np.ndarray,
              strategy: str = "a", mode: str = "fuse", C: float = 1.13,
              seed: int = 0) -> "ExactBloomier":
        pos = np.asarray(pos_keys, dtype=np.uint64)
        neg = np.asarray(neg_keys, dtype=np.uint64)
        universe = np.concatenate([pos, neg])
        is_pos = np.zeros(len(universe), dtype=np.uint32)
        is_pos[: len(pos)] = 1
        bit_seed = seed * 131 + 7
        if strategy == "a":
            hi, lo = H.np_split_u64(universe)
            h1b = H.np_hash_u32(hi, lo, bit_seed) & np.uint32(1)
            values = np.where(is_pos == 1, h1b, 1 - h1b).astype(np.uint32)
        elif strategy == "b":
            values = is_pos
        else:
            raise ValueError("strategy must be 'a' or 'b'")
        tbl = BloomierTable.build(universe, values, alpha=1, mode=mode, C=C, seed=seed)
        return cls(tbl=tbl, strategy=strategy, bit_seed=bit_seed)

    def query(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        got = self.tbl.lookup(keys)
        if self.strategy == "a":
            hi, lo = H.np_split_u64(keys)
            h1b = H.np_hash_u32(hi, lo, self.bit_seed) & np.uint32(1)
            return got == h1b
        return got == 1

    # -- packed-table interchange (FilterBank, §5.2) -------------------------
    def to_tables(self):
        from .tables import ExactTable, pad_words
        lay = self.tbl.layout
        tables = pad_words(self.tbl.table)
        return tables, ExactTable(offset=0, width=len(tables), mode=lay.mode,
                                  seed=lay.seed, seg_len=lay.seg_len,
                                  n_seg=lay.n_seg, strategy=self.strategy,
                                  bit_seed=self.bit_seed)

    @classmethod
    def from_tables(cls, tables: np.ndarray, layout) -> "ExactBloomier":
        slot_layout = SlotLayout(layout.mode, layout.n_seg * layout.seg_len,
                                 layout.seg_len, layout.n_seg, layout.seed)
        table = np.array(tables[layout.offset:layout.offset + slot_layout.m],
                         dtype=np.uint32)
        tbl = BloomierTable(layout=slot_layout, alpha=1, table=table)
        return cls(tbl=tbl, strategy=layout.strategy, bit_seed=layout.bit_seed)

    @property
    def bits(self) -> int:
        return self.tbl.bits
