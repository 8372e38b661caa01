"""Sequential Othello reference — the per-key dict-adjacency construction.

This is the pre-bulk write path (one ``insert`` per key, component walks
over a dict adjacency), kept as the *correctness reference* for the
vectorized builder in :mod:`repro_torch.core.othello` and as the honest baseline
for ``benchmarks/write_path.py``. Two fixes over the historical version:

- ``_connected`` early-exits its BFS the moment it reaches ``v`` instead of
  materializing the whole component first;
- adjacency is a dict of per-node ``{key: (neighbor, value)}`` dicts, so
  ``_remove_edge`` is two O(1) deletions instead of two O(deg) list
  rebuilds.

Query/packing behaviour is bit-compatible with the bulk Othello for the
same final (seed, ma, mb, bit arrays); *encoded-key lookups* agree with the
bulk builder for the same (keys, values, seed) input even when the two
accept different attempt seeds (the bulk builder reseeds on any cycle, the
sequential one only on inconsistent ones).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import hashing as H
from .othello import CycleError, pack_bitmap


@dataclass
class SequentialOthello:
    ma: int
    mb: int
    seed: int = 0
    bits_a: np.ndarray = field(default=None, repr=False)
    bits_b: np.ndarray = field(default=None, repr=False)
    # adjacency: node -> {key: (neighbor_node, value)}; nodes in A are
    # [0, ma), nodes in B are [ma, ma+mb)
    adj: dict = field(default_factory=dict, repr=False)
    n_keys: int = 0

    def __post_init__(self):
        if self.bits_a is None:
            self.bits_a = np.zeros(self.ma, dtype=np.uint8)
            self.bits_b = np.zeros(self.mb, dtype=np.uint8)

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, keys: np.ndarray, values: np.ndarray, seed: int = 0,
              load: float = 0.75, max_retries: int = 24) -> "SequentialOthello":
        """values ∈ {0,1}; same sizing schedule as the bulk builder."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = max(1, len(keys))
        m = max(16, int(np.ceil(n / load)))
        last = None
        for attempt in range(max_retries):
            oth = cls(ma=m, mb=m, seed=seed + attempt * 37)
            try:
                for k, v in zip(keys, np.asarray(values)):
                    oth.insert(np.uint64(k), int(v), _allow_rebuild=False)
                return oth
            except CycleError as e:
                last = e
                if attempt % 6 == 5:
                    m = int(m * 1.15)
        raise RuntimeError(f"othello build failed: {last}")

    def _nodes(self, key: np.uint64) -> tuple[int, int]:
        hi, lo = H.np_split_u64(np.array([key], dtype=np.uint64))
        u = int(H.np_hash_to_range(hi, lo, self.seed * 3 + 1, self.ma)[0])
        v = int(H.np_hash_to_range(hi, lo, self.seed * 3 + 2, self.mb)[0]) + self.ma
        return u, v

    def _value_at(self, node: int) -> int:
        return int(self.bits_a[node]) if node < self.ma else int(self.bits_b[node - self.ma])

    def _set(self, node: int, bit: int) -> None:
        if node < self.ma:
            self.bits_a[node] = bit
        else:
            self.bits_b[node - self.ma] = bit

    def _component(self, root: int) -> list[int]:
        seen = {root}
        stack = [root]
        while stack:
            x = stack.pop()
            for nb, _ in self.adj.get(x, {}).values():
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        return list(seen)

    def _connected(self, u: int, v: int) -> bool:
        """BFS from u that stops the moment it reaches v (no full-component
        materialization)."""
        if u not in self.adj or v not in self.adj:
            return False
        if u == v:
            return True
        seen = {u}
        stack = [u]
        while stack:
            x = stack.pop()
            for nb, _ in self.adj.get(x, {}).values():
                if nb == v:
                    return True
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        return False

    def _remove_edge(self, u: int, v: int, key: np.uint64) -> bool:
        """Drop the (u,v,key) edge if present; True when it existed."""
        eu = self.adj.get(u)
        if eu is None or key not in eu:
            return False
        del eu[key]
        del self.adj[v][key]
        self.n_keys -= 1
        return True

    # --------------------------------------------------------------- insert
    def insert(self, key: np.uint64, value: int, _allow_rebuild: bool = True) -> None:
        """Insert OR UPDATE key -> value (original Othello semantics: flip
        the far component on a tree edge, reseed-rebuild on an inconsistent
        cycle)."""
        u, v = self._nodes(key)
        self._remove_edge(u, v, key)
        cur = self._value_at(u) ^ self._value_at(v)
        if self._connected(u, v):
            if cur != value:
                if _allow_rebuild:
                    self._rebuild_with(key, value)
                    return
                raise CycleError(f"inconsistent cycle for key {key}")
            # consistent cycle: nothing to do, but record the edge
        elif cur != value:
            for node in self._component(v):
                self._set(node, self._value_at(node) ^ 1)
        self.adj.setdefault(u, {})[key] = (v, value)
        self.adj.setdefault(v, {})[key] = (u, value)
        self.n_keys += 1

    def insert_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Per-key loop — what 'batched' meant before the bulk write path."""
        values = np.broadcast_to(np.asarray(values, dtype=np.uint8),
                                 (len(keys),))
        for k, val in zip(np.asarray(keys, dtype=np.uint64), values):
            self.insert(np.uint64(k), int(val))

    def _rebuild_with(self, key: np.uint64, value: int) -> None:
        kv = {}
        for node in self.adj:
            if node < self.ma:
                for k, (_, val) in self.adj[node].items():
                    kv[int(k)] = int(val)
        kv[int(key)] = int(value)
        keys = np.array(sorted(kv), dtype=np.uint64)
        vals = np.array([kv[int(k)] for k in keys], dtype=np.uint8)
        fresh = SequentialOthello.build(keys, vals, seed=self.seed + 1)
        self.ma, self.mb = fresh.ma, fresh.mb
        self.seed = fresh.seed
        self.bits_a, self.bits_b = fresh.bits_a, fresh.bits_b
        self.adj, self.n_keys = fresh.adj, fresh.n_keys

    # ---------------------------------------------------------------- query
    def lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        hi, lo = H.np_split_u64(keys)
        u = H.np_hash_to_range(hi, lo, self.seed * 3 + 1, self.ma)
        v = H.np_hash_to_range(hi, lo, self.seed * 3 + 2, self.mb)
        return (self.bits_a[u] ^ self.bits_b[v]).astype(bool)

    # -- packed-table interchange (same layout as the bulk Othello) ----------
    def to_tables(self):
        from .tables import OthelloTable, pad_words
        tables = pad_words(np.concatenate([pack_bitmap(self.bits_a),
                                           pack_bitmap(self.bits_b)]))
        return tables, OthelloTable(offset=0, width=len(tables), ma=self.ma,
                                    mb=self.mb, seed=self.seed)

    @property
    def bits(self) -> int:
        return self.ma + self.mb
