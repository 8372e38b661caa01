"""Random-access Huffman coding via ChainedFilter (paper §5.2).

Every code bit of every position is a key: (position i, depth j) → bit v_j.
Positions whose bit is 1 are positives, bit-0 pairs are negatives; the exact
ChainedFilter is then a Boolean dictionary over all (i,j) pairs. Decoding
position i walks the Huffman tree guided by membership queries — O(code
length) probes, random access, ≤ H(p)+0.22 bits/char (Theorem 5.1).

The 'optimized' mode implements the Remark of Theorem 5.1: stage-1
(⌈log λ⌉-bit) and stage-2 (2-bit) share mapped block addresses so a decode
touches j=3 memory blocks instead of 6 — the paper's locality fix.
"""
from __future__ import annotations

import heapq
import math
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from . import hashing as H
from .chained import ChainedFilterAnd


def build_huffman_code(freqs: dict) -> dict:
    """symbol -> '0101...' prefix code (canonical tie-breaking)."""
    if len(freqs) == 1:
        return {next(iter(freqs)): "0"}
    heap = [(w, i, sym) for i, (sym, w) in enumerate(sorted(freqs.items()))]
    heapq.heapify(heap)
    nxt = len(heap)
    parents: dict = {}
    while len(heap) > 1:
        w1, i1, s1 = heapq.heappop(heap)
        w2, i2, s2 = heapq.heappop(heap)
        node = f"__n{nxt}"
        # polarity: the LIGHTER child takes bit '1'. ChainedFilter encodes
        # 1-bits as positives, so skewed data yields few positives and a
        # large negative-positive ratio — the regime where the chain rule
        # saves the most space (paper §5.2's 1-'a'/1023-'b' example).
        parents[s1] = (node, "1")
        parents[s2] = (node, "0")
        heapq.heappush(heap, (w1 + w2, nxt, node))
        nxt += 1
    root = heap[0][2]
    code = {}
    for sym in freqs:
        bits, cur = [], sym
        while cur != root:
            cur, b = parents[cur]
            bits.append(b)
        code[sym] = "".join(reversed(bits))
    return code


def _pair_key(i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """(position, depth) -> uint64 key (depth in low bits, ≤ 255 levels)."""
    return (np.asarray(i, dtype=np.uint64) << np.uint64(8)) | np.asarray(j, dtype=np.uint64)


@dataclass
class RandomAccessHuffman:
    """Compressed string with O(1)-probe random access to any position."""

    cf: ChainedFilterAnd
    code: dict
    tree: dict = field(repr=False)   # prefix -> symbol (leaves)
    n_chars: int = 0

    @classmethod
    def build(cls, text: str, seed: int = 0, mode: str = "fuse") -> "RandomAccessHuffman":
        freqs = Counter(text)
        code = build_huffman_code(freqs)
        tree = {v: k for k, v in code.items()}
        pos_i, pos_j, neg_i, neg_j = [], [], [], []
        for i, ch in enumerate(text):
            for j, b in enumerate(code[ch]):
                (pos_i if b == "1" else neg_i).append(i)
                (pos_j if b == "1" else neg_j).append(j)
        pos = _pair_key(np.array(pos_i, dtype=np.uint64), np.array(pos_j, dtype=np.uint64))
        neg = _pair_key(np.array(neg_i, dtype=np.uint64), np.array(neg_j, dtype=np.uint64))
        if len(pos) == 0 or len(neg) == 0:   # degenerate single-symbol text
            cf = None
        else:
            cf = ChainedFilterAnd.build(pos, neg, eps=0.0, mode=mode, seed=seed)
        return cls(cf=cf, code=code, tree=tree, n_chars=len(text))

    def decode_at(self, i: int) -> str:
        """Random access decode of position i."""
        prefix = ""
        for j in range(64):
            if self.cf is None:
                bit = next(iter(self.code.values()))[j]
            else:
                k = _pair_key(np.array([i], np.uint64), np.array([j], np.uint64))
                bit = "1" if bool(self.cf.query(k)[0]) else "0"
            prefix += bit
            if prefix in self.tree:
                return self.tree[prefix]
        raise RuntimeError("walked past max code depth — corrupt filter?")

    def decode_range(self, start: int, stop: int) -> str:
        return "".join(self.decode_at(i) for i in range(start, stop))

    @property
    def bits(self) -> int:
        return self.cf.bits if self.cf is not None else 0

    def bits_per_char(self) -> float:
        return self.bits / max(1, self.n_chars)

    def probes_per_char_avg(self) -> float:
        """Average membership probes per decode = average code length."""
        total = sum(len(self.code[s]) for s in self.tree.values())
        return total / max(1, len(self.tree))


def exponential_text(omega: int, n_chars: int, seed: int = 0) -> str:
    """Paper §5.2.3 synthetic dataset: symbol k has weight omega^k."""
    n_sym = 1
    while omega ** n_sym < n_chars:   # symbols until cumulative mass covers n
        n_sym += 1
    weights = np.array([float(omega) ** k for k in range(n_sym)])
    p = weights / weights.sum()
    rng = np.random.default_rng(seed)
    syms = rng.choice(n_sym, size=n_chars, p=p)
    return "".join(chr(65 + int(s)) for s in syms)


def entropy_bits_per_char(text: str) -> float:
    freqs = Counter(text)
    n = len(text)
    return -sum((c / n) * math.log2(c / n) for c in freqs.values())


def huffman_bits_per_char(text: str) -> float:
    code = build_huffman_code(Counter(text))
    return sum(len(code[ch]) for ch in text) / len(text)
