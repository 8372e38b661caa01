"""ChainedFilterAnd and ChainedFilterCascade: host numpy build and query.

Frozen copy of ``repro_torch/core/chained.py`` for the exact (eps = 0)
filters the bank serves: builds, queries and the probe counts, without
online training or the packed-table interchange.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .bloom import BloomFilter
from .bloomier import XorFilter, ExactBloomier


# ---------------------------------------------------------------------------
# Algorithm 1 — "&" version
# ---------------------------------------------------------------------------

@dataclass
class ChainedFilterAnd:
    """F(e) = F1(e) & F2(e); exact when eps=0 (zero error over the universe)."""

    f1: XorFilter | None           # None when λ too small (degenerate exact)
    f2: ExactBloomier
    eps: float
    n_pos: int
    n_neg: int
    n_false_pos: int               # |S'| actually routed to stage 2

    @classmethod
    def build(cls, pos_keys: np.ndarray, neg_keys: np.ndarray,
              mode: str = "fuse", C: float = 1.13, seed: int = 0,
              strategy: str = "a") -> "ChainedFilterAnd":
        pos = np.asarray(pos_keys, dtype=np.uint64)
        neg = np.asarray(neg_keys, dtype=np.uint64)
        n = max(1, len(pos))
        lam = len(neg) / n
        # stage-1 fingerprint width: log 1/eps' = ⌊log2 λ⌋ (Alg. 1 line 2)
        alpha = int(math.floor(math.log2(lam))) if lam > 1.0 else 0
        if alpha == 0:
            f1 = None
            s_prime = neg
        else:
            f1 = XorFilter.build(pos, alpha, mode=mode, C=C, seed=seed)
            s_prime = neg[f1.query(neg)]
        f2 = ExactBloomier.build(pos, s_prime, strategy=strategy, mode=mode,
                                 C=C, seed=seed + 1)
        return cls(f1=f1, f2=f2, eps=0.0, n_pos=len(pos), n_neg=len(neg),
                   n_false_pos=len(s_prime))

    def query(self, keys: np.ndarray) -> np.ndarray:
        out = self.f2.query(keys)
        if self.f1 is not None:
            out &= self.f1.query(keys)
        return out



# ---------------------------------------------------------------------------
# Algorithm 2 — "&~" cascade
# ---------------------------------------------------------------------------

@dataclass
class ChainedFilterCascade:
    """Cascade of Bloom filters; member(e) ⇔ first layer i with F_i(e)=0 is
    even (no zero across all L layers ⇒ member ⇔ L odd)."""

    layers: list[BloomFilter] = field(default_factory=list)
    n_pos: int = 0
    n_neg: int = 0
    delta: float = 0.5

    @classmethod
    def build(cls, pos_keys: np.ndarray, neg_keys: np.ndarray,
              delta: float = 0.5, seed: int = 0, max_layers: int = 64,
              ) -> "ChainedFilterCascade":
        pos = np.asarray(pos_keys, dtype=np.uint64)
        neg = np.asarray(neg_keys, dtype=np.uint64)
        n = max(1, len(pos))
        lam = max(1.0, len(neg) / n)

        layers: list[BloomFilter] = []
        s_t, s_f = pos, neg
        # layer 1: fpr δ/λ  (expected δ·n false positives);
        # layers ≥2: fpr δ² (space C'·n·2^{2-i} per Remark of Thm 4.3, δ=1/2)
        fpr = min(0.5, delta / lam)
        for i in range(max_layers):
            f = BloomFilter.build(s_t, fpr, seed=seed * 977 + i)
            layers.append(f)
            fp_mask = f.query(s_f)
            new_pos = s_f[fp_mask]
            if len(new_pos) == 0:
                break
            s_t, s_f = new_pos, s_t
            fpr = min(0.5, delta * delta)
        else:
            raise RuntimeError("cascade did not converge (raise space)")
        return cls(layers=layers, n_pos=len(pos), n_neg=len(neg), delta=delta)

    # -- query ----------------------------------------------------------------
    def _layer_matrix(self, keys: np.ndarray) -> np.ndarray:
        return np.stack([f.query(keys) for f in self.layers], axis=1)  # [n, L]

    def query(self, keys: np.ndarray) -> np.ndarray:
        q = self._layer_matrix(keys)
        n, L = q.shape
        first_zero = np.where(~q, np.arange(1, L + 1)[None, :], L + 1).min(axis=1)
        all_ones = first_zero == L + 1
        member = (first_zero % 2 == 0)
        member[all_ones] = (L % 2 == 1)
        return member

    def probes_until_decided(self, keys: np.ndarray) -> np.ndarray:
        """Number of layer lookups a sequential querier performs (stops at
        the first zero). Memory-access accounting for §5.3/§5.4."""
        q = self._layer_matrix(keys)
        n, L = q.shape
        first_zero = np.where(~q, np.arange(1, L + 1)[None, :], L + 1).min(axis=1)
        return np.minimum(first_zero, L)


    @property
    def n_layers(self) -> int:
        return len(self.layers)
