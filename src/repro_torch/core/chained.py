"""ChainedFilter — the paper's algorithmic contribution (§4).

Two combiners:

- ``ChainedFilterAnd`` (Algorithm 1, operator "&"): stage-1 approximate
  XOR/Bloomier filter with α=⌊log2 λ⌋-bit fingerprints, stage-2 exact
  1-bit Bloomier over positives ∪ stage-1 false positives. Exact
  membership in ≈ C·n·(⌊log λ⌋+1+λ/2^⌊log λ⌋) bits (< 1.11× lower bound).
  The general ε≠0 variant follows Corollary 4.1 (strategies a/b).

- ``ChainedFilterCascade`` (Algorithm 2, operator "&~"): a cascade of
  approximate filters; layer i+1 whitelists layer i's false positives.
  Query = first-zero-layer parity. Zero additional construction space,
  ≤ C'·n·log2(16λ) bits, and — key for §5.3 — *online trainable* by
  flipping bits (inserting into deeper layers) until predictions match.

Builds, host queries and online training are numpy, identical to the JAX
package's. The device probes are the CUDA kernels ``chained_probe`` and
``cascade_probe`` (``repro_torch.kernels.ops``), which take the packed
tables of ``to_tables``; no ``query_jax`` counterpart exists here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import theory
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
              eps: float = 0.0, mode: str = "fuse", C: float = 1.13,
              seed: int = 0, strategy: str = "a") -> "ChainedFilterAnd":
        pos = np.asarray(pos_keys, dtype=np.uint64)
        neg = np.asarray(neg_keys, dtype=np.uint64)
        n = max(1, len(pos))
        lam = len(neg) / n

        # stage-1 fingerprint width: log 1/eps' = ⌊log2 λ⌋ (Alg. 1 line 2)
        alpha = int(math.floor(math.log2(lam))) if lam > 1.0 else 0
        beta = 0.0
        if eps > 0.0:
            # Corollary 4.1: total budget f = α + (β+1); α = f - β - 1
            f_bits, strat, beta = theory.corollary_4_1_space(eps, lam, C=1.0)
            strategy = strat if strat in ("a", "b") else strategy
            alpha = max(0, int(round(f_bits - beta - 1.0)))

        if alpha == 0:
            f1 = None
            s_prime = neg
        else:
            f1 = XorFilter.build(pos, alpha, mode=mode, C=C, seed=seed)
            s_prime = neg[f1.query(neg)]

        if eps > 0.0 and len(s_prime) > 0:
            # stage-2 capacity β·n: encode only the first β·n false positives;
            # the rest pass stage-2 with prob 1/2 ('a') or ~1/(β+1) ('b').
            cap = int(beta * n)
            s_prime = s_prime[:cap]

        f2 = ExactBloomier.build(pos, s_prime, strategy=strategy, mode=mode,
                                 C=C, seed=seed + 1)
        return cls(f1=f1, f2=f2, eps=eps, n_pos=len(pos), n_neg=len(neg),
                   n_false_pos=len(s_prime))

    def query(self, keys: np.ndarray) -> np.ndarray:
        out = self.f2.query(keys)
        if self.f1 is not None:
            out &= self.f1.query(keys)
        return out


    def stage_queries(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(stage1_pass, stage2_needed) — for memory-access accounting:
        only stage-1 passers touch stage 2 (paper Fig 7b explanation)."""
        s1 = self.f1.query(keys) if self.f1 is not None else np.ones(len(keys), bool)
        return s1, s1  # stage-2 lookups happen exactly for stage-1 passers

    # -- packed-table interchange (FilterBank, §5.2) -------------------------
    def to_tables(self):
        from .tables import ChainedAndLayout, concat_tables
        parts = []
        xor_lay = None
        if self.f1 is not None:
            parts.append(self.f1.to_tables())
        parts.append(self.f2.to_tables())
        tables, layouts = concat_tables(parts)
        if self.f1 is not None:
            xor_lay, exact_lay = layouts
        else:
            (exact_lay,) = layouts
        return tables, ChainedAndLayout(xor=xor_lay, exact=exact_lay,
                                        eps=self.eps, n_pos=self.n_pos,
                                        n_neg=self.n_neg,
                                        n_false_pos=self.n_false_pos)

    @classmethod
    def from_tables(cls, tables: np.ndarray, layout) -> "ChainedFilterAnd":
        f1 = (None if layout.xor is None
              else XorFilter.from_tables(tables, layout.xor))
        f2 = ExactBloomier.from_tables(tables, layout.exact)
        return cls(f1=f1, f2=f2, eps=layout.eps, n_pos=layout.n_pos,
                   n_neg=layout.n_neg, n_false_pos=layout.n_false_pos)

    @property
    def bits(self) -> int:
        return (self.f1.bits if self.f1 is not None else 0) + self.f2.bits


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

    @classmethod
    def empty(cls, n_pos: int, lam: float, delta: float = 0.5,
              n_layers: int = 12, seed: int = 0) -> "ChainedFilterCascade":
        """Pre-sized empty cascade for *online* training (paper §5.3):
        layer 1 sized for n positives at fpr δ/λ, layer i ≥ 2 for n·δ^{i-1}
        expected items at fpr δ²."""
        layers = []
        fpr = min(0.5, delta / max(lam, 1.0))
        n_i = max(1, n_pos)
        for i in range(n_layers):
            from .bloom import optimal_params
            m, k = optimal_params(max(16, int(n_i)), fpr)
            layers.append(BloomFilter(m_bits=m, k=k, seed=seed * 977 + i))
            n_i = max(16, n_i * delta)
            fpr = min(0.5, delta * delta)
        return cls(layers=layers, n_pos=n_pos, n_neg=int(n_pos * lam), delta=delta)

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

    # -- online training (self-adaptive hashing, §5.3) -------------------------
    def train(self, keys: np.ndarray, labels: np.ndarray,
              max_rounds: int = 64) -> list[float]:
        """Flip mapped bits to 1 in successive layers until every key's
        prediction matches its label. Returns per-round error rates."""
        keys = np.asarray(keys, dtype=np.uint64)
        labels = np.asarray(labels, dtype=bool)
        errs: list[float] = []
        for _ in range(max_rounds):
            pred = self.query(keys)
            wrong = pred != labels
            errs.append(float(wrong.mean()))
            if not wrong.any():
                break
            # a wrong key is fixed by inserting it into the first layer that
            # rejected it (making that layer accept flips the parity)
            q = self._layer_matrix(keys[wrong])
            L = q.shape[1]
            first_zero = np.where(~q, np.arange(L)[None, :], L).min(axis=1)
            fixable = first_zero < L
            for li in range(L):
                sel = fixable & (first_zero == li)
                if sel.any():
                    self.layers[li].set_bits_for(keys[wrong][sel])
            if (~fixable).any():
                # saturated: every layer accepts — append a fresh layer (the
                # paper's construction iterates "until no false positives
                # remain"); the stuck keys' parity flips via the new layer.
                stuck = keys[wrong][~fixable]
                from .bloom import optimal_params
                m, k = optimal_params(max(64, len(stuck)), self.delta ** 2)
                self.layers.append(BloomFilter(m_bits=m, k=k,
                                               seed=977 * len(self.layers) + 13))
                self.layers[-1].set_bits_for(stuck)
        return errs

    # -- packed-table interchange (FilterBank, §5.2) -------------------------
    def to_tables(self):
        from .tables import CascadeLayout, concat_tables
        tables, layouts = concat_tables([f.to_tables() for f in self.layers])
        return tables, CascadeLayout(layers=layouts, n_pos=self.n_pos,
                                     n_neg=self.n_neg, delta=self.delta)

    @classmethod
    def from_tables(cls, tables: np.ndarray, layout) -> "ChainedFilterCascade":
        layers = [BloomFilter.from_tables(tables, t) for t in layout.layers]
        return cls(layers=layers, n_pos=layout.n_pos, n_neg=layout.n_neg,
                   delta=layout.delta)

    @property
    def bits(self) -> int:
        return sum(f.bits for f in self.layers)

    @property
    def n_layers(self) -> int:
        return len(self.layers)
