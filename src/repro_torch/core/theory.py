"""Chain-rule theory for general membership problems (paper §2).

All space quantities are *bits per positive item* unless noted. ``f(eps, lam)``
is the unified lower bound of Theorem 2.1; ``chain_rule_gap`` numerically
verifies the lossless factorization of Theorem 2.2. Pure math, kept as a
copy of the JAX package's module so that the port imports nothing of it;
``ChainedFilterAnd.build`` (ε > 0) reads ``corollary_4_1_space``.
"""
from __future__ import annotations

import math

LN2 = math.log(2.0)


def entropy(p: float) -> float:
    """Shannon entropy H(p) in bits."""
    if p <= 0.0 or p >= 1.0:
        return 0.0
    return -p * math.log2(p) - (1.0 - p) * math.log2(1.0 - p)


def f_lower_bound(eps: float, lam: float) -> float:
    """Theorem 2.1: space lower bound f(eps, lam) in bits per positive item.

    f(eps,lam) = (lam+1) H(1/(lam+1)) - (eps*lam+1) H(1/(eps*lam+1)).

    Extreme cases: f(eps, +inf) -> log2(1/eps); f(0, lam) = (lam+1)H(1/(lam+1)).
    """
    if not (0.0 <= eps <= 1.0):
        raise ValueError(f"eps must be in [0,1], got {eps}")
    if lam < 0.0:
        raise ValueError(f"lam must be >= 0, got {lam}")

    def g(t: float) -> float:  # (t+1) H(1/(t+1))
        if t <= 0.0:
            return 0.0
        return (t + 1.0) * entropy(1.0 / (t + 1.0))

    return g(lam) - g(eps * lam)


def chain_rule_gap(eps: float, lam: float, eps_prime: float) -> float:
    """| f(eps,lam) - [f(eps',lam) + f(eps/eps', eps'*lam)] | (Theorem 2.2).

    Identically ~0 for any eps' in [eps, 1] — the factorization is lossless.
    """
    if not (eps <= eps_prime <= 1.0):
        raise ValueError("need eps <= eps' <= 1")
    lhs = f_lower_bound(eps, lam)
    rhs = f_lower_bound(eps_prime, lam) + f_lower_bound(eps / eps_prime, eps_prime * lam)
    return abs(lhs - rhs)


# ---------------------------------------------------------------------------
# ChainedFilter space models (paper §4)
# ---------------------------------------------------------------------------

def optimal_eps_prime_exact(lam: float) -> float:
    """Optimal stage-1 fpr for the exact ('&') ChainedFilter: 1/(lam ln 2)."""
    if lam <= 1.0 / LN2:
        return 1.0  # degenerates to exact Bloomier only
    return 1.0 / (lam * LN2)


def chained_and_space_exact(lam: float, C: float = 1.13) -> float:
    """Un-rounded space model: C log2(2 e lam ln 2) bits/item (Sec 4.1)."""
    if lam <= 1.0 / LN2:
        return C * (lam + 1.0)
    return C * math.log2(2.0 * math.e * lam * LN2)


def chained_and_space_exact_rounded(lam: float, C: float = 1.13) -> float:
    """Rounded space (Remark of Thm 4.1): C (⌊log λ⌋ + 1 + λ/2^⌊log λ⌋)."""
    if lam <= 1.0:
        return C * (lam + 1.0)
    k = math.floor(math.log2(lam))
    return C * (k + 1.0 + lam / (2.0 ** k))


def chained_cascade_space_exact(lam: float, C_prime: float = 1.0 / LN2 * 1.0) -> float:
    """'&~' cascade space (Thm 4.3): inf = C' log2(4 e lam) bits/item."""
    return C_prime * math.log2(4.0 * math.e * max(lam, 1.0))


def exact_bloomier_space(lam: float, C: float = 1.13) -> float:
    """Exact Bloomier filter alone: C (lam + 1) bits per positive item."""
    return C * (lam + 1.0)


def corollary_4_1_space(eps: float, lam: float, C: float = 1.13
                        ) -> tuple[float, str, float]:
    """General (eps != 0) two-Bloomier ChainedFilter space (Corollary 4.1).

    Returns (bits_per_item, strategy, beta) with strategy in
    {'a','b','approx','exact'}; beta is the stage-2 budget (bits/item - 1).
    """
    # strategy (a): P[h=1]=1/2  — valid when 1/ln2 < lam < 1/(2 eps ln2)
    beta_a = 1.0 / LN2 - 2.0 * lam * eps
    if lam > 1.0 / LN2 and (eps == 0.0 or lam < 1.0 / (2.0 * eps * LN2)):
        fa = C * (math.log2(2.0 * math.e * lam * LN2) - 2.0 * lam * eps)
    else:
        fa = math.inf
    # strategy (b): P[h=1]=1 — valid when lam > 1/(ln2 - eps) > 0
    el = eps * lam
    beta_b = 1.0 / LN2 - el / (el + 1.0)
    if eps < LN2 and lam > 1.0 / (LN2 - eps):
        fb = C * (math.log2(2.0 * math.e * lam * LN2 / (el + 1.0)) - el / (el + 1.0))
    else:
        fb = math.inf
    # degenerate single-filter fallbacks
    f_approx = C * math.log2(1.0 / eps) if eps > 0 else math.inf
    f_exact = C * (lam + 1.0)
    best = min(fa, fb, f_approx, f_exact)
    name = {fa: "a", fb: "b", f_approx: "approx", f_exact: "exact"}[best]
    beta = {"a": beta_a, "b": beta_b}.get(name, 0.0)
    return best, name, max(0.0, beta)


def huffman_overhead_bound() -> float:
    """Theorem 5.1 constant: ChainedFilter RA-Huffman ≤ H(p) + 0.22 bits."""
    return 0.22


def cuckoo_lambda(r: float) -> float:
    """Theorem 5.2: negative-positive ratio for cuckoo tables at load r.

    lambda = (2r / (1 - e^{-2r}) - 1)^{-1}; positives = items resident in
    table T2, negatives = items resident in table T1.
    """
    if not (0.0 < r < 0.5):
        raise ValueError("load factor must be in (0, 0.5)")
    return 1.0 / (2.0 * r / (1.0 - math.exp(-2.0 * r)) - 1.0)
