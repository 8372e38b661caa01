"""Quickstart on the PyTorch + CUDA port: the paper in 60 seconds.

Builds an exact ChainedFilter (Algorithm 1), verifies zero-error
membership, compares its size against the single exact Bloomier filter
and the information-theoretic lower bound, and runs the two-stage
``chained_probe`` kernel (CUDA on the card; its plain torch version with
``--device cpu``).

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import hashing as H, theory
from repro_torch.core.bloomier import ExactBloomier
from repro_torch.core.chained import ChainedFilterAnd
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000, help="positives")
    args = ap.parse_args(argv)
    n, lam = args.n, 8
    keys = H.random_keys(n * (lam + 1), seed=1)
    pos, neg = keys[:n], keys[n:n * (lam + 1)]

    print(f"n={n} positives, lambda={lam} ({len(neg)} negatives)")

    cf = ChainedFilterAnd.build(pos, neg, seed=7)
    assert cf.query(pos).all(), "false negative!"
    assert not cf.query(neg).any(), "false positive!"
    print(f"ChainedFilter ('&', Alg. 1): {cf.bits / n:.2f} bits/key "
          f"(stage-1 alpha={cf.f1.alpha}, {cf.n_false_pos} stage-2 whitelists)")

    eb = ExactBloomier.build(pos, neg, seed=7)
    lb = theory.f_lower_bound(0.0, lam)
    print(f"exact Bloomier alone:        {eb.bits / n:.2f} bits/key")
    print(f"space lower bound (Thm 2.1): {lb:.2f} bits/key")
    print(f"=> ChainedFilter is {cf.bits / n / lb:.2f}x the bound, "
          f"saves {(1 - cf.bits / eb.bits) * 100:.0f}% vs exact Bloomier")

    # the two-stage probe kernel against the host filter
    sample = np.concatenate([pos[:512], neg[:512]])
    got = ops.chained_query(cf, sample, device=args.device)
    assert (got == cf.query(sample)).all()
    print(f"chained_probe on {args.device} matches the host filter on "
          f"{len(sample)} keys")

    # the chain rule itself (Thm 2.2): lossless factorization
    gap = theory.chain_rule_gap(0.001, 64.0, 0.05)
    print(f"chain-rule factorization gap at (eps=1e-3, lam=64): {gap:.2e}")


if __name__ == "__main__":
    main()
