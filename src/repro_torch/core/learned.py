"""Learned filters (paper §5.5): a learned score model in front of a backup
filter. The paper's Learned ChainedFilter (backup = exact ChainedFilter,
fpr contributed only by the model) against the classic Learned Bloom
Filter (backup = Bloom) and Learned Bloomier.

The score model is a tiny MLP trained full-batch on ``device`` with the
reference's inline Adam, its gradients from ``torch.autograd``. Its
initial weights come from a CPU ``torch.Generator`` (the card and the CPU
start from the same weights; they cannot match ``jax.random``, so the
port is held to the reference's §5.5 figures, not to its bits). Keys
carry feature vectors from a synthetic distribution with a learnable
decision surface + label noise (``synth_url_dataset``, the reference's
numpy, the same arrays). The backup filters are built and queried on the
host, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .bloom import BloomFilter
from .bloomier import XorFilter
from .chained import ChainedFilterAnd

_NAMES = ("w1", "b1", "w2", "b2")


def synth_url_dataset(n_pos: int, n_neg: int, dim: int = 16, noise: float = 0.05,
                      seed: int = 0):
    """Returns (keys uint64, features [n,dim] f32, labels bool)."""
    rng = np.random.default_rng(seed)
    n = n_pos + n_neg
    w = rng.normal(size=(dim,))
    w /= np.linalg.norm(w)
    # sample conditioned on class with margin; flip `noise` fraction
    feats = rng.normal(size=(n, dim)).astype(np.float32)
    margin = feats @ w
    order = np.argsort(-margin)
    labels = np.zeros(n, dtype=bool)
    labels[order[:n_pos]] = True
    flip = rng.random(n) < noise
    labels ^= flip
    keys = rng.integers(0, 2**63, size=n, dtype=np.uint64)
    keys = keys * np.uint64(2) + labels.astype(np.uint64)  # ensure distinct per class
    return keys, feats, labels


def _init_mlp(dim: int, hidden: int, generator: torch.Generator,
              device="cuda") -> dict:
    """Initial weights drawn from ``generator`` (a CPU generator), then
    moved to ``device``."""
    params = {
        "w1": torch.randn((dim, hidden), generator=generator)
        * (1.0 / math.sqrt(dim)),
        "b1": torch.zeros((hidden,)),
        "w2": torch.randn((hidden, 1), generator=generator)
        * (1.0 / math.sqrt(hidden)),
        "b2": torch.zeros((1,)),
    }
    return {k: v.to(device) for k, v in params.items()}


def _mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]


def _loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss of the logits against labels ``y`` (0/1 f32)."""
    lg = _mlp_logits(params, x)
    return torch.mean(torch.clamp_min(lg, 0) - lg * y
                      + torch.log1p(torch.exp(-torch.abs(lg))))


def _grads(params: dict, x: torch.Tensor, y: torch.Tensor) -> dict:
    leaves = [params[k].detach().requires_grad_() for k in _NAMES]
    g = torch.autograd.grad(_loss(dict(zip(_NAMES, leaves)), x, y), leaves)
    return dict(zip(_NAMES, g))


def _adam_step(params: dict, m: dict, v: dict, t: int, x: torch.Tensor,
               y: torch.Tensor, lr: float):
    """One step of the reference's inline Adam (β 0.9 / 0.999, ε 1e-8,
    bias correction by the step number ``t``, from 1)."""
    g = _grads(params, x, y)
    with torch.no_grad():
        m = {k: 0.9 * m[k] + 0.1 * g[k] for k in _NAMES}
        v = {k: 0.999 * v[k] + 0.001 * g[k] * g[k] for k in _NAMES}
        params = {k: params[k] - lr * (m[k] / (1 - 0.9 ** t))
                  / (torch.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
                  for k in _NAMES}
    return params, m, v


def train_score_model(feats: np.ndarray, labels: np.ndarray, hidden: int = 16,
                      steps: int = 400, lr: float = 1e-2, seed: int = 0,
                      device="cuda") -> dict:
    x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device)
    y = torch.from_numpy(labels.astype(np.float32)).to(device)
    params = _init_mlp(feats.shape[1], hidden,
                       torch.Generator().manual_seed(seed), device)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    for t in range(1, steps + 1):
        params, m, v = _adam_step(params, m, v, t, x, y, lr)
    return params


def model_scores(params: dict, feats: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
    with torch.no_grad():
        return _mlp_logits(params, x.to(params["w1"].device)).cpu().numpy()


def pick_threshold(scores_neg: np.ndarray, target_fpr: float) -> float:
    """Smallest τ s.t. P[neg score ≥ τ] ≤ target_fpr."""
    if len(scores_neg) == 0:
        return 0.0
    return float(np.quantile(scores_neg, 1.0 - target_fpr))


@dataclass
class LearnedFilter:
    """score(x) ≥ τ → positive; else consult backup over below-τ positives."""

    params: dict = field(repr=False)
    tau: float = 0.0
    backup_kind: str = "chained"       # 'chained' | 'bloom' | 'bloomier'
    backup: object = None
    model_bits: int = 0

    @classmethod
    def build(cls, keys, feats, labels, backup_kind: str = "chained",
              model_fpr: float = 0.01, backup_fpr: float = 0.005,
              train_frac: float = 1.0, seed: int = 0,
              device="cuda") -> "LearnedFilter":
        """Trains the score model on ``device`` (the card unless ``"cpu"``)."""
        n = len(keys)
        rng = np.random.default_rng(seed)
        tr = rng.random(n) < train_frac
        if tr.sum() < 32:
            tr[:] = True
        params = train_score_model(feats[tr], labels[tr], seed=seed,
                                   device=device)
        scores = model_scores(params, feats)
        tau = pick_threshold(scores[~labels], model_fpr)
        below = scores < tau
        pos_below = keys[labels & below]
        neg_below = keys[(~labels) & below]
        if backup_kind == "chained":
            backup = (ChainedFilterAnd.build(pos_below, neg_below, seed=seed)
                      if len(pos_below) and len(neg_below) else None)
        elif backup_kind == "bloomier":
            alpha = max(1, int(math.ceil(math.log2(1.0 / backup_fpr))))
            backup = XorFilter.build(pos_below, alpha, seed=seed) if len(pos_below) else None
        elif backup_kind == "bloom":
            backup = (BloomFilter.build(pos_below, backup_fpr, seed=seed)
                      if len(pos_below) else None)
        else:
            raise ValueError(backup_kind)
        model_bits = sum(p.numel() for p in params.values()) * 32
        return cls(params=params, tau=tau, backup_kind=backup_kind,
                   backup=backup, model_bits=model_bits)

    def query(self, keys: np.ndarray, feats: np.ndarray) -> np.ndarray:
        scores = model_scores(self.params, feats)
        out = scores >= self.tau
        below = ~out
        if self.backup is not None and below.any():
            out[below] = self.backup.query(np.asarray(keys, np.uint64)[below])
        return out

    @property
    def filter_bits(self) -> int:
        return self.backup.bits if self.backup is not None else 0
