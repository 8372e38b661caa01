"""Plain torch oracles for the filter kernels, with the JAX package's
signatures (``repro/kernels/ref.py``); each also takes the word ``offset``
of its table in a packed bank (0 = a table of its own).

They compute in int64-carried uint32 lanes over int32 tables (the
``kernels.common`` lookups) and return bool of hi's shape. The plain
version beside each CUDA kernel (``xor_probe_ref``, ``exact_probe_ref``,
``chained_probe_ref``, ``cascade_probe_ref`` in the kernel modules) is
built from these, so the recipe exists once.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing as H
from .common import bloom_hit, xor_lookup


def bloom_probe_ref(words, hi, lo, *, m_bits: int, k: int, seed: int,
                    offset: int = 0) -> torch.Tensor:
    """Bloom query oracle -> bool, any shape of (hi, lo)."""
    return bloom_hit(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                     offset=offset)


def xor_lookup_ref(table, hi, lo, *, mode: str, seed: int, seg_len: int,
                   n_seg: int, alpha: int, offset: int = 0) -> torch.Tensor:
    """BloomierTable.lookup oracle -> alpha-bit values (int64 lanes)."""
    return xor_lookup(table, hi, lo, mode=mode, seed=seed, seg_len=seg_len,
                      n_seg=n_seg, alpha=alpha, offset=offset)


def xor_probe_ref(table, hi, lo, *, mode: str, seed: int, seg_len: int,
                  n_seg: int, alpha: int, fp_seed: int,
                  offset: int = 0) -> torch.Tensor:
    """XorFilter.query oracle -> bool."""
    v = xor_lookup_ref(table, hi, lo, mode=mode, seed=seed, seg_len=seg_len,
                       n_seg=n_seg, alpha=alpha, offset=offset)
    return v == (H.t_hash_u32(hi, lo, fp_seed) & ((1 << alpha) - 1))


def exact_bloomier_ref(table, hi, lo, *, mode: str, seed: int, seg_len: int,
                       n_seg: int, strategy: str, bit_seed: int,
                       offset: int = 0) -> torch.Tensor:
    """ExactBloomier.query oracle -> bool."""
    got = xor_lookup_ref(table, hi, lo, mode=mode, seed=seed,
                         seg_len=seg_len, n_seg=n_seg, alpha=1, offset=offset)
    if strategy == "a":
        return got == (H.t_hash_u32(hi, lo, bit_seed) & 1)
    return got == 1


def chained_stages(t1, t2, hi, lo, *, l1: dict | None, l2: dict, alpha: int,
                   fp_seed: int, strategy: str, bit_seed: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(stage-1 pass, stage-2 pass) -> bool pair; stage 1 passes every key
    when ``l1`` is None (a ChainedFilterAnd without stage 1)."""
    if l1 is None:
        s1 = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    else:
        s1 = xor_probe_ref(t1, hi, lo, alpha=alpha, fp_seed=fp_seed, **l1)
    s2 = exact_bloomier_ref(t2, hi, lo, strategy=strategy, bit_seed=bit_seed,
                            **l2)
    return s1, s2


def chained_probe_ref(t1, t2, hi, lo, *, l1: dict | None, l2: dict,
                      alpha: int, fp_seed: int, strategy: str,
                      bit_seed: int) -> torch.Tensor:
    """Fused ChainedFilterAnd.query oracle: stage1 & stage2."""
    s1, s2 = chained_stages(t1, t2, hi, lo, l1=l1, l2=l2, alpha=alpha,
                            fp_seed=fp_seed, strategy=strategy,
                            bit_seed=bit_seed)
    return s1 & s2


def cascade_decide(hits: list[torch.Tensor]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """First-zero-layer parity over per-layer bool hits -> (member bool,
    first_zero int64): first_zero is the first layer (1-based) that misses,
    or L+1; member iff it is even, or L is odd when no layer misses."""
    L = len(hits)
    q = torch.stack(hits, dim=-1)
    layer = torch.arange(1, L + 1, device=q.device)
    first_zero = torch.where(~q, layer, L + 1).min(dim=-1).values
    member = torch.where(first_zero == L + 1,
                         torch.full_like(first_zero, L % 2),
                         (first_zero % 2 == 0).to(first_zero.dtype)) == 1
    return member, first_zero


def cascade_probe_ref(layer_words: list, layer_params: list, hi, lo
                      ) -> torch.Tensor:
    """ChainedFilterCascade.query oracle: first-zero-layer parity."""
    hits = [bloom_probe_ref(w, hi, lo, **p)
            for w, p in zip(layer_words, layer_params)]
    return cascade_decide(hits)[0]
