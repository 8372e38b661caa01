"""Each probe kernel against its plain version at the edge shapes.

``edge_bank`` packs small host-built filters of every per-table kind the
fused probe takes — two-stage chains in fuse and uniform slot layouts, a
chain without stage 1, a Bloom table and an always-read table — with
Othello and Bloom seeds of 2**31 and above, so seed arithmetic wraps
mod 2**32. ``run_edge_checks`` launches each kernel on those banks at
T ∈ {1, 16, 32} tables and counts the outputs that differ from the plain
version on the same inputs (integer outputs: exact equality). The card's
test file and ``chip_smoke.py`` both run it; the CPU parity tests probe
the same banks with the JAX package's kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.bloomier import XorFilter
from repro_torch.core.lsm import ChainedTableFilter
from repro_torch.core.othello import DynamicExactFilter
from repro_torch.core.tables import (BloomTable, LsmChainLayout, OthelloTable,
                                     concat_tables)
from . import common
from .bloom_probe import bloom_probe, bloom_probe_ref
from .lsm_probe import (chain_descriptors, lsm_chain_probe,
                        lsm_chain_probe_ref, lsm_probe, lsm_probe_ref)

KINDS = ("fuse", "uniform", "nos1", "bloom", "always")


def _filter(kind: str, t: int, own: np.ndarray, rest: np.ndarray):
    if kind == "fuse":
        return ChainedTableFilter.build(own, rest, seed1=600_000 + 31 * t,
                                        seed2=2**31 + 7 * t)
    if kind == "uniform":
        f1 = XorFilter.build(own, 6, mode="uniform", seed=900_000 + t)
        fp = rest[f1.query(rest)]
        return ChainedTableFilter(
            f1=f1, f2=DynamicExactFilter.build(own, fp, seed=2**32 - 4000 + t))
    if kind == "nos1":
        return DynamicExactFilter.build(own, rest, seed=2**31 + 11 * t)
    if kind == "bloom":
        return BloomFilter.build(own, 0.02, seed=2**31 + 5 + t)
    if kind == "always":
        return None
    raise ValueError(f"unknown table kind {kind!r}")


def chain_of(layout) -> tuple:
    """The ``lsm_probe`` descriptor of a packed per-table layout."""
    if isinstance(layout, LsmChainLayout):
        return layout.probe_params()
    if isinstance(layout, OthelloTable):
        return ("chain", None, (layout.ma, layout.mb, layout.seed,
                                layout.offset, layout.offset_b))
    if isinstance(layout, BloomTable):
        return ("bloom", (layout.m_bits, layout.k, layout.seed, layout.offset))
    raise TypeError(f"no lsm_probe descriptor for {type(layout).__name__}")


def edge_bank(kinds, per: int = 1000, seed: int = 0):
    """(bank uint32, chains, query keys, layouts) for tables of ``kinds``,
    newest first (layout None for an always-read table); the keys hold
    every table's own keys, misses and the lane extremes 0 and
    2**64-1."""
    keys = H.random_keys(per * (len(kinds) + 4), seed=seed)
    filters = [_filter(k, t, keys[t * per:(t + 1) * per],
                       keys[(t + 1) * per:(t + 4) * per])
               for t, k in enumerate(kinds)]
    tables, packed = concat_tables([f.to_tables() for f in filters
                                    if f is not None])
    packed = iter(packed)
    lays = tuple(None if f is None else next(packed) for f in filters)
    chains = tuple(("always",) if lay is None else chain_of(lay)
                   for lay in lays)
    q = np.concatenate([keys[:len(kinds) * per:2], keys[-2 * per:],
                        np.array([0, 2**64 - 1, 2**32 - 1, 2**32], np.uint64)])
    return tables, chains, q, lays


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum())


def check_lsm_probe(kinds, device, per: int = 1000, seed: int = 0) -> int:
    """Mismatching outputs of lsm_probe vs lsm_probe_ref (0 = agree)."""
    tables, chains, q, _ = edge_bank(kinds, per, seed)
    words = common.to_device(tables, device)
    hi, lo = common.key_lanes(q, device)
    desc = torch.from_numpy(chain_descriptors(chains)).to(device)
    got = lsm_probe(words, hi, lo, desc, chains=chains)
    want = lsm_probe_ref(words, hi, lo, chains=chains)
    return sum(_differ(g, w) for g, w in zip(got, want))


def check_lsm_chain_probe(kind, device, per: int = 1000, seed: int = 0) -> int:
    tables, chains, q, _ = edge_bank(("bloom", kind), per, seed)
    words = common.to_device(tables, device)
    hi, lo = common.key_lanes(q, device)
    got = lsm_chain_probe(words, hi, lo, chain=chains[1])
    want = lsm_chain_probe_ref(words, hi, lo, chain=chains[1])
    return sum(_differ(g, w) for g, w in zip(got, want))


def check_bloom_probe(device, per: int = 1000, seed: int = 0) -> int:
    tables, chains, q, _ = edge_bank(("fuse", "bloom"), per, seed)
    m_bits, k, bseed, offset = chains[1][1]
    words = common.to_device(tables, device)
    hi, lo = common.key_lanes(q, device)
    args = dict(m_bits=m_bits, k=k, seed=bseed, offset=offset)
    return _differ(bloom_probe(words, hi, lo, **args),
                   bloom_probe_ref(words, hi, lo, **args))


def edge_cases() -> list[tuple[str, str, object]]:
    """(kernel, case name, table kinds) for every edge shape."""
    mixed = ("fuse", "uniform", "nos1", "bloom", "always", "fuse", "uniform",
             "fuse")
    cases = [("lsm_probe", f"T=1 {k}", (k,)) for k in KINDS]
    cases += [("lsm_probe", "T=16 mixed", mixed * 2),
              ("lsm_probe", "T=32 mixed", mixed * 4)]
    cases += [("lsm_chain_probe", k, k) for k in ("fuse", "uniform", "nos1")]
    cases += [("bloom_probe", "seed>=2**31 offset>0", None)]
    return cases


def run_edge_checks(device, per: int = 1000) -> list[tuple[str, str, int]]:
    """(kernel, case, mismatches) for every edge case on ``device``."""
    out = []
    for kernel, name, arg in edge_cases():
        if kernel == "lsm_probe":
            bad = check_lsm_probe(arg, device, per)
        elif kernel == "lsm_chain_probe":
            bad = check_lsm_chain_probe(arg, device, per)
        else:
            bad = check_bloom_probe(device, per)
        out.append((kernel, name, bad))
    return out
