"""Plain reference of a filter bank's probes.

Each filter is rebuilt by the frozen builders in this package from the keys
and seeds the bank is built with. For a key batch it gives each filter's
membership and the probe count the service reports: 1 for a Bloom, Xor or
exact Bloomier filter, 1 plus the stage-1 pass for a ChainedFilterAnd, and
the layers read up to the first zero for a cascade.

The control breaks the exactness the configuration states: a
ChainedFilterAnd answers by its stage 1 alone, so the negatives that pass it
read as members.
"""
from __future__ import annotations

import numpy as np

from .bloom import BloomFilter
from .bloomier import ExactBloomier, XorFilter
from .chained import ChainedFilterAnd, ChainedFilterCascade


def build_filter(spec: dict, pos: np.ndarray, neg: np.ndarray):
    kind, seed = spec["type"], int(spec["seed"])
    if kind == "bloom":
        return BloomFilter.build(pos, float(spec["fpr"]), seed=seed)
    if kind == "xor":
        return XorFilter.build(pos, int(spec["alpha"]), seed=seed)
    if kind == "exact":
        return ExactBloomier.build(pos[:int(spec["positives"])],
                                   neg[:int(spec["negatives"])], seed=seed)
    if kind == "chained_and":
        return ChainedFilterAnd.build(pos, neg, seed=seed)
    if kind == "cascade":
        return ChainedFilterCascade.build(pos, neg, seed=seed)
    raise ValueError(f"unknown filter type {kind!r}")


def answer(spec: dict, f, keys: np.ndarray, control: bool = False) -> dict:
    """member, probes and the work counts of one filter over ``keys``."""
    keys = np.asarray(keys, dtype=np.uint64)
    n, kind = len(keys), spec["type"]
    out = {"probes": np.ones(n, np.int32)}
    if kind == "bloom":
        out["member"] = f.query(keys)
        out["bit_tests"] = int(f.probes(keys).sum())
    elif kind in ("xor", "exact"):
        out["member"] = f.query(keys)
    elif kind == "chained_and":
        s1 = (f.f1.query(keys) if f.f1 is not None
              else np.ones(n, dtype=bool))
        out["member"] = s1 if control else f.query(keys)
        out["probes"] = (1 + s1).astype(np.int32)
        out["stage1_passes"] = int(s1.sum())
    elif kind == "cascade":
        out["member"] = f.query(keys)
        reach = f.probes_until_decided(keys)
        out["probes"] = reach.astype(np.int32)
        out["layers_reached"] = int(reach.sum())
        out["bit_tests"] = int(sum(
            layer.probes(keys[reach > t]).sum()
            for t, layer in enumerate(f.layers)))
    else:
        raise ValueError(f"unknown filter type {kind!r}")
    return out


def sizes(spec: dict, f) -> dict:
    """Bytes a probe reads once, and the shape its count needs."""
    kind = spec["type"]
    if kind == "bloom":
        return {"bytes": 4 * len(f.words), "k": f.k}
    if kind in ("xor", "exact"):
        return {"bytes": 4 * len(f.tbl.table), "mode": f.tbl.layout.mode,
                "hashed_target": kind == "xor" or f.strategy == "a"}
    if kind == "chained_and":
        return {"bytes": 4 * len(f.f2.tbl.table)
                + (0 if f.f1 is None else 4 * len(f.f1.tbl.table)),
                "stage1_mode": None if f.f1 is None else f.f1.tbl.layout.mode,
                "mode": f.f2.tbl.layout.mode,
                "hashed_target": f.f2.strategy == "a"}
    if kind == "cascade":
        return {"bytes": sum(4 * len(layer.words) for layer in f.layers),
                "layers": f.n_layers}
    raise ValueError(f"unknown filter type {kind!r}")
