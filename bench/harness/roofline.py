"""The least time the card could take for the probes a window made.

Frozen from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, the integer-operation
counts per probe, ``chain_ops``, ``bloomier_ops``, ``bound``). Every
data-dependent count (stage-1 passes, Bloom bit tests up to the first zero
bit, cascade layers reached) comes from the benchmark's reference over the
sampled keys, never from what a kernel reports; sizes are the reference's
own tables. The bound is the larger of the compulsory bytes over the HBM
rate and the integer operations over the INT32 peak.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3. INT32: 132 SMs x 64 lanes
# a clock at the 1980 MHz maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Integer instructions each step needs, counted from csrc/: a fuse stage 1
# 108 (window start, 3 slots, fingerprint), a uniform one 83; an Othello
# stage 2 48 (only where stage 1 passes); a Bloom bit test 24 (up to the
# first zero bit); a table's fold into the mask, or a cascade layer's loop
# step, 2; each key 5 (its index, the bound check, the outputs); the hashed
# target of a Bloomier match 18 of its stage-1 cost.
OPS_STAGE1 = {"fuse": 108, "uniform": 83}
OPS_OTHELLO, OPS_BLOOM_PROBE, OPS_TABLE, OPS_KEY = 48, 24, 2, 5
OPS_TARGET_HASH = 18


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def bloomier_ops(mode: str, hashed_target: bool) -> int:
    return OPS_STAGE1[mode] - (0 if hashed_target else OPS_TARGET_HASH)


def lsm_probe(n: int, sizes: dict, passes_per_key: list) -> tuple[float, float]:
    """(bytes, ops) of one fused probe of every table for ``n`` keys: key
    lanes in, first hit and mask out, every table once."""
    tables = sizes["tables"]
    n_bytes = 16 * n + sum(t["bytes"] for t in tables)
    n_ops = (OPS_KEY + OPS_TABLE * len(tables)) * n + sum(
        OPS_STAGE1[t["mode"]] * n + OPS_OTHELLO * p * n
        for t, p in zip(tables, passes_per_key))
    return n_bytes, n_ops


def bank_probe(kind: str, n: int, size: dict, per_key: dict
               ) -> tuple[float, float]:
    """(bytes, ops) of one filter's probe kernel for ``n`` keys; ``per_key``
    holds the reference's counts over the sample divided by its keys."""
    if kind == "bloom":
        return (12 * n + size["bytes"],
                OPS_KEY * n + OPS_BLOOM_PROBE * per_key["bit_tests"] * n)
    if kind in ("xor", "exact"):
        return (12 * n + size["bytes"],
                (OPS_KEY + bloomier_ops(size["mode"], size["hashed_target"])) * n)
    if kind == "chained_and":
        s1 = (0 if size["stage1_mode"] is None
              else bloomier_ops(size["stage1_mode"], True) * n)
        passes = per_key["stage1_passes"] * n if size["stage1_mode"] else n
        return (16 * n + size["bytes"],
                OPS_KEY * n + s1
                + bloomier_ops(size["mode"], size["hashed_target"]) * passes)
    if kind == "cascade":
        return (16 * n + size["bytes"] + 16 * size["layers"],
                OPS_KEY * n + OPS_TABLE * per_key["layers_reached"] * n
                + OPS_BLOOM_PROBE * per_key["bit_tests"] * n)
    raise ValueError(f"unknown filter type {kind!r}")
