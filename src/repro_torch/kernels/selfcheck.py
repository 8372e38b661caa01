"""Each probe kernel against its plain version at the edge shapes.

``edge_bank`` packs small host-built filters of every per-table kind the
fused LSM probe takes — two-stage chains in fuse and uniform slot
layouts, a chain without stage 1, a Bloom table and an always-read table
— with Othello and Bloom seeds of 2**31 and above, so seed arithmetic
wraps mod 2**32. ``filter_case`` builds one filter of the serving path
(an α-bit Xor filter, an exact Bloomier, a ChainedFilterAnd, a cascade)
behind a Bloom table in one bank, with seeds of 2**31 and above.
``run_edge_checks`` launches each kernel on those banks (``lsm_probe``
through its wrapper and through each of its two paths) and returns
the largest absolute difference from the plain version on the same
inputs (integer outputs: 0 is exact equality); ``check_partition`` holds
the window path's partition scratch against its torch twin. The card's
test file and ``chip_smoke.py`` both run them; the CPU parity tests probe
the same banks with the JAX package's kernels.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.bloomier import ExactBloomier, XorFilter
from repro_torch.core.chained import ChainedFilterAnd, ChainedFilterCascade
from repro_torch.core.lsm import ChainedTableFilter
from repro_torch.core.othello import DynamicExactFilter
from repro_torch.core.tables import (BloomTable, LsmChainLayout, OthelloTable,
                                     concat_tables)
from . import bloom_onchip, bloomier_onchip, common, lsm_window
from .bloom_probe import (bloom_probe, bloom_probe_gather, bloom_probe_onchip,
                          bloom_probe_ref)
from .cascade_probe import (cascade_descriptors, cascade_probe,
                            cascade_probe_gather, cascade_probe_onchip,
                            cascade_probe_ref)
from .chained_probe import (chained_probe, chained_probe_gather,
                            chained_probe_onchip, chained_probe_ref)
from .lsm_probe import (chain_descriptors, lsm_chain_probe,
                        lsm_chain_probe_ref, lsm_probe, lsm_probe_gather,
                        lsm_probe_ref, lsm_probe_window)
from .ops import chained_and_params
from .xor_probe import (exact_probe, exact_probe_gather, exact_probe_onchip,
                        exact_probe_ref, xor_probe, xor_probe_gather,
                        xor_probe_onchip, xor_probe_ref)

KINDS = ("fuse", "uniform", "nos1", "bloom", "always")
FILTER_SEED = 2**31 + 12_345        # every filter seed >= 2**31


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
    """Largest absolute difference of two integer outputs (0 = equal)."""
    if a.numel() == 0 and b.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# lsm_probe's entry points: the wrapper (window path where
# lsm_window.path_reason sends the probe, else gather) or one path
LSM_PATHS = {None: lsm_probe, "window": lsm_probe_window,
             "gather": lsm_probe_gather}


def lsm_case(kinds, device, per: int = 1000, seed: int = 0,
             n: int | None = None):
    """(words, hi, lo, chains) on ``device`` of ``edge_bank(kinds)``, its
    first ``n`` query keys (all when None)."""
    tables, chains, q, _ = edge_bank(kinds, per, seed)
    hi, lo = common.key_lanes(q[:n], device)
    return common.to_device(tables, device), hi, lo, chains


def check_lsm_probe(kinds, device, per: int = 1000, seed: int = 0,
                    path: str | None = None, n: int | None = None) -> int:
    """Largest absolute error of lsm_probe (or its ``path``) against
    lsm_probe_ref (0 = agree)."""
    words, hi, lo, chains = lsm_case(kinds, device, per, seed, n)
    desc = torch.from_numpy(chain_descriptors(chains)).to(device)
    got = LSM_PATHS[path](words, hi, lo, desc, chains=chains)
    want = lsm_probe_ref(words, hi, lo, chains=chains)
    return max(_differ(g, w) for g, w in zip(got, want))


def check_lsm_chain_probe(kind, device, per: int = 1000, seed: int = 0,
                          n: int | None = None) -> int:
    words, hi, lo, chains = lsm_case(("bloom", kind), device, per, seed, n)
    got = lsm_chain_probe(words, hi, lo, chain=chains[1])
    want = lsm_chain_probe_ref(words, hi, lo, chain=chains[1])
    return max(_differ(g, w) for g, w in zip(got, want))


# the partition pass against its torch twin: (case name, edge_bank args)
PARTITION_CASES = (
    ("T=1 fuse", dict(kinds=("fuse",))),
    ("T=16 fuse", dict(kinds=("fuse",) * 16)),
    ("T=32 fuse", dict(kinds=("fuse",) * 32)),
    ("T=16 one window each, n=1", dict(kinds=("fuse",) * 16, per=2, n=1)),
    ("T=8 empty windows, n=6", dict(kinds=("fuse",) * 8, per=20, seed=1,
                                    n=6)),
)


def check_partition(kinds, device, per: int = 1000, seed: int = 0,
                    n: int | None = None) -> int:
    """Largest absolute error of the CUDA partition pass's scratch
    against ``lsm_window.partition_ref`` (0 = agree)."""
    words, hi, lo, chains = lsm_case(kinds, device, per, seed, n)
    desc = torch.from_numpy(chain_descriptors(chains)).to(device)
    got = lsm_window.partition(hi, lo, desc, chains=chains)
    want = lsm_window.partition_ref(hi, lo, chains)
    return max(_differ(g, w) for g, w in zip(got, want))


# bloom_probe's and cascade_probe's entry points: the wrapper (on-chip
# path where bloom_onchip.onchip_reason sends the probe, else gather) or
# one path
BLOOM_PATHS = {None: bloom_probe, "onchip": bloom_probe_onchip,
               "gather": bloom_probe_gather}
CASCADE_PATHS = {None: cascade_probe, "onchip": cascade_probe_onchip,
                 "gather": cascade_probe_gather}


def check_bloom_probe(device, per: int = 1000, seed: int = 0,
                      path: str | None = None) -> int:
    """A host-built Bloom table (seed >= 2**31) behind a fuse chain, so its
    offset is > 0."""
    tables, chains, q, _ = edge_bank(("fuse", "bloom"), per, seed)
    m_bits, k, bseed, offset = chains[1][1]
    words = common.to_device(tables, device)
    hi, lo = common.key_lanes(q, device)
    args = dict(m_bits=m_bits, k=k, seed=bseed, offset=offset)
    return _differ(BLOOM_PATHS[path](words, hi, lo, **args),
                   bloom_probe_ref(words, hi, lo, **args))


def bitmap_bank(sizes, seed: int, ors: int, lead: int = 128):
    """(bank uint32, offsets): random bitmaps of ``sizes`` words, each at
    a 128-word boundary after ``lead`` words of another table, about
    1 − 2**−ors of their bits set (an OR of ``ors`` random words)."""
    offsets, at = [], lead
    for n_words in sizes:
        offsets.append(at)
        at += -(-n_words // 128) * 128
    rng = np.random.default_rng(seed)
    bank = np.zeros(at, np.uint32)
    for _ in range(ors):
        bank |= rng.integers(0, 2**32, at, dtype=np.uint32)
    return bank, offsets


def _keys(n: int, seed: int) -> np.ndarray:
    extremes = np.array([0, 2**64 - 1, 2**32 - 1, 2**32], np.uint64)
    q = np.concatenate([extremes, H.random_keys(max(n - 4, 0), seed=seed)])
    return q[:n]


def check_bloom_bitmap(device, *, words: int, k: int = 8,
                       seed: int = FILTER_SEED, n: int = 5000,
                       path: str | None = "onchip") -> int:
    """A random bitmap of ``words`` words (3/4 of its bits set; m_bits 5
    short of whole words) probed by ``n`` keys against the plain version."""
    tables, (offset,) = bitmap_bank((words,), seed=seed % 997, ors=2)
    args = dict(m_bits=32 * words - 5, k=k, seed=seed, offset=offset)
    bank = common.to_device(tables, device)
    hi, lo = common.key_lanes(_keys(n, seed % 991), device)
    return _differ(BLOOM_PATHS[path](bank, hi, lo, **args),
                   bloom_probe_ref(bank, hi, lo, **args))


def synthetic_cascade(sizes, seed: int = FILTER_SEED) -> tuple:
    """(bank uint32, layers) of random layers of ``sizes`` words (15/16 of
    their bits set, so keys reach every depth): k 4 on the first, 2 on the
    others, seeds >= 2**31."""
    tables, offsets = bitmap_bank(sizes, seed=seed % 997, ors=4)
    layers = tuple((32 * w - 3, 4 if i == 0 else 2, seed + 977 * i, o)
                   for i, (w, o) in enumerate(zip(sizes, offsets)))
    return tables, layers


def check_cascade_bitmaps(device, *, sizes, n: int = 5000,
                          path: str | None = "onchip") -> int:
    tables, layers = synthetic_cascade(sizes)
    bank = common.to_device(tables, device)
    desc = torch.from_numpy(cascade_descriptors(layers)).to(device)
    hi, lo = common.key_lanes(_keys(n, 3), device)
    got = CASCADE_PATHS[path](bank, hi, lo, desc, layers=layers)
    want = cascade_probe_ref(bank, hi, lo, layers=layers)
    return max(_differ(g, w) for g, w in zip(got, want))


# the on-chip path's edges (bloom_onchip.plan): a bitmap span one
# 128-word chunk under and over what one block stages, k, n against the
# block and the grid stride, and seeds
ROOM = bloom_onchip.block_words(1)
BIG_N = 1_500_003         # several keys per thread of a full grid
BLOOM_BITMAP_CASES = (
    ("span one chunk under the one-block limit", dict(words=ROOM - 128)),
    ("span one chunk over the one-block limit", dict(words=ROOM + 128)),
    ("filters-bank Bloom size, 1.2 MB", dict(words=300_000, k=7)),
    ("k=0", dict(words=4000, k=0)),
    ("k=1", dict(words=4000, k=1)),
    ("n=1", dict(words=4000, n=1)),
    ("n=1061, not a multiple of the block", dict(words=4000, n=1061)),
    ("n=1500003, span staged", dict(words=ROOM - 128, n=BIG_N)),
    ("n=1500003, span in L2", dict(words=ROOM + 128, n=BIG_N)),
    ("seed 2**32-1", dict(words=ROOM, seed=2**32 - 1)),
)
# a cascade whose span exceeds one block: 18 halving layers from 480 KB
WIDE_CASCADE = tuple(max(128, 120_000 >> i) for i in range(18))


# -- the filter-serving path: xor, exact, chained and cascade probes ----------

CASCADE_DEPTHS = (1, 2, 5, 18)      # 18: the full-scale cascade's depth
DEEP_CASCADE = 1100                 # more layers than the kernel stages


def nested_cascade(keys: np.ndarray, n_layers: int,
                   seed: int) -> ChainedFilterCascade:
    """A cascade of ``n_layers`` Bloom layers (fpr 0.3), layer i holding
    the first max(16, ⌈n·0.8^i⌉) keys: keys stop at every depth, the first
    16 pass every layer (first_zero = L+1) and misses stop early."""
    layers = [BloomFilter.build(keys[:max(16, math.ceil(len(keys) * 0.8 ** i))],
                                0.3, seed=seed + 977 * i)
              for i in range(n_layers)]
    return ChainedFilterCascade(layers=layers, n_pos=len(keys), n_neg=0)


def filter_case(kernel: str, arg, per: int = 1000, seed: int = 0):
    """(bank uint32, layout, query keys, filter) for one filter of the
    serving path behind a small Bloom table (so its word offset is > 0):

    - ``xor_probe``: (alpha, mode), an α-bit Xor filter of ``per`` keys;
    - ``exact_probe``: strategy 'a' or 'b' over ``per`` + 2·``per`` keys;
    - ``chained_probe``: 'stage 1' (λ = 8), 'no stage 1' (λ = 1.5) or
      'eps>0' (λ = 8, ε = 0.01);
    - ``cascade_probe``: L, a ``nested_cascade`` of that depth;
    - ``bloom_probe``: the false-positive rate of a Bloom filter.

    The keys hold half the positives, ``per`` negatives (some pass a
    stage 1 and fail stage 2) and the lane extremes."""
    keys = H.random_keys(per * 10 + 8, seed=seed)
    pos, neg = keys[:per], keys[per:9 * per]
    s = FILTER_SEED
    if kernel == "xor_probe":
        alpha, mode = arg
        f = XorFilter.build(pos, alpha, mode=mode, seed=s + alpha)
    elif kernel == "exact_probe":
        f = ExactBloomier.build(pos, neg[:2 * per], strategy=arg, seed=s)
    elif kernel == "chained_probe":
        n_neg = {"stage 1": 8 * per, "no stage 1": 3 * per // 2,
                 "eps>0": 8 * per}[arg]
        f = ChainedFilterAnd.build(pos, neg[:n_neg], seed=s,
                                   eps=0.01 if arg == "eps>0" else 0.0)
    elif kernel == "cascade_probe":
        f = nested_cascade(pos, arg, s)
    elif kernel == "bloom_probe":
        f = BloomFilter.build(pos, arg, seed=s + 2)
    else:
        raise ValueError(f"no filter case for {kernel!r}")
    front = BloomFilter.build(keys[-8:], 0.1, seed=s + 1)
    tables, (_, lay) = concat_tables([front.to_tables(), f.to_tables()])
    q = np.concatenate([pos[::2], neg[-per:], keys[9 * per:],
                        np.array([0, 2**64 - 1, 2**32 - 1, 2**32], np.uint64)])
    return tables, lay, q, f


# the Bloomier probes' entry points: the wrapper (on-chip path where
# bloomier_onchip.onchip_reason sends the probe, else gather) or one path
XOR_PATHS = {None: xor_probe, "onchip": xor_probe_onchip,
             "gather": xor_probe_gather}
EXACT_PATHS = {None: exact_probe, "onchip": exact_probe_onchip,
               "gather": exact_probe_gather}
CHAINED_PATHS = {None: chained_probe, "onchip": chained_probe_onchip,
                 "gather": chained_probe_gather}


def bloomier_calls(kernel: str, a: dict, words: torch.Tensor,
                   path: str | None = None):
    """(kernel, plain version) of ``xor_probe`` / ``exact_probe`` /
    ``chained_probe`` with keyword arguments ``a`` over the bank ``words``:
    functions of (hi, lo) returning a tuple of int32 outputs."""
    if kernel == "chained_probe":
        probe = CHAINED_PATHS[path]
        return (lambda hi, lo: probe(words, hi, lo, **a),
                lambda hi, lo: chained_probe_ref(words, hi, lo, **a))
    paths, plain = ((XOR_PATHS, xor_probe_ref) if kernel == "xor_probe"
                    else (EXACT_PATHS, exact_probe_ref))
    probe = paths[path]
    return (lambda hi, lo: (probe(words, hi, lo, **a),),
            lambda hi, lo: (plain(words, hi, lo, **a),))


def bloomier_args(kernel: str, lay) -> dict:
    """The keyword arguments of a Bloomier probe of the layout ``lay``."""
    if kernel == "xor_probe":
        return dict(mode=lay.mode, seed=lay.seed, seg_len=lay.seg_len,
                    n_seg=lay.n_seg, alpha=lay.alpha, fp_seed=lay.fp_seed,
                    offset=lay.offset)
    if kernel == "exact_probe":
        return dict(mode=lay.mode, seed=lay.seed, seg_len=lay.seg_len,
                    n_seg=lay.n_seg, strategy=lay.strategy,
                    bit_seed=lay.bit_seed, offset=lay.offset)
    return chained_and_params(lay)


def filter_calls(kernel: str, lay, words: torch.Tensor,
                 path: str | None = None):
    """(kernel, plain version) of ``kernel`` on the filter at ``lay`` in
    the bank ``words``: functions of (hi, lo) returning a tuple of int32
    outputs. ``path``: the entry point (``XOR_PATHS``, ``EXACT_PATHS``,
    ``CHAINED_PATHS``, ``CASCADE_PATHS``)."""
    if kernel in ("xor_probe", "exact_probe", "chained_probe"):
        return bloomier_calls(kernel, bloomier_args(kernel, lay), words,
                              path)
    layers = lay.probe_params()
    desc = torch.from_numpy(cascade_descriptors(layers)).to(words.device)
    probe = CASCADE_PATHS[path]
    return (lambda hi, lo: probe(words, hi, lo, desc, layers=layers),
            lambda hi, lo: cascade_probe_ref(words, hi, lo, layers=layers))


def check_filter_kernel(kernel: str, arg, device, per: int = 1000,
                        seed: int = 0, path: str | None = None) -> int:
    """Largest absolute error of a filter-serving kernel against its
    plain version on ``filter_case(kernel, arg)`` (0 = agree)."""
    tables, lay, q, _ = filter_case(kernel, arg, per, seed)
    words = common.to_device(tables, device)
    hi, lo = common.key_lanes(q, device)
    kern, plain = filter_calls(kernel, lay, words, path)
    return max(_differ(g, w) for g, w in zip(kern(hi, lo), plain(hi, lo)))


def synthetic_bloomier(kernel: str, tables: tuple, seed: int = FILTER_SEED
                       ) -> tuple:
    """(bank uint32, probe keyword arguments) of random fuse Bloomier
    tables: ``tables`` = ((seg_len, n_seg, alpha), ...), one for xor (α)
    and exact (α 1, strategy a), stage 1 then stage 2 for chained (stage
    2's α is 1); seeds ≥ 2**31 (``seed``)."""
    bank, offsets = bitmap_bank([s * n for s, n, _ in tables],
                                seed=seed % 997, ors=1)
    lays = [("fuse", seed + 131 * i, s, n, o)
            for i, ((s, n, _), o) in enumerate(zip(tables, offsets))]
    keys = ("mode", "seed", "seg_len", "n_seg", "offset")
    if kernel == "xor_probe":
        return bank, dict(zip(keys, lays[0]), alpha=tables[0][2],
                          fp_seed=seed + 1)
    if kernel == "exact_probe":
        return bank, dict(zip(keys, lays[0]), strategy="a", bit_seed=seed + 2)
    return bank, dict(l1=lays[0], l2=lays[1], alpha=tables[0][2],
                      fp_seed=seed + 1, strategy="a", bit_seed=seed + 2)


def check_bloomier_tables(kernel: str, device, *, tables: tuple,
                          n: int = 5000, seed: int = FILTER_SEED,
                          path: str | None = "onchip") -> int:
    """Largest absolute error of a Bloomier probe over ``synthetic_bloomier``
    tables, ``n`` keys, against its plain version (0 = agree)."""
    bank, a = synthetic_bloomier(kernel, tables, seed)
    words = common.to_device(bank, device)
    hi, lo = common.key_lanes(_keys(n, seed % 991), device)
    kern, plain = bloomier_calls(kernel, a, words, path)
    return max(_differ(g, w) for g, w in zip(kern(hi, lo), plain(hi, lo)))


def bloomier_geometries(kernel: str, tables: tuple) -> tuple:
    """The ``bloomier_onchip.Geometry`` of each ``synthetic_bloomier``
    table (α 1 for exact and for chained stage 2)."""
    return tuple(bloomier_onchip.Geometry(
        "fuse", s, n, 1 if (i == 1 or kernel == "exact_probe") else a)
        for i, (s, n, a) in enumerate(tables))


def bloomier_plan(kernel: str, tables: tuple):
    """``bloomier_onchip.plan`` of ``synthetic_bloomier`` tables (None
    where the planes do not fit one block)."""
    return bloomier_onchip.plan(bloomier_geometries(kernel, tables))


# the Bloomier on-chip path's edges (bloomier_onchip.plan): a 1-bit plane
# at and one segment over what one block stages (16384-slot segments of
# 2 KB), the filters cell's exact table, the two planes of a chained
# filter sharing one block, 2-, 4-, 8- and 16-bit fields, the least fuse
# table (seg_len 8: 8 bits a segment, n_seg 3: one window start), n
# against the block and the grid stride, seeds; and the filters cell's Xor
# and ChainedFilterAnd (planes over one block: the gather kernels only)
ONE_BLOCK_SEGS = bloomier_onchip.BLOCK_BYTES // 2048
BLOOMIER_TABLE_CASES = (
    ("exact_probe", "plane at the one-block limit",
     dict(tables=((16384, ONE_BLOCK_SEGS, 1),))),
    ("exact_probe", "plane one segment over one block",
     dict(tables=((16384, ONE_BLOCK_SEGS + 1, 1),))),
    ("exact_probe", f"filters cell exact table (217 KB plane), n={BIG_N}",
     dict(tables=((16384, 106, 1),), n=BIG_N)),
    ("exact_probe", "filters cell exact table, n=1",
     dict(tables=((16384, 106, 1),), n=1)),
    ("exact_probe", "filters cell exact table, n=1061",
     dict(tables=((16384, 106, 1),), n=1061)),
    ("exact_probe", "least fuse table (seg_len 8, n_seg 3)",
     dict(tables=((8, 3, 1),))),
    ("xor_probe", "alpha 2, 2-bit fields", dict(tables=((4096, 100, 2),))),
    ("xor_probe", "alpha 8 at the one-block limit",
     dict(tables=((1024, 226, 8),))),
    ("xor_probe", "alpha 16, 16-bit fields",
     dict(tables=((1024, 100, 16),))),
    ("xor_probe", "alpha 3, seed 2**32-1",
     dict(tables=((8192, 50, 3),), seed=2**32 - 1)),
    ("xor_probe", "filters cell Xor alpha 8 (1.15 MB plane)",
     dict(tables=((8192, 140, 8),))),
    ("chained_probe", f"two planes in one block, n={BIG_N}",
     dict(tables=((2048, 100, 3), (8192, 100, 1)), n=BIG_N)),
    ("chained_probe", "two planes in one block, n=1061",
     dict(tables=((1024, 60, 3), (2048, 60, 1)), n=1061)),
    ("chained_probe", "filters cell ChainedFilterAnd (860 KB of planes)",
     dict(tables=((8192, 140, 3), (16384, 140, 1)))),
)


def filter_edge_cases() -> list[tuple[str, str, object]]:
    """(kernel, case name, ``filter_case`` arg) of the serving kernels."""
    cases = [("xor_probe", f"alpha={a} {m}", (a, m))
             for a in (1, 8, 32) for m in ("uniform", "fuse")]
    cases += [("exact_probe", f"strategy {s}", s) for s in ("a", "b")]
    cases += [("chained_probe", c, c)
              for c in ("stage 1", "no stage 1", "eps>0")]
    cases += [("cascade_probe", f"L={n}", n) for n in CASCADE_DEPTHS]
    return cases


# filter_case args of the Bloomier probes, for every path; alpha 17 and 32
# have no plane (gather only)
XOR_ALPHAS = (1, 3, 8, 9, 16, 17, 32)
BLOOMIER_FILTER_ARGS = (
    [("xor_probe", f"alpha={a} fuse", (a, "fuse")) for a in XOR_ALPHAS]
    + [("xor_probe", "alpha=8 uniform", (8, "uniform"))]
    + [("exact_probe", f"strategy {s} {m}", s) for s, m in
       (("a", "fuse"), ("b", "fuse"))]
    + [("chained_probe", c, c) for c in ("stage 1", "no stage 1", "eps>0")])


def bloomier_edge_cases() -> list[tuple[str, str, dict]]:
    """(kernel, case name, ``check_case`` arg) of both paths of the
    Bloomier probes (the gather kernel; the on-chip path wherever its
    planes fit one block) on ``filter_case`` filters and
    ``BLOOMIER_TABLE_CASES`` tables."""
    cases = []
    for kernel, name, arg in BLOOMIER_FILTER_ARGS:
        cases.append((kernel, f"gather {name}", dict(arg=arg, path="gather")))
        alpha = arg[0] if kernel == "xor_probe" else 1
        if bloomier_onchip.field_width(alpha) is not None:
            cases.append((kernel, f"onchip {name}",
                          dict(arg=arg, path="onchip")))
    for kernel, name, arg in BLOOMIER_TABLE_CASES:
        cases.append((kernel, f"gather {name}", dict(arg, path="gather")))
        if bloomier_plan(kernel, arg["tables"]) is not None:
            cases.append((kernel, f"onchip {name}", dict(arg, path="onchip")))
    return cases


def edge_cases() -> list[tuple[str, str, object]]:
    """(kernel, case name, argument) for every edge shape."""
    mixed = ("fuse", "uniform", "nos1", "bloom", "always", "fuse", "uniform",
             "fuse")
    cases = [("lsm_probe", f"T=1 {k}", dict(kinds=(k,))) for k in KINDS]
    cases += [("lsm_probe", "T=16 mixed", dict(kinds=mixed * 2)),
              ("lsm_probe", "T=32 mixed", dict(kinds=mixed * 4))]
    # both paths of the all-fuse banks the window path serves
    for path in ("window", "gather"):
        cases += [("lsm_probe", f"{path} T={t} fuse",
                   dict(kinds=("fuse",) * t, path=path)) for t in (1, 16, 32)]
    cases += [("lsm_probe", f"window {name}", dict(args, path="window"))
              for name, args in PARTITION_CASES if "n=" in name]
    cases += [("lsm_chain_probe", k, dict(kind=k))
              for k in ("fuse", "uniform", "nos1")]
    cases += [("lsm_chain_probe", "fuse, n=1", dict(kind="fuse", per=2, n=1))]
    cases += [("bloom_probe", "seed>=2**31 offset>0", None)]
    # both paths of bloom_probe and cascade_probe at the on-chip edges
    for path in ("onchip", "gather"):
        cases += [("bloom_probe", f"{path} seed>=2**31 offset>0",
                   dict(path=path))]
        cases += [("bloom_probe", f"{path} {name}", dict(args, path=path))
                  for name, args in BLOOM_BITMAP_CASES]
        cases += [("cascade_probe", f"{path} L={n}", dict(depth=n, path=path))
                  for n in (1, 18)]
        cases += [("cascade_probe", f"{path} L=18 span over one block",
                   dict(sizes=WIDE_CASCADE, path=path)),
                  ("cascade_probe", f"{path} L=18 staged, n={BIG_N}",
                   dict(sizes=(2000,) * 18, n=BIG_N, path=path)),
                  ("cascade_probe", f"{path} L={bloom_onchip.MAX_LAYERS}",
                   dict(sizes=(128,) * bloom_onchip.MAX_LAYERS, path=path))]
    cases += filter_edge_cases()
    cases += [("cascade_probe", f"L={DEEP_CASCADE} descriptor in global "
               "memory", DEEP_CASCADE)]
    cases += bloomier_edge_cases()
    return cases


def check_case(kernel: str, arg, device, per: int = 1000) -> int:
    """Largest absolute error of one ``edge_cases`` entry on ``device``."""
    if kernel == "lsm_probe":
        return check_lsm_probe(device=device, **{"per": per, **arg})
    if kernel == "lsm_chain_probe":
        return check_lsm_chain_probe(device=device, **{"per": per, **arg})
    if kernel == "bloom_probe":
        if arg is None or "words" not in arg:
            return check_bloom_probe(device, per, **(arg or {}))
        return check_bloom_bitmap(device, **arg)
    if kernel == "cascade_probe" and isinstance(arg, dict):
        if "sizes" in arg:
            return check_cascade_bitmaps(device, **arg)
        return check_filter_kernel(kernel, arg["depth"], device, per,
                                   path=arg["path"])
    if isinstance(arg, dict) and "tables" in arg:
        return check_bloomier_tables(kernel, device, **arg)
    if isinstance(arg, dict):
        return check_filter_kernel(kernel, arg["arg"], device, per,
                                   path=arg["path"])
    return check_filter_kernel(kernel, arg, device, per)


def run_edge_checks(device, per: int = 1000) -> list[tuple[str, str, int]]:
    """(kernel, case, max_abs_err) for every edge case on ``device``."""
    return [(kernel, name, check_case(kernel, arg, device, per))
            for kernel, name, arg in edge_cases()]
