"""Public probe entry points: a filter object and uint64 keys in, numpy
bool out (the JAX package's ``kernels/ops.py``). Each packs the filter's
tables onto ``device`` and launches its CUDA kernel there; ``device="cpu"``
runs the kernel's plain version instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.bloomier import ExactBloomier, XorFilter
from repro_torch.core.chained import ChainedFilterAnd, ChainedFilterCascade
from . import common
from .bloom_probe import bloom_probe
from .cascade_probe import cascade_descriptors, cascade_probe
from .chained_probe import chained_probe
from .xor_probe import exact_probe, xor_probe


def _inputs(tables: np.ndarray, keys: np.ndarray, device):
    """(bank, hi, lo) int32 tensors on ``device``."""
    device = common.as_device(device)
    hi, lo = common.key_lanes(np.asarray(keys, dtype=np.uint64), device)
    return common.to_device(tables, device), hi, lo


def _bool(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(bool)


def bloom_query(f: BloomFilter, keys: np.ndarray, device="cuda") -> np.ndarray:
    words, hi, lo = _inputs(common.pad_table(f.words), keys, device)
    return _bool(bloom_probe(words, hi, lo, m_bits=f.m_bits, k=f.k,
                             seed=f.seed))


def xor_query(f: XorFilter, keys: np.ndarray, device="cuda") -> np.ndarray:
    table, hi, lo = _inputs(common.pad_table(f.tbl.table), keys, device)
    lay = f.tbl.layout
    return _bool(xor_probe(table, hi, lo, mode=lay.mode, seed=lay.seed,
                           seg_len=lay.seg_len, n_seg=lay.n_seg,
                           alpha=f.tbl.alpha, fp_seed=f.fp_seed))


def exact_query(f: ExactBloomier, keys: np.ndarray, device="cuda") -> np.ndarray:
    table, hi, lo = _inputs(common.pad_table(f.tbl.table), keys, device)
    lay = f.tbl.layout
    return _bool(exact_probe(table, hi, lo, mode=lay.mode, seed=lay.seed,
                             seg_len=lay.seg_len, n_seg=lay.n_seg,
                             strategy=f.strategy, bit_seed=f.bit_seed))


def chained_and_params(layout) -> dict:
    """Keyword arguments of ``chained_probe`` from a ChainedAndLayout."""
    x, e = layout.xor, layout.exact
    return dict(
        l1=None if x is None else (x.mode, x.seed, x.seg_len, x.n_seg, x.offset),
        l2=(e.mode, e.seed, e.seg_len, e.n_seg, e.offset),
        alpha=0 if x is None else x.alpha,
        fp_seed=0 if x is None else x.fp_seed,
        strategy=e.strategy, bit_seed=e.bit_seed)


def chained_query(f: ChainedFilterAnd, keys: np.ndarray,
                  device="cuda") -> np.ndarray:
    tables, layout = f.to_tables()
    words, hi, lo = _inputs(tables, keys, device)
    member, _ = chained_probe(words, hi, lo, **chained_and_params(layout))
    return _bool(member)


def cascade_query(f: ChainedFilterCascade, keys: np.ndarray, device="cuda",
                  with_probes: bool = False):
    """Fused whole-cascade probe: bool member [n] (and the sequential probe
    counts [n] when ``with_probes``)."""
    tables, layout = f.to_tables()
    words, hi, lo = _inputs(tables, keys, device)
    layers = layout.probe_params()
    desc = torch.from_numpy(cascade_descriptors(layers)).to(words.device)
    member, probes = cascade_probe(words, hi, lo, desc, layers=layers)
    return (_bool(member), probes.cpu().numpy()) if with_probes else _bool(member)
