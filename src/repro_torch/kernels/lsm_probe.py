"""Fused multi-SSTable LSM filter probe (paper §5.4): CUDA kernel + plain
torch version.

An LSM point query probes every SSTable's filter newest→oldest and — with
per-table exact ChainedFilters — reads at most ONE table (the first hit;
Fig 11b). ``lsm_probe`` evaluates ALL tables' filters for a key batch in
one kernel launch over the generation's packed bank (stage-1 Xor slots +
stage-2 Othello bitmaps, or Bloom bitmaps, in one 128-word-aligned uint32
buffer), and emits per key:

- ``first_hit``  int32 — newest-first index of the first table whose filter
  fires, or T when none does. Under the chain rule this is the ONLY table a
  querier reads (≤ 1 wasted read per query).
- ``hits_mask``  int32 — bit t set iff table t's filter fired (T ≤ 32; bit
  31 makes the value negative). Baseline read policies (per-table Bloom:
  read every fired table) are rebuilt from it on the host.

``chains`` is a tuple of tagged per-table descriptors, newest first (the
JAX package's, unchanged):

  ('chain', xor_params | None, oth_params)  — two-stage ChainedFilter
      xor_params = (mode, seed, seg_len, n_seg, alpha, fp_seed, offset)
      oth_params = (ma, mb, seed, offset_a, offset_b)
  ('bloom', (m_bits, k, seed, offset))      — per-table Bloom baseline
  ('always',)                               — no filter (always read)

The CUDA kernel takes the tables as one int32 [T, DESC_K] descriptor
array (``chain_descriptors``) holding every table's tag and fields, so a
new generation needs new inputs, never a new build. ``pack_chain_params``
(the JAX package's per-generation params lanes) is kept byte-identical
for host parity only; no kernel reads it.

On a CUDA tensor ``lsm_probe`` launches one of two hand-written paths
and counts the launch, in ``launches`` and in ``window_launches`` or
``gather_launches``: the window path (``csrc/lsm_window.cu``, stage 1
probed from fuse windows copied into shared memory) wherever
``lsm_window.path_reason`` sends the bank and batch there, the gather
path (``csrc/lsm_probe.cu``, one thread per key) everywhere else. Both
give the same bits. ``lsm_probe_window`` and ``lsm_probe_gather`` call
one path directly. ``lsm_chain_probe`` (one table) has the gather kernel
only. On a CPU tensor each wrapper runs its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing as H
from repro_torch.core.hashing import MASK32
from . import _build, lsm_window
from .common import bloom_hit, check_probe_args, othello_hit, xor_lookup

MAX_TABLES = 32     # hits_mask is an int32 bitmask

_N_FIELDS = 11      # params rows per chain group, see pack_chain_params

# kernel descriptor row, int32 [DESC_K] (uint32 bit patterns):
#   0 tag  1 has stage 1  2 fuse
#   chain:  3 stage-1 seed  4 seg_len  5 max(n_seg-2, 1)  6 stage-1 offset
#           7 alpha mask  8 fingerprint seed (3..8 zero without stage 1)
#           9 ma  10 mb  11 othello seed  12 offset A  13 offset B
#   bloom:  3 m_bits  4 k  5 seed  6 offset
DESC_K = 16
TAG_CHAIN, TAG_BLOOM, TAG_ALWAYS = 0, 1, 2
_MODES = ("uniform", "fuse")


def _group_chains(chains: tuple) -> tuple[dict, list]:
    """Partition table indices: two-stage chains grouped by slot-layout
    mode, everything else (bloom / always / chain without stage 1) apart.
    Sets the field order of ``pack_chain_params``, as the JAX package's
    does."""
    groups: dict[str, list[int]] = {}
    scalar: list[int] = []
    for t, chain in enumerate(chains):
        if chain[0] == "chain" and chain[1] is not None:
            groups.setdefault(chain[1][0], []).append(t)
        else:
            scalar.append(t)
    return groups, scalar


def chain_params_len(chains: tuple) -> int:
    """Length of the packed params vector ``pack_chain_params`` produces for
    ``chains`` (128-word padded)."""
    groups, _ = _group_chains(chains)
    flat = sum(_N_FIELDS * len(ts) for ts in groups.values())
    return max(128, flat + ((-flat) % 128)) if flat else 128


def pack_chain_params(chains: tuple) -> np.ndarray:
    """Column-major per-group field vectors, one contiguous uint32 block per
    group in ``_group_chains`` iteration order — the per-generation params
    array, packed once and frozen by a published ``Generation``."""
    groups, _ = _group_chains(chains)
    blocks = []
    for _, ts in groups.items():
        xs = [chains[t][1] for t in ts]
        os_ = [chains[t][2] for t in ts]
        cols = [
            [x[1] for x in xs],                 # stage-1 seed
            [x[2] for x in xs],                 # seg_len
            [x[6] for x in xs],                 # stage-1 word offset
            [(1 << x[4]) - 1 for x in xs],      # alpha mask
            [x[5] for x in xs],                 # fingerprint seed
            [max(x[3] - 2, 1) for x in xs],     # n_seg - 2 (fuse window)
            [o[2] for o in os_],                # othello seed
            [o[0] for o in os_],                # ma
            [o[1] for o in os_],                # mb
            [o[3] for o in os_],                # bitmap-A word offset
            [o[4] for o in os_],                # bitmap-B word offset
        ]
        blocks.append(np.asarray(cols, dtype=np.uint32).reshape(-1))
    if not blocks:
        return np.zeros(128, np.uint32)
    flat = np.concatenate(blocks)
    pad = (-len(flat)) % 128
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint32)])
    return flat


def desc_row(chain: tuple) -> list[int]:
    """One table's kernel descriptor row (see DESC_K) as uint32 values."""
    row = [0] * DESC_K
    tag = chain[0]
    if tag == "chain":
        _, xp, op = chain
        if xp is not None:
            mode, seed, seg_len, n_seg, alpha, fp_seed, offset = xp
            if mode not in _MODES:
                raise ValueError(f"unknown slot-layout mode {mode!r}")
            row[1:9] = [1, _MODES.index(mode), seed, seg_len,
                        max(n_seg - 2, 1), offset, (1 << alpha) - 1, fp_seed]
        row[9:14] = op
    elif tag == "bloom":
        row[0] = TAG_BLOOM
        row[3:7] = chain[1]
    elif tag == "always":
        row[0] = TAG_ALWAYS
    else:
        raise ValueError(f"unknown chain tag {tag!r}")
    return [int(v) & MASK32 for v in row]


def chain_descriptors(chains: tuple) -> np.ndarray:
    """int32 [T, DESC_K] kernel descriptors of ``chains`` (uint32 bit
    patterns), one ``desc_row`` per table."""
    rows = [desc_row(c) for c in chains]
    return np.array(rows, np.uint32).reshape(len(chains), DESC_K).view(np.int32)


def _check_chains(chains: tuple) -> None:
    if len(chains) == 0 or len(chains) > MAX_TABLES:
        raise ValueError(f"need 1..{MAX_TABLES} tables, got {len(chains)}")


# ---------------------------------------------------------------------------
# plain versions (torch, int64-carried uint32 lanes)
# ---------------------------------------------------------------------------

def _chain_stage1(words, hi, lo, xor_params) -> torch.Tensor:
    """Stage-1 α-bit fingerprint match (None ⇒ pass-all)."""
    if xor_params is None:
        return torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    mode, seed, seg_len, n_seg, alpha, fp_seed, offset = xor_params
    v = xor_lookup(words, hi, lo, mode=mode, seed=seed, seg_len=seg_len,
                   n_seg=n_seg, alpha=alpha, offset=offset)
    return v == (H.t_hash_u32(hi, lo, fp_seed) & ((1 << alpha) - 1))


def _table_hit(words, hi, lo, chain) -> torch.Tensor:
    """One table's filter decision for the whole key batch -> bool."""
    tag = chain[0]
    if tag == "chain":
        _, xor_params, (ma, mb, seed, off_a, off_b) = chain
        return (_chain_stage1(words, hi, lo, xor_params)
                & othello_hit(words, hi, lo, ma=ma, mb=mb, seed=seed,
                              offset_a=off_a, offset_b=off_b))
    if tag == "bloom":
        _, (m_bits, k, seed, offset) = chain
        return bloom_hit(words, hi, lo, m_bits=m_bits, k=k, seed=seed,
                         offset=offset)
    if tag == "always":
        return torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    raise ValueError(f"unknown chain tag {tag!r}")


def lsm_probe_ref(words, hi, lo, *, chains: tuple
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``lsm_probe`` -> (first_hit, hits_mask) int32 of
    hi's shape."""
    _check_chains(chains)
    n = len(chains)
    stack = torch.stack([_table_hit(words, hi, lo, c) for c in chains]
                        ).to(torch.int64)                # [T, *hi.shape]
    t_lane = torch.arange(n, device=hi.device).reshape((n,) + (1,) * hi.dim())
    mask = (stack << t_lane).sum(dim=0)
    mask = torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask)
    # argmax returns the first maximal index: the newest table that fired
    first = torch.where(stack.any(dim=0), stack.argmax(dim=0),
                        torch.full_like(mask, n))
    return first.to(torch.int32), mask.to(torch.int32)


def lsm_chain_probe_ref(words, hi, lo, *, chain: tuple
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``lsm_chain_probe`` -> (member, probes) int32."""
    _, xor_params, (ma, mb, seed, off_a, off_b) = chain
    s1 = _chain_stage1(words, hi, lo, xor_params)
    s2 = othello_hit(words, hi, lo, ma=ma, mb=mb, seed=seed,
                     offset_a=off_a, offset_b=off_b)
    member = (s1 & s2).to(torch.int32)
    probes = (torch.ones_like(member) if xor_params is None
              else 1 + s1.to(torch.int32))
    return member, probes


# ---------------------------------------------------------------------------
# wrappers: a CUDA kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_lsm_args(words, hi, lo, desc, chains) -> None:
    _check_chains(chains)
    check_probe_args(words, hi, lo)
    check_probe_args(words, desc)
    if desc.shape != (len(chains), DESC_K):
        raise ValueError(f"desc must be [{len(chains)}, {DESC_K}], "
                         f"got {list(desc.shape)}")
    if not words.is_cuda and not torch.equal(
            desc, torch.from_numpy(chain_descriptors(chains))):
        raise ValueError("desc is not chain_descriptors(chains)")


def lsm_probe(words, hi, lo, desc, *, chains: tuple
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """words: int32 [W] packed bank; hi/lo: int32 key lanes of any shape
    (e.g. the JAX package's [R, 128] blocks); desc: int32 [T, DESC_K]
    ``chain_descriptors(chains)`` on the bank's device; chains: per-table
    descriptors, newest first. Returns (first_hit, hits_mask) int32 of
    hi's shape. On the card the window path serves every probe that
    ``lsm_window.path_reason`` sends to it, the gather path every other."""
    _check_lsm_args(words, hi, lo, desc, chains)
    if not words.is_cuda:
        return lsm_probe_ref(words, hi, lo, chains=chains)
    words = words.contiguous()
    if lsm_window.path_reason(chains, hi.numel(), words.data_ptr(),
                              lsm_window.device_bytes(words.device)) is None:
        return lsm_probe_window(words, hi, lo, desc, chains=chains)
    return lsm_probe_gather(words, hi, lo, desc, chains=chains)


def lsm_probe_gather(words, hi, lo, desc, *, chains: tuple
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lsm_probe``'s gather path (``lsm_probe_kernel``, one thread per
    key, every table's slots gathered from the bank) on any bank."""
    _check_lsm_args(words, hi, lo, desc, chains)
    if not words.is_cuda:
        return lsm_probe_ref(words, hi, lo, chains=chains)
    words, desc = words.contiguous(), desc.contiguous()
    hi, lo = hi.contiguous(), lo.contiguous()
    first, mask = torch.empty_like(hi), torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("lsm_probe").lsm_probe_launch(
            words.data_ptr(), desc.data_ptr(), len(chains), hi.data_ptr(),
            lo.data_ptr(), first.data_ptr(), mask.data_ptr(), hi.numel(),
            _stream(words))
    _build.check(err, "lsm_probe")
    lsm_probe.launches += 1
    lsm_probe.gather_launches += 1
    return first, mask


def lsm_probe_window(words, hi, lo, desc, *, chains: tuple
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lsm_probe``'s window path (``csrc/lsm_window.cu``) on any probe
    that its kernels serve; raises ValueError where
    ``lsm_window.window_reason`` does not admit it."""
    _check_lsm_args(words, hi, lo, desc, chains)
    words = words.contiguous()
    lsm_window.check(chains, hi.numel(), words.data_ptr())
    if not words.is_cuda:
        return lsm_window.lsm_probe_window_ref(words, hi, lo, chains=chains)
    first, mask = lsm_window.probe(
        words, hi.contiguous().reshape(-1), lo.contiguous().reshape(-1),
        desc.contiguous(), chains=chains)
    lsm_probe.launches += 1
    lsm_probe.window_launches += 1
    return first.reshape(hi.shape), mask.reshape(hi.shape)


# launches of either path, and of each
lsm_probe.launches = lsm_probe.window_launches = lsm_probe.gather_launches = 0


def lsm_chain_probe(words, hi, lo, *, chain: tuple
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-filter probe of one LsmChainLayout (``layout.probe_params()``)
    -> (member, probes) int32 of hi's shape. One table: the gather kernel
    on the card (the window path's partition costs more than one table's
    gathers save; PERF.md, Findings)."""
    check_probe_args(words, hi, lo)
    if chain[0] != "chain":
        raise ValueError(f"lsm_chain_probe takes a 'chain' descriptor, "
                         f"got {chain[0]!r}")
    if not words.is_cuda:
        return lsm_chain_probe_ref(words, hi, lo, chain=chain)
    fields = desc_row(chain)[1:14]      # has stage 1 .. offset B
    words, hi, lo = words.contiguous(), hi.contiguous(), lo.contiguous()
    member, probes = torch.empty_like(hi), torch.empty_like(hi)
    with torch.cuda.device(words.device):
        err = _build.lib("lsm_probe").lsm_chain_probe_launch(
            words.data_ptr(), hi.data_ptr(), lo.data_ptr(), member.data_ptr(),
            probes.data_ptr(), *fields, hi.numel(), _stream(words))
    _build.check(err, "lsm_chain_probe")
    lsm_chain_probe.launches += 1
    return member, probes


lsm_chain_probe.launches = 0
