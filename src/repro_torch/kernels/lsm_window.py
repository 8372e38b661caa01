"""Window path of ``lsm_probe`` (``csrc/lsm_window.cu``): which probes it
serves, its launches, and its plain torch versions.

A fuse-layout stage 1 puts a key's three slots in three consecutive
segments starting at window ``w = fastrange(hash(seed·7919+3), n_seg−2)``,
one contiguous window of ``3·seg_len`` words. The window path buckets the
batch's key-tables by (table, w) — the partition pass — then probes each
bucket's stage 1 from a copy of its window in shared memory. Bucket ids
are global: table t's windows follow those of tables 0..t−1.

``window_reason`` says where the window kernels apply, and
``path_reason`` where ``lsm_probe`` takes them: ``kernels/lsm_probe.py``
takes the window path wherever ``path_reason`` returns None and the
gather path elsewhere. No flag selects a path. ``window_reason``'s
conditions, each per table:

- a two-stage ``'chain'`` with a fuse stage 1 (a Bloom or ``always``
  table, a chain without stage 1 or a uniform layout has no window);
- its window fits the shared-memory budget: two windows (double
  buffering) in the 227 KB a block may use, less 4 KB for the kernel's
  static shared memory, so ``12·seg_len ≤ WINDOW_BYTES_MAX`` = 114,176
  bytes: seg_len 8,192 (96 KB) qualifies, 16,384 (192 KB) does not;
- its window address is 16-byte aligned (``cp.async.bulk``): the bank's
  device pointer, the stage-1 word offset and seg_len each checked;
- at most ``MAX_WINDOWS`` windows (the partition's shared histograms);
- the batch puts enough keys in its windows to pay for them. A gathered
  key reads 3 random words of stage 1, each a whole 32-byte L2 sector:
  96 bytes. Copying a window moves ``12·seg_len`` bytes for all its keys.
  Over the table's ``n_seg−2`` windows the copies cost no more than the
  gathers when ``n·96 ≥ (n_seg−2)·12·seg_len``, i.e. ``n ≥
  (n_seg−2)·seg_len/8``. This follows from the sizes; it is not a tunable.

And ``n·T < 2**31`` (int32 scratch positions). ``path_reason`` adds:

- at least ``MIN_TABLES`` tables and ``MIN_KEYS`` keys: where the window
  path was measured faster than the gather path (``chip_smoke.py``
  phase 8's crossover sweep over 500k-key tables on the H100; PERF.md,
  Findings). The sizes alone do not decide it: the partition's scatter
  and the window copies cost more than the gathers they save while the
  probed tables sit in the L2; the gather path slows once they outgrow
  it, and the window path wins from ~12 such tables on. So smaller banks
  and batches, and ``lsm_chain_probe``'s one table, stay on the gather
  path;
- the scratch (``scratch_bytes``: 12 B per key-table, held for the call)
  within ``1/SCRATCH_SHARE`` of the card's memory: the path saves about a
  seventh of the probe's device time, and may not take more memory than
  that share for it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import hashing as H
from . import _build
from .common import gather, othello_hit

SECTOR_BYTES = 32                  # the L2 sector a random 4-byte read costs
GATHER_BYTES = 3 * SECTOR_BYTES    # a key's three stage-1 gathers
WINDOW_BYTES_MAX = (227 * 1024 - 4096) // 2
MAX_WINDOWS = 512                  # csrc/lsm_window.cu kMaxWindows
UNIT_KEYS = 4096                   # csrc/lsm_window.cu kUnitKeys
ALIGN = 16                         # cp.async.bulk address and size
MIN_TABLES = 12                    # the crossover, measured (module doc)
MIN_KEYS = 1 << 20                 # the same sweep
SCRATCH_SHARE = 16                 # scratch <= the card's memory / 16


def window_reason(chains: tuple, n_keys: int, words_ptr: int = 0
                  ) -> str | None:
    """None where the window path serves ``n_keys`` keys over ``chains``
    (whose bank starts at device address ``words_ptr``); else why not."""
    if n_keys * len(chains) >= 2**31:
        return "too many key-tables for int32 scratch positions"
    if words_ptr % ALIGN:
        return "the bank's address is not 16-byte aligned"
    for t, chain in enumerate(chains):
        if chain[0] != "chain":
            return f"table {t} is {chain[0]!r}, not a chain"
        if chain[1] is None:
            return f"table {t} has no stage 1"
        mode, _, seg_len, n_seg, _, _, offset = chain[1]
        if mode != "fuse":
            return f"table {t} has a {mode} slot layout, not fuse"
        win_bytes = 12 * seg_len
        if win_bytes > WINDOW_BYTES_MAX:
            return (f"table {t}'s window ({win_bytes} B) exceeds the "
                    f"{WINDOW_BYTES_MAX} B budget")
        if (4 * offset) % ALIGN or win_bytes % ALIGN:
            return f"table {t}'s window is not 16-byte aligned"
        if n_seg - 2 > MAX_WINDOWS:
            return f"table {t} has more than {MAX_WINDOWS} windows"
        if n_keys * GATHER_BYTES < (n_seg - 2) * win_bytes:
            return (f"{n_keys} keys are too few for table {t}'s "
                    f"{n_seg - 2} windows")
    return None


def path_reason(chains: tuple, n_keys: int, words_ptr: int,
                device_bytes: int) -> str | None:
    """None where ``lsm_probe`` takes the window path for ``n_keys`` keys
    over ``chains`` on a card of ``device_bytes``; else why not."""
    why = window_reason(chains, n_keys, words_ptr)
    if why is not None:
        return why
    if len(chains) < MIN_TABLES:
        return (f"{len(chains)} tables are too few to pay for the partition "
                f"(fewer than {MIN_TABLES})")
    if n_keys < MIN_KEYS:
        return (f"{n_keys} keys are too few to pay for the partition "
                f"(fewer than {MIN_KEYS})")
    need = scratch_bytes(chains, n_keys)
    if need > device_bytes // SCRATCH_SHARE:
        return (f"the scratch ({need} B) exceeds 1/{SCRATCH_SHARE} of the "
                f"card's {device_bytes} B")
    return None


def device_bytes(device) -> int:
    """The card's memory in bytes."""
    return torch.cuda.get_device_properties(device).total_memory


def n_buckets(chains: tuple) -> int:
    return sum(c[1][3] - 2 for c in chains)


def window_words(chains: tuple) -> int:
    """Words of the largest window: one shared-memory buffer."""
    return max(3 * c[1][2] for c in chains)


def scratch_bytes(chains: tuple, n_keys: int) -> int:
    """Device bytes the window path allocates beyond its outputs: the
    key-table scratch (hi, lo, index), the bucket x unit counts, the
    bucket totals and starts, and the work counter."""
    nb, units = n_buckets(chains), math.ceil(n_keys / UNIT_KEYS)
    return 4 * (3 * n_keys * len(chains) + nb * units + 2 * nb + 1 + 1)


class Partition(NamedTuple):
    """Key-tables in bucket order: s_hi, s_lo, s_idx int32 [n·T] (uint32
    bit patterns; s_idx the key's index), bstart int32 [B+1] (bucket b
    holds positions [bstart[b], bstart[b+1]))."""
    s_hi: torch.Tensor
    s_lo: torch.Tensor
    s_idx: torch.Tensor
    bstart: torch.Tensor


def check(chains: tuple, n_keys: int, words_ptr: int = 0) -> None:
    """Raise ValueError where ``window_reason`` does not admit the probe."""
    why = window_reason(chains, n_keys, words_ptr)
    if why is not None:
        raise ValueError(f"the window path does not serve this probe: {why}")


# ---------------------------------------------------------------------------
# plain versions: the partition's torch twin and the probe replayed over it
# ---------------------------------------------------------------------------

def buckets_ref(hi, lo, chains: tuple) -> torch.Tensor:
    """Global bucket id of every key-table -> int64 [T, n]."""
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    rows, base = [], 0
    for chain in chains:
        _, seed, _, n_seg, _, _, _ = chain[1]
        rows.append(base + H.t_hash_to_range(hi, lo, seed * 7919 + 3,
                                             n_seg - 2))
        base += n_seg - 2
    return torch.stack(rows)


def partition_ref(hi, lo, chains: tuple) -> Partition:
    """Twin of the partition pass: key-tables stably sorted by bucket
    (within a bucket, by key index), as the CUDA scatter writes them."""
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    n = hi.numel()
    bucket = buckets_ref(hi, lo, chains).reshape(-1)
    order = torch.sort(bucket, stable=True).indices
    idx = order % n
    counts = torch.bincount(bucket, minlength=n_buckets(chains))
    bstart = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                         device=hi.device)
    bstart[1:] = torch.cumsum(counts, 0)
    return Partition(hi[idx], lo[idx], idx.to(torch.int32),
                     bstart.to(torch.int32))


def _replay(words, hi, lo, chains: tuple) -> torch.Tensor:
    """The probe pass over ``partition_ref``, bucket by bucket, each
    stage 1 read from its window -> hits_mask int64 [n]."""
    n = hi.numel()
    part = partition_ref(hi, lo, chains)
    mask = torch.zeros(n, dtype=torch.int64, device=hi.device)
    bstart = part.bstart.tolist()
    g = 0
    for t, (_, xp, (ma, mb, oth_seed, off_a, off_b)) in enumerate(chains):
        _, seed, seg_len, n_seg, alpha, fp_seed, offset = xp
        for w in range(n_seg - 2):
            b, e = bstart[g], bstart[g + 1]
            g += 1
            if b == e:
                continue
            win = words[offset + w * seg_len: offset + (w + 3) * seg_len]
            h, lo_, i = part.s_hi[b:e], part.s_lo[b:e], part.s_idx[b:e].long()
            v = gather(win, H.t_hash_to_range(h, lo_, seed * 7919, seg_len))
            for k in (1, 2):
                v ^= gather(win, k * seg_len + H.t_hash_to_range(
                    h, lo_, seed * 7919 + k, seg_len))
            s1 = ((v ^ H.t_hash_u32(h, lo_, fp_seed)) & ((1 << alpha) - 1)) == 0
            hit = s1 & othello_hit(words, h, lo_, ma=ma, mb=mb, seed=oth_seed,
                                   offset_a=off_a, offset_b=off_b)
            mask[i] |= hit.to(torch.int64) << t
    return mask


def lsm_probe_window_ref(words, hi, lo, *, chains: tuple
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the window path of ``lsm_probe`` -> (first_hit,
    hits_mask) int32 of hi's shape: hits OR-combined in bucket order,
    first_hit the mask's lowest set bit (T where none)."""
    mask = _replay(words, hi.reshape(-1), lo.reshape(-1), chains)
    low = mask & -mask
    first = torch.where(mask != 0, torch.log2(low.double()).round().long(),
                        torch.full_like(mask, len(chains)))
    mask = torch.where(mask >= 2**31, mask - 2**32, mask)
    return (first.to(torch.int32).reshape(hi.shape),
            mask.to(torch.int32).reshape(hi.shape))


# ---------------------------------------------------------------------------
# launches (CUDA tensors; lsm_probe.py's wrappers call ``probe``)
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def partition(hi, lo, desc, *, chains: tuple, zero_out=None,
              counter=None) -> Partition:
    """The partition pass on the card: ``hi``/``lo`` contiguous int32 key
    lanes, ``desc`` the int32 [T, DESC_K] descriptors of ``chains``. On
    the way it sets the probe pass's inputs where given: ``zero_out``
    [n] to 0 and ``counter`` [1] to 0."""
    n, n_tables, nb = hi.numel(), len(chains), n_buckets(chains)
    units = math.ceil(n / UNIT_KEYS)

    def scratch(size):
        return torch.empty(size, dtype=torch.int32, device=hi.device)

    counts, totals = scratch(nb * units), scratch(nb)
    part = Partition(scratch(n * n_tables), scratch(n * n_tables),
                     scratch(n * n_tables), scratch(nb + 1))
    with torch.cuda.device(hi.device):
        err = _build.lib("lsm_window").lsm_window_partition_launch(
            desc.data_ptr(), n_tables, hi.data_ptr(), lo.data_ptr(), n, nb,
            counts.data_ptr(), totals.data_ptr(), part.bstart.data_ptr(),
            part.s_hi.data_ptr(), part.s_lo.data_ptr(), part.s_idx.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (zero_out, counter)), _stream(hi))
    _build.check(err, "lsm_window partition")
    return part


def probe(words, hi, lo, desc, *, chains: tuple
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Partition, probe and first_hit on the card over contiguous int32
    tensors -> (first_hit, hits_mask) int32 [n]."""
    check(chains, hi.numel(), words.data_ptr())
    n, dev = hi.numel(), hi.device
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    first, mask = (torch.empty(n, dtype=torch.int32, device=dev)
                   for _ in range(2))
    part = partition(hi, lo, desc, chains=chains, zero_out=mask,
                     counter=counter)
    with torch.cuda.device(dev):
        err = _build.lib("lsm_window").lsm_window_probe_launch(
            words.data_ptr(), desc.data_ptr(), len(chains), n_buckets(chains),
            window_words(chains), part.bstart.data_ptr(),
            part.s_hi.data_ptr(), part.s_lo.data_ptr(), part.s_idx.data_ptr(),
            counter.data_ptr(), mask.data_ptr(), first.data_ptr(), n,
            _stream(words))
    _build.check(err, "lsm_window probe")
    return first, mask
