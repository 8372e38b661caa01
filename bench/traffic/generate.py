"""The one traffic generator: key pools and batches from a mix's parameters.

A mix (``bench/traffic/<name>.json``) names a ``draw`` and its sizes:

- ``absent``: keys drawn uniformly from [2**63, 2**64), a range that no
  deployment key comes from (``key_universe`` draws below 2**63), so every
  key misses;
- ``stored_zipf``: stored keys, Zipf(``theta``) over their insertion ranks,
  each rank scrambled by FNV-1a 64 modulo the key count as YCSB's
  ScrambledZipfianGenerator does, so hot keys fall in every table;
- ``universe``: the deployment's whole key universe (positives, negatives
  and keys in neither), uniformly with replacement.

The pool holds ``pool_batches`` x ``batch`` keys drawn from the seed during
set-up. Batch j of a window is the contiguous slice of the pool that starts
at ``(start + j * batch) mod (len(pool) - batch + 1)``: a view, so drawing
it costs the window nothing. A window of at most ``pool_batches - 1`` calls
reads no pool key twice; a longer one wraps, and each batch after the wrap
is an earlier one shifted by a key, so no batch repeats whole.

``key_universe``, ``zipf_weights`` and ``phase_rngs`` are frozen copies of
``_key_universe``, ``_zipf_weights`` and ``_phase_rngs`` in
``repro_torch/storage/workloads.py``.
"""
from __future__ import annotations

import zlib

import numpy as np

FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 0x100000001B3
POOL_CHUNK = 1 << 24


def key_universe(n: int, seed) -> np.ndarray:
    """Distinct uint64 keys in [1, 2**63), deterministic in (n, seed)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2 ** 63, size=int(n * 1.2) + 64, dtype=np.uint64)
    keys = keys[np.sort(np.unique(keys, return_index=True)[1])]  # keep order
    while len(keys) < n:  # pragma: no cover — astronomically unlikely
        extra = rng.integers(1, 2 ** 63, size=n, dtype=np.uint64)
        keys = np.concatenate([keys, np.setdiff1d(extra, keys)])
    return keys[:n]


def zipf_weights(n: int, theta: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    return w / w.sum()


def phase_rngs(seed: int, *phases: str) -> tuple[np.random.Generator, ...]:
    """One independently seeded generator per named stream (crc32 of the
    name, never ``hash()``, whose salt differs between processes)."""
    return tuple(np.random.default_rng([seed, zlib.crc32(p.encode())])
                 for p in phases)


def phase_seed(seed: int, phase: str) -> list[int]:
    """A seed for ``key_universe`` and friends, one per named stream."""
    return [seed, zlib.crc32(phase.encode())]


def fnv1a64(x: np.ndarray) -> np.ndarray:
    """FNV-1a 64 over the eight little-endian bytes of each uint64."""
    x = np.asarray(x, dtype=np.uint64)
    h = np.full(x.shape, FNV_OFFSET_64, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i in range(8):
            h ^= (x >> np.uint64(8 * i)) & np.uint64(0xFF)
            h *= np.uint64(FNV_PRIME_64)
    return h


def draw_pool(mix: dict, keys: dict, seed: int, device: str = "cpu"
              ) -> np.ndarray:
    """``pool_batches`` x ``batch`` keys of ``mix`` over a deployment whose
    key sets are ``keys`` (``stored`` in insertion order, ``universe``).
    The uniform draws run on ``device`` from a ``torch.Generator`` seeded
    from ``seed``, a chunk at a time, since a pool of hundreds of millions
    of random reads takes tens of seconds on the host; the Zipf draw runs
    on the host."""
    size = int(mix["pool_batches"]) * int(mix["batch"])
    draw = mix["draw"]
    if draw == "stored_zipf":
        (rng,) = phase_rngs(seed, "pool")
        stored = keys["stored"]
        n = len(stored)
        cdf = np.cumsum(zipf_weights(n, float(mix["theta"])))

        def part(k):
            ranks = np.minimum(np.searchsorted(cdf, rng.random(k) * cdf[-1],
                                               side="right"), n - 1)
            return stored[(fnv1a64(ranks) % np.uint64(n)).astype(np.int64)]
    elif draw in ("absent", "universe"):
        import torch
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence(
            phase_seed(seed, "pool")).generate_state(1, np.uint64)[0]))
        if draw == "absent":
            def part(k):
                # [0, 2**63) with the top bit set: [2**63, 2**64)
                x = torch.empty(k, dtype=torch.int64, device=device)
                x.random_(generator=gen).bitwise_or_(-2 ** 63)
                return x.cpu().numpy().view(np.uint64)
        else:
            universe = torch.from_numpy(
                keys["universe"].view(np.int64)).to(device)

            def part(k):
                idx = torch.randint(0, len(universe), (k,), generator=gen,
                                    device=device)
                return universe[idx].cpu().numpy().view(np.uint64)
    else:
        raise ValueError(f"unknown draw {draw!r}")
    pool = np.empty(size, dtype=np.uint64)
    for lo in range(0, size, POOL_CHUNK):       # bounded temporaries
        hi = min(size, lo + POOL_CHUNK)
        pool[lo:hi] = part(hi - lo)
    return pool


class Batches:
    """Batch j of a window: a contiguous view of the pool."""

    def __init__(self, pool: np.ndarray, batch: int, seed: int):
        if len(pool) < batch:
            raise ValueError("the pool is smaller than one batch")
        self.pool, self.batch = pool, batch
        self.period = len(pool) - batch + 1
        (rng,) = phase_rngs(seed, "start")
        self.start = int(rng.integers(0, self.period))

    def offset(self, j: int) -> int:
        return (self.start + j * self.batch) % self.period

    def __call__(self, j: int) -> np.ndarray:
        o = self.offset(j)
        return self.pool[o:o + self.batch]
