"""Packed-table descriptors for the FilterBank serving path (§5.2).

Every filter in this repo is, physically, one or more uint32 arrays plus a
handful of static integers (sizes, seeds, hash modes). ``to_tables()`` on a
filter flattens it into a single 128-word-aligned uint32 buffer and a frozen
*layout descriptor* recording where each sub-table starts (``offset``, in
words) and the probe parameters, with enough metadata for ``from_tables()``
to reconstruct a filter object with bit-identical query behaviour.

Packing N heterogeneous filters is then pure concatenation: shift each
layout by the running word cursor (``shift``) and concatenate the buffers.
The result is ONE device buffer serving every filter — the paper's §5.2
"shared address" locality trick lifted from cache lines to the card's L2.
The descriptors and the packing are the JAX package's, field for field,
so a bank packed by either package is byte-identical; ``layout_from_dict``
rebuilds a descriptor from another package's ``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

TABLE_ALIGN = 128   # words; the JAX package's alignment, kept for
                    # byte-identical banks (512 B: whole L2 sectors here)


def pad_words(table: np.ndarray, multiple: int = TABLE_ALIGN) -> np.ndarray:
    """Pad a uint32 table to a whole number of ``multiple``-word chunks."""
    table = np.asarray(table, dtype=np.uint32)
    pad = (-len(table)) % multiple
    if pad:
        table = np.concatenate([table, np.zeros(pad, dtype=np.uint32)])
    return table


# ---------------------------------------------------------------------------
# leaf descriptors — one physical uint32 table each
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BloomTable:
    """Bloom bitmap: ``width`` uint32 words at ``offset`` (m_bits packed)."""
    offset: int
    width: int
    m_bits: int
    k: int
    seed: int

    def shift(self, delta: int) -> "BloomTable":
        return dataclasses.replace(self, offset=self.offset + delta)


@dataclass(frozen=True)
class XorTable:
    """BloomierTable slots (XOR filter): α-bit values in uint32 slots."""
    offset: int
    width: int
    mode: str
    seed: int
    seg_len: int
    n_seg: int
    alpha: int
    fp_seed: int

    def shift(self, delta: int) -> "XorTable":
        return dataclasses.replace(self, offset=self.offset + delta)


@dataclass(frozen=True)
class ExactTable:
    """1-bit exact Bloomier (strategy 'a'/'b') slots."""
    offset: int
    width: int
    mode: str
    seed: int
    seg_len: int
    n_seg: int
    strategy: str
    bit_seed: int

    def shift(self, delta: int) -> "ExactTable":
        return dataclasses.replace(self, offset=self.offset + delta)


@dataclass(frozen=True)
class OthelloTable:
    """Othello 1-bit classifier: bitmaps A and B packed LSB-first into one
    uint32 run (A's ⌈ma/32⌉ words, then B's ⌈mb/32⌉ words) at ``offset``."""
    offset: int
    width: int
    ma: int
    mb: int
    seed: int

    @property
    def offset_b(self) -> int:
        return self.offset + (self.ma + 31) // 32

    def shift(self, delta: int) -> "OthelloTable":
        return dataclasses.replace(self, offset=self.offset + delta)


# ---------------------------------------------------------------------------
# composite descriptors — filter stacks over several leaf tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainedAndLayout:
    """ChainedFilterAnd = optional stage-1 XorTable ∧ stage-2 ExactTable."""
    xor: XorTable | None
    exact: ExactTable
    eps: float
    n_pos: int
    n_neg: int
    n_false_pos: int

    def shift(self, delta: int) -> "ChainedAndLayout":
        return dataclasses.replace(
            self,
            xor=None if self.xor is None else self.xor.shift(delta),
            exact=self.exact.shift(delta))

    @property
    def width(self) -> int:
        return (0 if self.xor is None else self.xor.width) + self.exact.width


@dataclass(frozen=True)
class CascadeLayout:
    """ChainedFilterCascade = ordered Bloom layers, first-zero parity rule."""
    layers: tuple[BloomTable, ...]
    n_pos: int
    n_neg: int
    delta: float

    def shift(self, delta: int) -> "CascadeLayout":
        return dataclasses.replace(
            self, layers=tuple(t.shift(delta) for t in self.layers))

    @property
    def width(self) -> int:
        return sum(t.width for t in self.layers)

    def probe_params(self) -> tuple[tuple[int, int, int, int], ...]:
        """Static per-layer (m_bits, k, seed, offset) for the fused kernel."""
        return tuple((t.m_bits, t.k, t.seed, t.offset) for t in self.layers)


@dataclass(frozen=True)
class LsmChainLayout:
    """Per-SSTable ChainedFilter of the LSM store (§5.4): stage-1 XorTable
    (approximate, α-bit fingerprints) ∧ stage-2 OthelloTable (dynamic exact
    over positives ∪ stage-1 false positives)."""
    xor: XorTable | None
    oth: OthelloTable
    n_keys: int

    def shift(self, delta: int) -> "LsmChainLayout":
        return dataclasses.replace(
            self,
            xor=None if self.xor is None else self.xor.shift(delta),
            oth=self.oth.shift(delta))

    @property
    def width(self) -> int:
        return (0 if self.xor is None else self.xor.width) + self.oth.width

    def probe_params(self) -> tuple:
        """Static tagged chain descriptor for the fused ``lsm_probe`` kernel:
        ('chain', xor_params | None, othello_params)."""
        x = self.xor
        xp = (None if x is None else
              (x.mode, x.seed, x.seg_len, x.n_seg, x.alpha, x.fp_seed, x.offset))
        o = self.oth
        return ("chain", xp, (o.ma, o.mb, o.seed, o.offset, o.offset_b))


FilterLayout = (BloomTable | XorTable | ExactTable | OthelloTable
                | ChainedAndLayout | CascadeLayout | LsmChainLayout)


def concat_tables(parts: list[tuple[np.ndarray, FilterLayout]]
                  ) -> tuple[np.ndarray, tuple[FilterLayout, ...]]:
    """Concatenate per-filter (tables, layout) pairs into one packed buffer,
    shifting each layout by the running word cursor."""
    buffers: list[np.ndarray] = []
    layouts: list[FilterLayout] = []
    cursor = 0
    for tables, layout in parts:
        tables = pad_words(tables)
        buffers.append(tables)
        layouts.append(layout.shift(cursor))
        cursor += len(tables)
    packed = (np.concatenate(buffers) if buffers
              else np.zeros(TABLE_ALIGN, dtype=np.uint32))
    return packed, tuple(layouts)


_LEAF_KINDS = {c.__name__: c for c in (BloomTable, XorTable, ExactTable,
                                        OthelloTable)}


def _leaf(cls, fields):
    return None if fields is None else cls(**fields)


def layout_from_dict(kind: str, fields: dict) -> FilterLayout:
    """Rebuild a layout from its class name and ``dataclasses.asdict`` form
    (nested descriptors arrive as dicts) — the hand-off for layouts that
    another package built: ``layout_from_dict(type(lay).__name__,
    dataclasses.asdict(lay))``."""
    if kind in _LEAF_KINDS:
        return _LEAF_KINDS[kind](**fields)
    if kind == "LsmChainLayout":
        return LsmChainLayout(xor=_leaf(XorTable, fields["xor"]),
                              oth=OthelloTable(**fields["oth"]),
                              n_keys=fields["n_keys"])
    if kind == "ChainedAndLayout":
        return ChainedAndLayout(
            xor=_leaf(XorTable, fields["xor"]),
            exact=ExactTable(**fields["exact"]),
            **{k: fields[k] for k in ("eps", "n_pos", "n_neg", "n_false_pos")})
    if kind == "CascadeLayout":
        return CascadeLayout(
            layers=tuple(BloomTable(**d) for d in fields["layers"]),
            n_pos=fields["n_pos"], n_neg=fields["n_neg"],
            delta=fields["delta"])
    raise ValueError(f"unknown layout kind {kind!r}")
