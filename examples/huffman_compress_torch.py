"""Random-access Huffman coding with ChainedFilter (paper §5.2) on the
PyTorch + CUDA port: compress a skewed string, decode arbitrary positions
without touching the rest of the stream, and compare against entropy and
raw Huffman. The positions are decoded as one batch, one code depth a
probe, through the ``chained_probe`` kernel (CUDA on the card; its plain
torch version with ``--device cpu``).

    PYTHONPATH=src python examples/huffman_compress_torch.py          # the card
    PYTHONPATH=src python examples/huffman_compress_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.huffman import (RandomAccessHuffman, _pair_key,
                                      entropy_bits_per_char, exponential_text,
                                      huffman_bits_per_char)
from repro_torch.kernels import ops


def decode_batch(ra: RandomAccessHuffman, idx: np.ndarray, device) -> list:
    """``ra.decode_at(i)`` for every i of ``idx``: at code depth j, one
    probe of the (position, j) keys of the positions still undecided."""
    prefixes = [""] * len(idx)
    out: list = [None] * len(idx)
    live = np.arange(len(idx))
    for j in range(64):
        if len(live) == 0:
            return out
        keys = _pair_key(idx[live], np.full(len(live), j, np.uint64))
        bits = ops.chained_query(ra.cf, keys, device=device)
        still = []
        for t, b in zip(live.tolist(), bits.tolist()):
            prefixes[t] += "1" if b else "0"
            if prefixes[t] in ra.tree:
                out[t] = ra.tree[prefixes[t]]
            else:
                still.append(t)
        live = np.array(still, dtype=np.int64)
    raise RuntimeError("walked past max code depth — corrupt filter?")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50_000, help="characters")
    args = ap.parse_args(argv)
    text = exponential_text(8, args.n, seed=0)
    ra = RandomAccessHuffman.build(text, seed=1)

    idx = np.random.default_rng(0).integers(0, len(text), 1000).astype(np.uint64)
    got = decode_batch(ra, idx, args.device)
    assert got == [text[int(i)] for i in idx]
    assert got[:50] == [ra.decode_at(int(i)) for i in idx[:50]]
    print(f"{len(text)} chars, alphabet={len(set(text))}")
    print(f"entropy H(p):        {entropy_bits_per_char(text):.3f} bits/char")
    print(f"raw Huffman:         {huffman_bits_per_char(text):.3f} bits/char "
          "(sequential decode only)")
    print(f"ChainedFilter RA:    {ra.bits_per_char():.3f} bits/char "
          "(random access, seed-keyed confidentiality, bit-flip robust)")
    print(f"random access decode of {len(idx)} positions on {args.device}: "
          "all correct")


if __name__ == "__main__":
    main()
