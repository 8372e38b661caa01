"""Serving entry point: batched requests through the ServeEngine with the
tiered ChainedFilter prefix cache (paper §5.4 as an LM-serving feature),
on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 24 --max-new 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import draw_modality_inputs
from repro_torch.kernels.common import as_device
from repro_torch.models import common as MC
from repro_torch.models.common import init_from_specs
from repro_torch.serving.engine import ServeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--n-prefixes", type=int, default=6,
                    help="distinct prompts; fewer = more cache reuse")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    device = as_device(args.device)

    was = MC.COMPUTE_DTYPE
    MC.set_compute_dtype(torch.float32)
    try:
        arch = get_arch(args.arch)
        m = arch.model(smoke=True)
        params = init_from_specs(
            m.param_specs(), torch.Generator(device).manual_seed(0), device)
        eng = ServeEngine(m, params, max_len=64, device=device)

        rng = np.random.default_rng(3)
        prefixes = [rng.integers(0, 64, 8).astype(np.int32)
                    for _ in range(args.n_prefixes)]
        extra = draw_modality_inputs(arch, m.cfg, 1, True, rng, device)
        reqs = [Request(rid=i, prompt=prefixes[i % len(prefixes)].copy(),
                        max_new=args.max_new) for i in range(args.requests)]
        t0 = time.perf_counter()
        eng.run(reqs, extra_inputs=extra)
        dt = time.perf_counter() - t0
    finally:
        MC.set_compute_dtype(was)
    s = eng.stats()
    toks = sum(len(r.output) for r in reqs)
    print(f"[serve] arch={args.arch} requests={len(reqs)} tokens={toks} "
          f"wall={dt:.1f}s ({toks/dt:.1f} tok/s)")
    print(f"[serve] prefix-cache: saved {s['prefill_tokens_saved_frac']*100:.0f}% "
          f"of prefill tokens; wasted tier probes "
          f"{s['wasted_probes']}/{s['lookups']} lookups; "
          f"filters {s['filter_KiB']:.1f} KiB")
    return s


if __name__ == "__main__":
    main()
