"""Serve a small model with batched requests through the tiered
ChainedFilter prefix cache (paper §5.4 as a first-class serving feature),
on the PyTorch + CUDA port: the card by default, the plain versions with
``--device cpu``.

    PYTHONPATH=src python examples/serve_lm_torch.py              # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_main(["--arch", "llama3.2-1b", "--requests", "24",
                       "--max-new", "8", "--n-prefixes", "6",
                       "--device", args.device])


if __name__ == "__main__":
    main()
