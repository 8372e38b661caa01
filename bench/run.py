"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``). The last line of standard output is the
result as one JSON object; the numbers compared with the reference close
standard error, each beside its limit. ``--control 1`` puts the
reference's control in the program's place (its result must read
``correct: false``); the benchmark's own runs leave it off.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _setup_env() -> None:
    """Kernel caches at fixed paths inside the checkout; no JAX."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    from bench.harness import cell
    try:
        spec = cell.load_spec(ROOT, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise cell.RunError("no CUDA device: this benchmark runs on the card", 2)
        if torch.cuda.device_count() < int(spec.cell["chips"]):
            raise cell.RunError(
                f"{spec.cell['chips']} cards wanted, "
                f"{torch.cuda.device_count()} present", 2)
        result = cell.execute(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START, control=bool(args.control),
                              log=print)
    except cell.RunError as exc:
        print(f"bench: {exc}", file=sys.stderr, flush=True)
        return exc.code
    except FileNotFoundError as exc:
        print(f"bench: {exc}", file=sys.stderr, flush=True)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
