"""Drive one cell on the CPU, as ``bench/run.py`` does but without the look
for a chip, and print the result line. For the tests:

    python bench/tests/drive.py --root <checkout> --workload <name>
        --seed <n> --seconds <s> [--trace 1] [--control 1] [--fault NAME]

``--root`` is a checkout whose ``BENCHMARK.json`` and ``bench/`` are used;
the program comes from ``src/`` beside this file's checkout. ``--fault``
breaks the program's answers where they are produced (``FAULTS``).
"""
import argparse
import json
import pathlib
import sys
import time

T_START = time.monotonic()
HERE = pathlib.Path(__file__).resolve().parents[2]


def _flip(a, i):
    a = a.copy()
    a[i] = ~a[i] if a.dtype == bool else a[i] ^ 1
    return a


def _store_fault(name):
    def wrap(get_batch):
        def call(keys):
            found, vals, reads = get_batch(keys)
            if name == "found":
                found = _flip(found, 0)
            elif name == "value":
                vals = _flip(vals, len(vals) - 1)
            elif name == "half":
                h = len(keys) // 2
                found, vals, reads = found.copy(), vals.copy(), reads.copy()
                found[h:], vals[h:], reads[h:] = False, 0, 0
            return found, vals, reads
        return call
    return wrap


def _bank_fault(name):
    def wrap(probe):
        def call(keys):
            member, probes = probe(keys)
            if name == "member":
                member = member.copy()
                member[3, 0] = ~member[3, 0]
            elif name == "admit":           # ChainedFilterAnd admits all
                member = member.copy()
                member[3] = True
            elif name == "drop":            # the Bloom filter holds nothing
                member = member.copy()
                member[0] = False
            elif name == "half":
                h = len(keys) // 2
                member, probes = member.copy(), probes.copy()
                member[:, h:], probes[:, h:] = False, 1
            return member, probes
        return call
    return wrap


FAULTS = {"lsm_store": _store_fault, "filter_bank": _bank_fault}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path[:0] = [str(root), str(HERE / "src")]
    from bench.harness import cell, deploy
    if args.fault:
        build = deploy.build_program

        def broken(cfg, data, device):
            prog = build(cfg, data, device)
            prog.call = FAULTS[prog.kind](args.fault)(prog.call)
            return prog
        deploy.build_program = broken
    result = cell.execute(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cpu", t_start=T_START,
                          control=bool(args.control), log=print)
    print(json.dumps(result), flush=True)
    print(f"modules of JAX or the JAX package at exit: "
          f"{cell.forbidden_modules()}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
