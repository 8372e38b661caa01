"""A tiny copy of the benchmark for the CPU tests: the same harness, data
files shrunk so that a run builds in seconds."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
DRIVE = REPO / "bench" / "tests" / "drive.py"

TINY_CONFIGS = {
    "lsm16-chained": {"tables": 3, "records": 6000},
    "filters-l8": {"positives": 3000, "fresh": 12000},
}
TINY_BATCH = 512


def make_tiny(root: pathlib.Path) -> pathlib.Path:
    """A checkout at ``root`` holding BENCHMARK.json and bench/ at tiny
    sizes, with the held-back entries (``bench/held_back/*.json``) merged
    in, so that every cell the harness knows runs."""
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for path in sorted((REPO / "bench" / "held_back").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key].extend(entries)
    for conf in bench["configs"]:
        path = root / conf["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CONFIGS[conf["name"]])
        if cfg["kind"] == "filter_bank":
            for spec in cfg["filters"]:
                if spec["type"] == "exact":
                    spec.update(positives=cfg["positives"] // 2,
                                negatives=cfg["positives"])
        path.write_text(json.dumps(cfg))
    for path in (root / "bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(batch=TINY_BATCH, check_rows=4 * TINY_BATCH)
        mix["keep_batches"] = min(int(mix["keep_batches"]), 4)
        path.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> pathlib.Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


def drive(root, workload, *extra, seed=3_000_000_019, seconds=0.4):
    """Run one cell on the CPU in a process of its own -> (result, stderr)."""
    proc = subprocess.run(
        [sys.executable, str(DRIVE), "--root", str(root), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds), *extra],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr
