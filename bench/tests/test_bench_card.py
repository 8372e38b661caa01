"""The real entry point on the card at the tiny sizes: ``bench/run.py``
runs each cell of the tiny copy through the CUDA kernels and reads
correct. Needs a CUDA device and nvcc; skips without one."""
import json
import subprocess
import sys

import pytest

from bench.tests.conftest import REPO

CELLS = ("lsm16-chained.miss_1m", "lsm16-chained.ycsbc_64k",
         "filters-l8.probe_4m", "filters-l8.probe_64k")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_run_py_on_the_card(tiny, workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    if not (tiny / "src").exists():           # the program beside the copy
        (tiny / "src").symlink_to(REPO / "src", target_is_directory=True)
    proc = subprocess.run(
        [sys.executable, str(tiny / "bench" / "run.py"), "--workload",
         workload, "--seed", "4000000007", "--seconds", "1", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=tiny)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
