"""The benchmark of the PyTorch and CUDA port ``repro_torch``: one cell a
run (``python3 bench/run.py --workload <name> ...``), driven by
``BENCHMARK.json`` and the data files under ``bench/``."""
