"""Batched, filter-guarded LSM storage engine (paper §5.4) on PyTorch.

``LsmStore`` is the port of ``repro.storage.LsmStore``: memtable → flush →
size-tiered compaction, every SSTable guarded by a two-stage
ChainedFilter whose packed tables live in ONE 128-word-aligned bank on the
card, probed by the fused ``kernels.lsm_probe`` CUDA kernel (one launch for
all tables, ≤ 1 wasted SSTable read per query). Every mutation publishes
an immutable ``generation.Generation`` through one swap point, and
``snapshot()`` pins one. ``workloads`` provides the deterministic traffic
generators and the §5.4 latency accounting.
"""
from .compactor import BackgroundCompactor
from .generation import Generation, Snapshot
from .lsm_store import LsmStore, StoreStats, WriteStall, PublishHookError
from .workloads import (WorkloadOp, LatencyAccountant, uniform_write_heavy,
                        zipfian_read_heavy, mixed_read_write, crud_mixed,
                        tagged_query, run_workload)

__all__ = [
    "Generation", "Snapshot", "BackgroundCompactor",
    "LsmStore", "StoreStats", "WriteStall", "PublishHookError",
    "WorkloadOp", "LatencyAccountant",
    "uniform_write_heavy", "zipfian_read_heavy", "mixed_read_write",
    "crud_mixed", "tagged_query", "run_workload",
]
