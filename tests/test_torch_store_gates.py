"""The store gates of ``BENCH_baseline.json`` through the port: the
``scan_delete``, ``snapshot_compact`` and ``sustained`` benchmarks
replayed at CI scale on ``LsmStore(device="cpu")``.

Each benchmark module is run as it is, with the store, the filter
service and the workload functions it imports swapped for the port's
(``device="cpu"``). The deterministic values of the committed baseline
must come out exactly: the seeded read counts, prune fractions and GC
counts, and every cross-check flag. Timings and stall counts depend on
the host's speed and are not gates."""
import functools
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these tests share the machine with parallel workers
torch.set_num_threads(1)

from benchmarks import _util, scan_delete, snapshot_compact, sustained  # noqa: E402
from repro_torch.core.lsm import ChainedTableFilter  # noqa: E402
from repro_torch.serving import FilterService  # noqa: E402
from repro_torch.storage import LsmStore, crud_mixed, run_workload  # noqa: E402

BASE = json.loads((pathlib.Path(__file__).parents[1]
                   / "BENCH_baseline.json").read_text())


def _baseline(prefix: str) -> dict:
    (name,) = [k for k in BASE if k.startswith(prefix + " ")]
    return BASE[name]["metrics"]


@pytest.fixture
def port(monkeypatch):
    """Point a benchmark module's imports at the port, on the CPU; the
    stores it makes are kept in ``patch.stores``."""
    monkeypatch.setattr(_util, "FULL", False)

    def store(*args, **kw):
        s = LsmStore(*args, device="cpu", **kw)
        patch.stores.append(s)
        return s

    def patch(module):
        swaps = {"LsmStore": store,
                 "FilterService": functools.partial(FilterService,
                                                    device="cpu"),
                 "ChainedTableFilter": ChainedTableFilter,
                 "crud_mixed": crud_mixed, "run_workload": run_workload}
        for name, obj in swaps.items():
            if hasattr(module, name):
                monkeypatch.setattr(module, name, obj)
        return module
    patch.stores = []
    return patch


def test_scan_delete_gates(port):
    _, got = port(scan_delete).run()
    assert len(port.stores) == 2
    want = _baseline("scan_delete")
    for k in ("deleted_key_avg_reads", "deleted_keys_probed",
              "tombstones_gced", "scan_prune_frac", "scan_prune_frac_1pct",
              "scan_prune_frac_5pct", "scan_prune_frac_25pct",
              "scan_crosscheck_match", "delete_crosscheck_match"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert want["deleted_key_avg_reads"] == 0.0037977430555555555
    assert want["tombstones_gced"] == want["deleted_keys_probed"] == 9216
    assert want["scan_prune_frac"] == 0.7712962962962963


def test_snapshot_compact_gates(port):
    _, got = port(snapshot_compact).run()
    assert len(port.stores) == 2
    want = _baseline("snapshot_compact")
    for k in ("old_gen_probe_match", "publish_parity_match",
              "scan_during_compact_match", "scan_during_compact_keys"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["old_gen_probe_match"] and got["publish_parity_match"] \
        and got["scan_during_compact_match"]


def test_sustained_gate(port):
    _, got = port(sustained).run()
    assert len(port.stores) == 2                 # calibration, measured run
    assert got["sustained_match"] is _baseline("sustained")["sustained_match"]
    assert got["sustained_match"]
    assert got["sustained_bg_compactions"] >= 1
