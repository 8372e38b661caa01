"""Each cell's harness at a tiny size on the CPU against the reference, the
control and planted faults, a cell added from data files alone, and the
isolation from JAX and the JAX package."""
import json
import sys

import pytest

from bench.tests.conftest import REPO, drive, make_tiny

STORE = ("lsm16-chained.miss_1m", "lsm16-chained.ycsbc_64k")
BANK = ("filters-l8.probe_4m", "filters-l8.probe_64k")


@pytest.mark.parametrize("workload", STORE + BANK)
def test_cell_matches_reference(tiny, workload):
    result, err = drive(tiny, workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    rate = ("get_keys_per_s" if workload in STORE else "probe_queries_per_s")
    assert set(result["metrics"]) >= {rate, "setup_s"}
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("workload", STORE)
def test_store_traced_run_reads_counts(tiny, workload):
    result, _ = drive(tiny, workload, "--trace", "1")
    assert result["correct"]
    reads = result["metrics"]["reads_per_get"]["value"]
    if workload.endswith("ycsbc_64k"):
        assert reads == 1.0          # every stored key costs one read
    else:
        assert 0.0 <= reads < 0.2    # only stage-2 false positives read
    assert result["metrics"]["filter_bits_per_key"]["value"] > 8
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result


@pytest.mark.parametrize("workload", [STORE[0], BANK[0]])
def test_control_is_not_correct(tiny, workload):
    result, _ = drive(tiny, workload, "--control", "1")
    assert not result["correct"]
    assert result["checks"]["missing"]["value"] == 0
    assert sum(c["value"] for c in result["checks"].values()) > 0
    if workload in BANK:        # the stage-1 pass admits built negatives
        assert result["checks"]["neg_admitted"]["value"] > 0
        assert result["checks"]["false_neg"]["value"] == 0


@pytest.mark.parametrize("workload,fault,field", [
    (STORE[0], "found", "found_diff"),
    (STORE[1], "value", "value_diff"),
    (STORE[1], "half", "found_diff"),
    (BANK[0], "member", "member_diff"),
    (BANK[1], "half", "member_diff"),
    (BANK[0], "admit", "neg_admitted"),
    (BANK[1], "drop", "false_neg"),
])
def test_planted_fault_is_caught(tiny, workload, fault, field):
    result, err = drive(tiny, workload, "--fault", fault)
    assert not result["correct"]
    assert result["checks"][field]["value"] > 0


def test_new_cell_from_data_files_alone(tiny, tmp_path):
    root = make_tiny(tmp_path / "copy")
    (root / "bench" / "traffic" / "hot_300.json").write_text(json.dumps(
        {"draw": "stored_zipf", "theta": 1.2, "batch": 300, "pool_batches": 8,
         "keep_batches": 2, "check_rows": 600}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "lsm16-chained.hot_300", "config": "lsm16-chained",
        "traffic": "hot_300", "chips": 1, "why": "added from data"})
    for m in bench["end_to_end"]:
        if m["name"] == "get_keys_per_s":
            m["workloads"].append("lsm16-chained.hot_300")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = drive(root, "lsm16-chained.hot_300")
    assert result["correct"]
    assert result["metrics"]["get_keys_per_s"]["value"] > 0


def test_no_jax_or_jax_package_after_a_run(tiny):
    """The harness refuses a run that loaded them; this run passes, and its
    process ends with neither in ``sys.modules`` (names compared whole)."""
    result, err = drive(tiny, STORE[0])
    assert result["correct"]
    assert err.strip().splitlines()[-1] == "modules of JAX or the JAX package at exit: []"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from bench.harness import cell
    for name in list(sys.modules):
        if name.split(".")[0] in cell.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert cell.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert cell.forbidden_modules() == ["jax", "repro"]


def test_reference_is_built_after_the_window(tiny, monkeypatch):
    """Neither the set-up nor the window shares the host with the
    reference's builds, and a bank's reference has a worker a filter."""
    from bench.harness import cell, deploy
    events, window, reference = [], cell._window, deploy.Reference

    def timed_window(*args, **kwargs):
        out = window(*args, **kwargs)
        events.append("window")
        return out

    class Counted(reference):
        def __init__(self, cfg, data):
            events.append("reference")
            super().__init__(cfg, data)
            events.append(len(self.workers))

    monkeypatch.syspath_prepend(str(REPO / "src"))
    monkeypatch.setattr(cell, "_window", timed_window)
    monkeypatch.setattr(deploy, "Reference", Counted)
    result = cell.execute(tiny, BANK[1], 3_000_000_023, 0.2, False,
                          device="cpu", t_start=0.0, log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert events == ["window", "reference", 5]
