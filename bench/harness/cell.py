"""One run of one cell: set-up, the timed window, the check, the metrics.

``execute`` is the whole run but the look for a chip, so that the tests can
drive it on the CPU at a tiny size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import inspect
import json
import pathlib
import sys
import time

from bench.harness import compare, deploy
from bench.traffic.generate import Batches, draw_pool, phase_rngs

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """The run cannot report a result; ``code`` is its exit code."""

    def __init__(self, msg: str, code: int = 1):
        super().__init__(msg)
        self.code = code


@dataclasses.dataclass
class Spec:
    bench: dict
    cell: dict
    config: dict
    traffic: dict


def load_spec(root: pathlib.Path, workload: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json", 2)
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return Spec(bench, cell, config, traffic)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_names(spec: Spec, trace: bool) -> list[str]:
    group = spec.bench["per_layer" if trace else "end_to_end"]
    name = spec.cell["name"]
    return [m["name"] for m in group
            if "workloads" not in m or name in m["workloads"]]


def read_metric(name: str, run) -> float | None:
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def _path_counts(paths: list) -> dict:
    out = {}
    for label, module, fn, kinds in paths:
        f = getattr(importlib.import_module(module), fn)
        out[label] = {k: getattr(f, f"{k}_launches") for k in kinds}
    return out


def _span(fn, name: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def wrap_spans(spans: list) -> None:
    """Record a profiler span around each call into the program's
    ``[module, "name"]`` or ``[module, "Class.method"]`` (traced runs only:
    the program records no spans of its own)."""
    for module, qualname in spans:
        owner = importlib.import_module(module)
        *path, attr = qualname.split(".")
        for part in path:
            owner = getattr(owner, part)
        raw = inspect.getattr_static(owner, attr)
        if isinstance(raw, staticmethod):
            setattr(owner, attr, staticmethod(_span(raw.__func__, qualname)))
        else:
            setattr(owner, attr, _span(raw, qualname))


def _delta(after, before):
    if isinstance(after, dict):
        return {k: _delta(after[k], before[k]) for k in after}
    if isinstance(after, list):
        return [a - b for a, b in zip(after, before)]
    return after - before


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``bench/metrics/<name>.py``)."""
    spec: Spec
    kind: str
    setup_s: float
    window_s: float
    latencies: list                 # seconds of each call in the window
    keys: int                       # keys answered in the window
    counters: dict                  # the program's counters over the window
    program: object                 # the LsmStore or FilterService
    sizes: dict                     # the reference's structure sizes
    work: dict                      # the reference's counts per sampled key
    trace: object = None            # trace.Trace of the window, or None


def execute(root: pathlib.Path, workload: str, seed: int, seconds: float,
            trace: bool, *, device: str, t_start: float,
            control: bool = False, log=print) -> dict:
    spec = load_spec(root, workload)
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as exc:
        raise RunError(f"the program cannot be imported: {exc}") from exc
    data = deploy.make_data(spec.config, seed)
    return _run(spec, data, seed, seconds, trace, device, t_start, control,
                log)


def _window(prog, batches, seconds: float, keep, span) -> tuple:
    """Call the program in a closed loop for ``seconds`` -> (latencies,
    keys answered, window seconds). The last call ends past the deadline
    and counts whole."""
    lat, n_keys, j = [], 0, 0
    with span("bench.window"):
        t_win = time.perf_counter()
        deadline = t_win + seconds
        while True:
            b = batches(j)
            with span("bench.call"):
                t0 = time.perf_counter()
                out = prog.call(b)
                t1 = time.perf_counter()
            lat.append(t1 - t0)
            n_keys += len(b)
            keep.offer(j, b, out)
            j += 1
            if t1 >= deadline:
                break
    return lat, n_keys, t1 - t_win


def _check(cfg: dict, data: dict, keep, mix: dict, ref, seed: int,
           control: bool, log) -> tuple[dict, dict]:
    """The sampled answers against the reference's, and against the
    guarantees the configuration states -> (checks, the reference's counts
    per sampled key for the roofline)."""
    (rng_rows,) = phase_rngs(seed, "rows")
    keys, picks = compare.sample(keep.kept, int(mix["check_rows"]), rng_rows)
    wanted = min(int(mix["check_rows"]),
                 sum(len(b) for _, b, _ in keep.kept))
    if cfg["kind"] == "lsm_store":
        got, diff = compare.store_answers(picks), compare.store_diffs
    else:
        got = compare.bank_answers(picks, [s["type"] for s in cfg["filters"]])
        truth = compare.bank_truth(cfg, data, keys)

        def diff(answers, ref_answers):
            return {**compare.bank_diffs(answers, ref_answers),
                    **compare.bank_guarantees(answers, truth)}
    ref.wait_ready()
    want = ref.answer(keys)
    diffs = diff(got, want)
    if control:
        # the reference's control in the program's place; the program's
        # own readings of this run go to standard error
        log(f"program readings: {json.dumps(diffs)}", file=sys.stderr)
        diffs = diff(ref.answer(keys, control=True), want)
    n = max(1, len(keys))
    if cfg["kind"] == "lsm_store":
        work = {"stage1_passes": (want["stage1_passes"] / n).tolist()}
    else:
        work = {name: {k: v / n for k, v in a.items()
                       if k in ("bit_tests", "stage1_passes",
                                "layers_reached")}
                for name, a in want.items()}
    return compare.checks(diffs, len(keys), wanted), work


def _run(spec, data, seed, seconds, trace, device, t_start, control,
         log) -> dict:
    import torch
    cfg, mix = spec.config, spec.traffic
    batches = Batches(draw_pool(mix, data, seed, device), int(mix["batch"]),
                      seed)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the peak is the program's
    prog = deploy.build_program(cfg, data, device)
    for j in (-2, -1):                       # every shape the window uses
        prog.call(batches(j))
    if device == "cuda":
        torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            wrap_spans(cfg.get("spans", []))
            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU,
                *([ProfilerActivity.CUDA] if device == "cuda" else [])]))
            span = record_function
        else:
            span = contextlib.nullcontext
        setup_s = time.monotonic() - t_start
        (rng_keep,) = phase_rngs(seed, "keep")
        keep = compare.Reservoir(int(mix["keep_batches"]), rng_keep)
        before = prog.counters()
        paths_before = _path_counts(cfg.get("paths", []))
        lat, n_keys, window_s = _window(prog, batches, seconds, keep, span)
    bad = forbidden_modules()
    if bad:
        raise RunError("the run loaded " + ", ".join(bad)
                       + ": nothing of JAX or the JAX package may load", 3)
    counters = _delta(prog.counters(), before)
    paths = _delta(_path_counts(cfg.get("paths", [])), paths_before)
    peak = (int(torch.cuda.max_memory_allocated()) if device == "cuda"
            else 0)
    handle = prog.handle
    del prog
    # the reference is built only now, from the same inputs, so that it
    # shares the host with neither the set-up nor the window; the trace is
    # read and the sample drawn while it builds
    t_ref = time.monotonic()
    ref = deploy.Reference(cfg, data)
    try:
        parsed = None
        if trace:
            from bench.harness import trace as tr
            parsed = tr.parse(prof)
            del prof
        checked, work = _check(cfg, data, keep, mix, ref, seed, control, log)
    finally:
        ref.close()
    ref_s = time.monotonic() - t_ref
    run = Run(spec=spec, kind=cfg["kind"], setup_s=setup_s,
              window_s=window_s, latencies=lat, keys=n_keys,
              counters=counters, program=handle, sizes=ref.sizes, work=work,
              trace=parsed)
    units = {m["name"]: m["unit"]
             for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}
    metrics = {}
    for name in metric_names(spec, trace):
        value = read_metric(name, run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    result = {
        "correct": compare.correct(checked), "attempted": len(lat),
        "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name() if device == "cuda"
                            else "cpu"),
                   "count": int(spec.cell["chips"]),
                   "memory_peak_bytes": peak}}
    if parsed is not None:
        result["device"]["busy_s"] = parsed.busy_s
        result["device"]["window_s"] = parsed.window_s
        result["breakdown"] = {"device_ops": parsed.top_ops(10),
                               "idle_gaps": parsed.gaps}
        log(f"paths over the window: {json.dumps(paths)}", file=sys.stderr)
        log(f"device operations over the window (s): "
            f"{json.dumps(parsed.top_ops(10))}", file=sys.stderr)
        log(f"longest idle gaps (s): {json.dumps(parsed.gaps)}",
            file=sys.stderr)
    log(f"calls {len(lat)}, keys {n_keys}, window {window_s:.3f} s, set-up "
        f"{setup_s:.3f} s, reference built in {ref.build_s:.1f} s, built "
        f"and compared after the window in {ref_s:.1f} s", file=sys.stderr)
    result["checks"] = checked
    return result
