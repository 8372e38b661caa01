"""The fused store probe's share of its roofline, in %: the bound of every
``lsm_probe`` launch of the traced window (``bench.harness.roofline``,
counted from the reference's tables and its stage-1 passes per sampled key)
over the profiler's time of the kernels of both of its paths."""
from bench.harness import roofline
from bench.harness.trace import base_name

KERNELS = {"lsm_probe_kernel", "window_count_kernel",
           "window_scan_units_kernel", "window_scan_totals_kernel",
           "window_scatter_kernel", "window_probe_kernel",
           "window_first_hit_kernel"}


def read(run):
    t = run.trace
    if run.kind != "lsm_store" or t is None:
        return None
    kernel_s = t.device_s(lambda name: base_name(name) in KERNELS)
    calls, probed = t.calls, run.counters.get("probed", 0)
    if kernel_s <= 0 or not calls or not probed:
        return None
    n_bytes, n_ops = roofline.lsm_probe(probed / calls, run.sizes,
                                        run.work["stage1_passes"])
    return 100.0 * calls * roofline.bound_s(n_bytes, n_ops) / kernel_s
