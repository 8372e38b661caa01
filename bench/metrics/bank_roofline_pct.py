"""The bank's probe kernels' share of their roofline, in %: the summed
bound of the five filters' probes of every ``probe`` call of the traced
window (``bench.harness.roofline``, counted from the reference's filters
and its counts per sampled key) over the profiler's summed time of their
kernels, on either path."""
from bench.harness import roofline
from bench.harness.trace import base_name

KERNELS = {"bloom_probe_kernel", "onchip_probe_kernel", "onchip_kernel",
           "bloomier_probe_kernel", "chained_probe_kernel",
           "cascade_probe_kernel"}


def read(run):
    t = run.trace
    if run.kind != "filter_bank" or t is None:
        return None
    kernel_s = t.device_s(lambda name: base_name(name) in KERNELS)
    calls, lookups = t.calls, run.counters.get("lookups", 0)
    if kernel_s <= 0 or not calls or not lookups:
        return None
    n = lookups / calls
    bound = sum(roofline.bound_s(*roofline.bank_probe(
        s["type"], n, run.sizes[s["type"]], run.work[s["type"]]))
        for s in run.spec.config["filters"])
    return 100.0 * calls * bound / kernel_s
