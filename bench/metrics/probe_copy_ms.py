"""Copy time on the device (host to device and back, from the profiler)
per ``probe`` call of the traced window, in ms."""
from bench.harness.trace import is_copy


def read(run):
    t = run.trace
    if run.kind != "filter_bank" or t is None or not t.ops or not t.calls:
        return None
    return t.device_s(is_copy) / t.calls * 1e3
