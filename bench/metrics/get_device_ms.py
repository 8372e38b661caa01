"""Device time (kernels, copies and fills, from the profiler) per
``get_batch`` call of the traced window, in ms."""


def read(run):
    t = run.trace
    if run.kind != "lsm_store" or t is None or not t.ops or not t.calls:
        return None
    return t.device_s() / t.calls * 1e3
