"""95th percentile of the latency of every ``get_batch`` call of the
window, in ms (host clock)."""
import numpy as np


def read(run):
    if run.kind != "lsm_store" or not run.latencies:
        return None
    return float(np.percentile(run.latencies, 95)) * 1e3
