"""95th percentile of the latency of every ``probe`` call of the window, in
ms (host clock)."""
import numpy as np


def read(run):
    if run.kind != "filter_bank" or not run.latencies:
        return None
    return float(np.percentile(run.latencies, 95)) * 1e3
