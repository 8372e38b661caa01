"""Straggler detection: per-step, per-host wall-time statistics.

At 1000+ nodes the slowest host sets the step time; the monitor keeps an
EWMA + variance of each host's step time and flags hosts persistently above
``k_sigma``. Remediation hooks (drain + re-replicate, or deadline-skip under
async DP) are policy callbacks; on one host the detection path is
exercised with injected delays (tests/test_torch_train_substrate.py).
A copy of the reference's ``repro/ft/straggler.py``: plain Python.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import math


@dataclass
class HostStat:
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flags: int = 0


@dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2           # EWMA weight
    k_sigma: float = 3.0
    min_steps: int = 5
    persist: int = 3             # consecutive flags before reporting
    hosts: dict = field(default_factory=dict)

    def record(self, step: int, host_times: dict) -> list[int]:
        """host_times: host_id -> seconds. Returns hosts flagged this step."""
        flagged = []
        fleet = sorted(host_times.values())
        med = fleet[len(fleet) // 2]
        for hid, t in host_times.items():
            st = self.hosts.setdefault(hid, HostStat())
            if st.n == 0:
                st.mean = t
            d = t - st.mean
            st.mean += self.alpha * d
            st.var = (1 - self.alpha) * (st.var + self.alpha * d * d)
            st.n += 1
            sigma = math.sqrt(max(st.var, 1e-12))
            fleet_bad = t > med * 1.5               # relative to the fleet
            self_bad = (st.n >= self.min_steps
                        and t > st.mean + self.k_sigma * sigma)
            if fleet_bad or self_bad:
                st.flags += 1
                if st.flags >= self.persist:
                    flagged.append(hid)
            else:
                st.flags = 0
        return flagged
