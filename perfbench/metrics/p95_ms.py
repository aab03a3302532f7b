"""p95_ms (end to end): the 95th percentile of every execution's latency
in the window (from the call to a synchronised device), in ms; no medians
of pieces first (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
