"""power_qph (end to end): TPC-H v3 clause 5.4.1's Power@Size without the
refresh functions: 3600 x the scale factor over the geometric mean, in
seconds, of every execution's latency in the window."""

import numpy as np


def read(run):
    lat = np.asarray(run.latencies_s, dtype=np.float64)
    if len(lat) == 0 or (lat <= 0).any():
        return None
    return float(3600.0 * run.scale_factor / np.exp(np.log(lat).mean()))
