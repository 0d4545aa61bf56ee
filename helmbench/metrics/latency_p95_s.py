"""The 95th percentile of the latency of every vector served in the
window, on the host clock (as `latency_p50_s`)."""

import numpy as np


def read(run, name):
    lat = run.window.latencies
    return float(np.percentile(lat, 95)) if lat.size else None
