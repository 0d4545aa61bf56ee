"""The median latency of every vector served in the window, on the host
clock: from its arrival (closed loop: the hand-over of its call's inputs)
to its outputs on the host."""

import numpy as np


def read(run, name):
    lat = run.window.latencies
    return float(np.percentile(lat, 50)) if lat.size else None
