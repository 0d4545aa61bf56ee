"""The mean latency of every vector served in the window, on the host
clock (as `latency_p50_s`)."""


def read(run, name):
    lat = run.window.latencies
    return float(lat.mean()) if lat.size else None
