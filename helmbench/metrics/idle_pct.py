"""The device's idle share of the traced stretch: 1 - the union of its
operations' intervals over the stretch, in %. It reads the traced run, and
the profiler's own cost is in it: a graph replay's launch holds the host
for every node the profiler records, and each eager launch pays its
record, so a change that cuts nodes or launches also cuts that cost."""


def read(run, name):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
