"""The whole window's share of the card's peak: the least time of every
blind rotation and keyswitch of the untraced stretch, over that stretch's
wall time on the host clock, in %. It bounds the kernels' rooflines: a
kernel taken off the path leaves its roofline silent, and this share still
counts its work. The traced stretch is not read: the profiler slows it."""

from .. import yardstick


def read(run, name):
    w = run.window
    if w.seconds <= 0 or not w.counts.get("bootstraps"):
        return None
    least = yardstick.rotation_least_s(run.params, w.counts["bootstraps"])
    least += yardstick.keyswitch_least_s(run.params, w.counts["launches"], w.counts["bootstraps"])
    return 100.0 * least / w.seconds
