"""The blind rotations' share of their roofline: the least time of the
traced stretch's gate rotations at the set (`yardstick.rotation_least_s`,
one modulus, the algorithm's count) over the device time of the kernels
named `rotate_tiles` (every route's blind-rotation kernel), in %."""

from .. import yardstick


def read(run, name):
    if run.trace is None or not run.traced.counts.get("bootstraps"):
        return None
    spent = run.trace.kernel_s("rotate_tiles")
    if not spent:
        return None
    return 100.0 * yardstick.rotation_least_s(run.params, run.traced.counts["bootstraps"]) / spent
