"""The keyswitches' share of their roofline: the least time of the traced
stretch's keyswitch calls (`yardstick.keyswitch_least_s`: the key read once
a call, or the slots' multiply-adds at the int8 peak) over the device time
of the int8 GEMM that computes them (`torch._int_mm`, a CUTLASS or cuBLAS
GEMM by name), in %. One keyswitch call a blind-rotation launch."""

from .. import yardstick

GEMM_NAMES = ("gemm", "cutlass", "xmma")


def read(run, name):
    if run.trace is None:
        return None
    c = run.traced.counts
    spent = run.trace.kernel_s(*GEMM_NAMES)
    if not spent or not c.get("launches"):
        return None
    return 100.0 * yardstick.keyswitch_least_s(run.params, c["launches"], c["bootstraps"]) / spent
