"""What the four probe tools (expand8_probe, splat_repro, liveset_harness,
ptw_probe) and chip_smoke.py's phase `probes` share: the device from
`--device`, the timing of a call, and the Hopper readings of a kernel
build.

On the card a call is timed two ways. `timed`: CUDA events around `reps`
eager calls after a first, untimed one (which builds and loads the
kernel); for a call of a few microseconds that reads the host's enqueue
rate, not the device. `graph_ms`: the device time, `calls` calls captured
into one CUDA graph and the graph replayed between events. On the CPU
`timed` uses the host clock and `graph_ms` is not measured. A CPU time is
the plain version's on the host and never a device time: the tools print
it with the device's name.
"""

from __future__ import annotations

import argparse
import time

import torch

#: H100 SXM rates: FP32 instructions outside the tensor cores (132 SMs x
#: 128 lanes x 1.98 GHz boost; a multiply, an add or a fused multiply-add
#: is one, and the data sheet's 67 TFLOP/s counts the last as two), bf16
#: FLOPs on the tensor cores (data sheet, dense), and HBM3 bytes
FP32_OPS_PER_S = 132 * 128 * 1.98e9
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def device_arg(argv, description: str, extra=None):
    """Parse `--device` (default cuda; a missing card is an error, not a
    switch to the CPU) and any positional `extra` names."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain version)")
    if extra:
        ap.add_argument("names", nargs="*", help=extra)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    return args, device


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain version)"


def timed(fn, reps: int, device) -> tuple[float, float, object]:
    """(seconds of the first call, seconds a call over `reps` more, the
    last output)."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return first, start.elapsed_time(end) / 1e3 / max(reps, 1), out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return first, (time.perf_counter() - t0) / max(reps, 1), out


def graph_ms(fn, calls: int, replays: int) -> float:
    """Device milliseconds a call on the current card: `calls` calls of
    `fn` captured into one CUDA graph (after an eager warm-up call), the
    graph replayed once untimed and then `replays` times between events.
    A kernel wrapper launches on the current stream, the capture's, and
    counts the calls it captures; the replays launch without it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_s(fp32_ops: float = 0.0, bf16_flops: float = 0.0, nbytes: float = 0.0) -> tuple[float, str]:
    """The least time of the card for the work: the larger of its
    operations over their rate (the FP32 instructions, each multiply and
    each add one, and the tensor cores' FLOPs run at once: the larger of
    the two) and its bytes over the memory rate."""
    t_ops = max(fp32_ops / FP32_OPS_PER_S, bf16_flops / BF16_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def notes(device, bound: float, by: str, resources) -> str:
    """The card's bound for the call and the build's registers a thread
    and spill bytes; on the CPU neither is a reading of this run."""
    if device.type != "cuda":
        return "bound and regs/spills: not measured (cpu)"
    regs, local = resources()
    return f"H100 bound {bound * 1e3:.6f} ms ({by}); regs {regs}, spill {local} B"
