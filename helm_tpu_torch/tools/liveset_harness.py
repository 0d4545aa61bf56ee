"""Live-set probe (K9): the port of `tools/liveset_harness.py`.

K8's term with R resident row pairs and A accumulator pairs: term i
multiplies row pair i % R into accumulator pair i % A. R = 1, A = 1 is
K8's shape; R = 8, A = 12 the fs kernel's nest (8 limb pairs, 12 term
groups). Variants: splat (K8's: the step's column streamed into shared
memory ahead of its step and broadcast to the row's threads), red (a
floor-round reduction mod 16381 of the pair every 8 terms), two (a second
resident row in place of the column). On the TPU the live set was [N2, G] arrays in vector registers;
on the card it is 2R + 2A floats a thread, and each build's registers a
thread and spill bytes say where the register file runs out. Prints the
reference's M terms/s and T fma-elems/s per (R, A, variant), and each
call's time eager and as device time (splat_repro's GRAPH_CALLS calls in
a CUDA graph, replayed; not measured on the CPU).

    python -m helm_tpu_torch.tools.liveset_harness                # the card (K9)
    python -m helm_tpu_torch.tools.liveset_harness --device cpu   # the plain version

Env: RS=1,2,4,8  AS=1,4,8,12,16  G=512  STEPS=256  REPS=10  VARIANTS=splat
(on the CPU: STEPS=4, REPS=1).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import probes
from . import splat_repro
from .probe_timing import bound_s, device_arg, device_name, graph_ms, notes, timed

N2, T = probes.N2, probes.T


def run(device, steps: int, reps: int, G: int, rs, as_, variants) -> dict:
    rng = np.random.default_rng(7)
    cols = torch.from_numpy(rng.integers(-16384, 16384, (steps, N2, T)).astype(np.float32)).to(device)
    fma = 2 * N2 * G  # two multiply-adds over the tile a term
    print(f"G={G} steps={steps} reps={reps} on {device_name(device)} (floats a thread: 2R + 2A)", flush=True)
    res = {}
    for R in rs:
        rows = torch.from_numpy(rng.integers(-128, 129, (2 * R, N2, G)).astype(np.float32)).to(device)
        for A in as_:
            for v in variants:
                _, dt, out = timed(lambda: probes.liveset(cols, rows, A, v), reps, device)
                assert bool(torch.isfinite(out).all()), f"R={R} A={A} {v}: non-finite output"
                graph_s = None
                if device.type == "cuda":
                    graph_s = graph_ms(lambda: probes.liveset(cols, rows, A, v), splat_repro.GRAPH_CALLS,
                                       splat_repro.GRAPH_REPLAYS) / 1e3
                tps = steps * T / dt
                ops, nbytes = splat_repro.work(steps, v, R, G)
                bound, by = bound_s(fp32_ops=ops, nbytes=nbytes)
                res[(R, A, v)] = {"terms_per_s": tps, "s": dt, "graph_s": graph_s, "bound_s": bound, "bound_by": by}
                graph = "not measured (cpu)" if graph_s is None else f"{graph_s * 1e3:.6f} ms"
                print(
                    f"R={R:2d} A={A:2d} {v:5s} live {2 * R + 2 * A:3d} floats: {tps / 1e6:8.2f} M terms/s "
                    f"({tps * fma / 1e12:6.3f} T fma-elems/s); {dt * 1e3:.6f} ms a call eager, graph replay "
                    f"{graph}; {notes(device, bound, by, lambda: probes.splat_resources(R, A, v))}",
                    flush=True,
                )
    return res


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    cuda = device.type == "cuda"
    run(
        device,
        int(env.get("STEPS", "256" if cuda else "4")),
        int(env.get("REPS", "10" if cuda else "1")),
        int(env.get("G", "512")),
        [int(x) for x in env.get("RS", "1,2,4,8").split(",")],
        [int(x) for x in env.get("AS", "1,4,8,12,16").split(",")],
        env.get("VARIANTS", "splat").split(","),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
