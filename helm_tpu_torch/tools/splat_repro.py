"""Column-splat probe (K8): the port of `tools/mosaic_splat_repro.py`.

Per step, T = 96 terms (the fs pointwise stage's terms a (prime, tile) at
GATES_128_K3), each one column of a [64, 96] block broadcast across G =
512 gates and consumed by two multiply-adds against two resident [64, 512]
rows. Variants, as in the reference: scalar (a constant a term: no
operand), splat (the column streamed into a ring in shared memory by bulk
copies issued steps ahead, and read by every thread of its row, four
terms a broadcast load), impl (each thread reads the column word from
global memory), i16 (int16 columns, streamed as they are and converted in
the thread). splat, impl and i16 must give the same words. Prints the reference's M terms/s, T
fma-elems/s and the splat-vs-scalar ratio, each call's time eager (CUDA
events around REPS calls: the host's launches included) and as device
time (GRAPH_CALLS calls in a CUDA graph, replayed GRAPH_REPLAYS times;
not measured on the CPU), and each build's registers a thread and spill
bytes: the card's answer to the probe's question.

    python -m helm_tpu_torch.tools.splat_repro                # the card (K8)
    python -m helm_tpu_torch.tools.splat_repro --device cpu   # the plain version

Env: VARIANTS=scalar,splat,impl,i16  STEPS=512  REPS=30 (on the CPU:
STEPS=8, REPS=1).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import probes
from .probe_timing import bound_s, device_arg, device_name, graph_ms, notes, timed

N2, G, T = probes.N2, 512, probes.T
#: calls in a CUDA graph and its timed replays (the card)
GRAPH_CALLS, GRAPH_REPLAYS = 5, 4


def inputs(steps: int):
    """The reference's columns [steps, 64, 96] and rows [2, 64, 512]
    (numpy seed 7)."""
    rng = np.random.default_rng(7)
    cols = rng.integers(-16384, 16384, (steps, N2, T)).astype(np.float32)
    rows = rng.integers(-128, 129, (2, N2, G)).astype(np.float32)
    return cols, rows


def work(steps: int, variant: str, R: int = 1, G: int = G) -> tuple[float, float]:
    """(FP32 operations, bytes) of one call of K8 (R = 1) or K9: two
    multiply-adds over the [N2, G] tile a term (a multiply and an add
    each); the columns (none for `scalar` and `two`; int16 for `i16`) and
    the 2R rows read once, the output written once."""
    col_bytes = {"scalar": 0, "two": 0, "i16": 2}.get(variant, 4) * steps * N2 * T
    return 2.0 * steps * T * 2 * N2 * G, col_bytes + 4.0 * (2 * R + 1) * N2 * G


def run(device, steps: int, reps: int, variants) -> dict:
    cols_f, rows = inputs(steps)
    rows_d = torch.from_numpy(rows).to(device)
    print(f"on {device_name(device)}: steps={steps} reps={reps}", flush=True)
    res, outs = {}, {}
    for v in variants:
        cols = torch.from_numpy(cols_f.astype(np.int16) if v == "i16" else cols_f).to(device)
        first, dt, out = timed(lambda: probes.splat(cols, rows_d, v), reps, device)
        outs[v] = out
        graph_s = None
        if device.type == "cuda":
            graph_s = graph_ms(lambda: probes.splat(cols, rows_d, v), GRAPH_CALLS, GRAPH_REPLAYS) / 1e3
        tps = steps * T / dt
        ops, nbytes = work(steps, v)
        bound, by = bound_s(fp32_ops=ops, nbytes=nbytes)
        res[v] = {"terms_per_s": tps, "s": dt, "graph_s": graph_s, "first_s": first, "bound_s": bound,
                  "bound_by": by}
        splat_bytes = 2 * N2 * G * (2 if v == "i16" else 4)
        graph = "not measured (cpu)" if graph_s is None else f"{graph_s * 1e3:.6f} ms"
        print(
            f"{v:7s}: {tps / 1e6:8.2f} M terms/s  ({tps * 2 * N2 * G / 1e12:6.3f} T fma-elems/s; "
            f"splat model {splat_bytes} B/term); {dt * 1e3:.6f} ms a call eager, graph replay {graph}; "
            f"{notes(device, bound, by, lambda: probes.splat_resources(1, 1, v))}",
            flush=True,
        )
    for v in ("impl", "i16"):
        if "splat" in outs and v in outs:
            assert torch.equal(outs["splat"], outs[v]), f"splat != {v}"
    if "scalar" in res and "splat" in res:
        r0, r1 = res["scalar"]["terms_per_s"], res["splat"]["terms_per_s"]
        per_term_s = 1.0 / r1 - 1.0 / r0
        eff_bw = (2 * N2 * G * 4) / per_term_s if per_term_s > 0 else float("inf")
        print(
            f"splat vs scalar: {r1 / r0:.3f}x; implied splat cost {per_term_s * 1e9:.1f} ns/term = "
            f"{eff_bw / 1e9:.1f} GB/s effective (write+read of a [64,512] f32 value per term)",
            flush=True,
        )
    return res


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    cuda = device.type == "cuda"
    run(
        device,
        int(env.get("STEPS", "512" if cuda else "8")),
        int(env.get("REPS", "30" if cuda else "1")),
        env.get("VARIANTS", ",".join(probes.SPLAT_VARIANTS)).split(","),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
