"""Pointwise-stage pattern probe (K10): the port of `tools/ptw_probe.py`.

Times the fs pointwise stage's candidate inner loops at the real shapes
(64 frequencies, G = 512, 8 rows, 12 term groups, p = 18433), each
running UNITS units a step over STEPS steps with the accumulator fed back,
and prints the reference's ns/unit per pattern:

  A    the current form: each BSK word broadcast across the gates
  NOB  A without the BSK words (calibrates their share)
  B    transposed: gates in rows, frequencies in columns (L = 64)
  B2   transposed at L = 128 (two tiles; counted as 2 units' work)
  C    the term groups as a bf16 contraction on the tensor cores: one
       cooperative launch that builds each step's limb matrices once for
       the card and takes the six products of every (unit, group) on
       wgmma

and, per pattern, the time a call eager (events around REPS calls) and
as device time (a CUDA graph of GRAPH_CALLS calls, replayed), the bound
and the build's registers a thread and spill bytes.

    python -m helm_tpu_torch.tools.ptw_probe [A NOB B B2 C]              # the card (K10)
    python -m helm_tpu_torch.tools.ptw_probe --device cpu A NOB          # the plain version

Env: STEPS (default 64, the reference's; 2 on the CPU). Each pattern
is timed over REPS = 20 calls after a first one, at UNITS = 2, as the
reference's; on the card also GRAPH_CALLS = 5 calls in a graph, replayed
GRAPH_REPLAYS = 4 times (a CPU run prints the graph time as not
measured).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import probes
from .probe_timing import bound_s, device_arg, device_name, graph_ms, notes, timed

N2, G, P = probes.N2, 512, int(probes.PTW_P)
ROWS, NVC = probes.ROWS, probes.NVC
LABELS = {
    "A": "A  (current lane-splat)", "NOB": "NOB (no BSK loads)", "B": "B  (transposed, L=64)",
    "B2": "B2 (transposed, L=128)", "C": "C  (wgmma fold, built once a step)",
}
#: FP32 multiplies and adds an element (A, NOB, B) per unit: 8 row limb
#: pairs (a reduction, an add and a split each: 9), then per term group
#: 16 products, 14 sums, 3 reductions (4 each) and 3 adds; per step the
#: two reductions around the units (9)
UNIT_OPS = ROWS * 9 + NVC * (2 * ROWS + 2 * (ROWS - 1) + 3 * 4 + 3)
STEP_OPS = 9
#: timed calls a pattern, and (unit, term group) passes a step: the
#: reference's constants; calls in a graph and its replays (the card)
REPS, UNITS = 20, 2
GRAPH_CALLS, GRAPH_REPLAYS = 5, 4


def inputs(which) -> dict:
    """The reference's inputs (numpy seed 0, drawn in its order: slab,
    then slab2 when B2 runs, then w0, w1, bcol)."""
    rng = np.random.default_rng(0)
    slab = rng.integers(-P // 2, P // 2, (N2, NVC * ROWS)).astype(np.float32)
    out = {"A": [slab], "NOB": [slab], "B": [np.ascontiguousarray(slab.T)]}
    if "B2" in which:
        out["B2"] = [rng.integers(-P // 2, P // 2, (NVC * ROWS, 128)).astype(np.float32)]
    RN = ROWS * N2
    w0 = rng.integers(-128, 129, (RN, N2)).astype(np.float32)
    w1 = rng.integers(-36, 37, (RN, N2)).astype(np.float32)
    bcol = rng.integers(-P // 2, P // 2, (RN, NVC)).astype(np.float32)
    out["C"] = [w0, w1, bcol]
    return out


def work(pattern: str, steps: int, units: int) -> tuple[float, float, float]:
    """(FP32 operations, bf16 tensor-core FLOPs, bytes) of one call: C's six
    products a (unit, group), its limb build and its recombination; the
    others' element recurrences. Bytes: the inputs read once and the
    output written once."""
    if pattern == "C":
        RN = ROWS * N2
        per = units * NVC
        bf16 = steps * per * 6 * 2.0 * N2 * RN * G
        fp32 = steps * (per * (RN * N2 * 2 * 9 + N2 * G * 16) + RN * G * 9)
        nbytes = 4 * (2 * RN * N2 + RN * NVC + RN * G)
        return fp32, bf16, nbytes
    elems = N2 * G if pattern in ("A", "NOB") else G * (128 if pattern == "B2" else 64)
    nbytes = 4 * (elems + (0 if pattern == "NOB" else N2 * NVC * ROWS * (2 if pattern == "B2" else 1)))
    return steps * elems * (units * UNIT_OPS + STEP_OPS), 0.0, nbytes


def run(device, which, steps: int, reps: int = REPS, units: int = UNITS) -> dict:
    data = inputs(which)
    res = {}
    print(f"on {device_name(device)}: steps={steps} units={units} reps={reps}", flush=True)
    for pat in which:
        ins = [torch.from_numpy(a).to(device) for a in data[pat]]

        def call():
            return probes.ptw(pat, ins, steps, units, G)

        first, dt, out = timed(call, reps, device)
        graph_s = None
        if device.type == "cuda":
            graph_s = graph_ms(call, GRAPH_CALLS, GRAPH_REPLAYS) / 1e3
        assert bool(torch.isfinite(out).all()), f"{pat}: non-finite output"
        units_of = 2.0 if pat == "B2" else 1.0
        ns_unit = dt / steps / units / units_of * 1e9
        fp32, bf16, nbytes = work(pat, steps, units)
        bound, by = bound_s(fp32, bf16, nbytes)
        res[pat] = {"ns_unit": ns_unit, "s": dt, "graph_s": graph_s, "bound_s": bound, "bound_by": by}
        graph = "not measured (cpu)" if graph_s is None else f"{graph_s * 1e3:.6f} ms"
        print(f"{LABELS[pat]}: first call {first:.1f}s", flush=True)
        print(
            f"{LABELS[pat]}: {ns_unit:,.0f} ns/unit; {dt * 1e3:.6f} ms a call eager, "
            f"graph replay {graph}; {notes(device, bound, by, lambda: probes.ptw_resources(pat))}",
            flush=True,
        )
    print({k: round(v["ns_unit"]) for k, v in res.items()}, flush=True)
    return res


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    args, device = device_arg(argv, __doc__.split("\n")[0], extra="patterns (default: all)")
    which = args.names or list(probes.PTW_PATTERNS)
    bad = [w for w in which if w not in probes.PTW_PATTERNS]
    if bad:
        raise SystemExit(f"unknown patterns {bad}: one of {', '.join(probes.PTW_PATTERNS)}")
    run(device, which, int(env.get("STEPS", "64" if device.type == "cuda" else "2")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
