"""Serving batch selection from the launches the engine really makes on an
H100.

Counterpart of `helm_tpu/batching.py`, with its names and contracts
(`UNDERFILL_WARN`, `predicted_cost_per_vector`, `suggest_batch` with the
2%-tie-prefers-larger rule, `check_batch`) and a cost model of the card in
place of the TPU's lane tiles.

At batch B every PBS level of the engine's plan launches one blind
rotation of B x S gates, S the level's slot count (the plan pads a level
to a power of two, `circuit/plan.py`; levels are not padded to one
width), on the route the engine takes (`mb_pbs.blind_rotation`: K2 at
grouping 1, else K1, K6 or K4 by HELM_TPU_MB_KERNEL). The launch runs
`mb_pbs.tile_plan`'s tiles of gt gates in waves of as many clusters as the
card holds (`mb_pbs.cluster_slots`), and a wave costs about gt + 1
gate-times (`tile_plan`'s own law, measured for K1). Around the rotation
each level pays a keyswitch that grows with its width and a fixed cost
(the keyswitch GEMM's floor at narrow widths, sample extract, the level's
gathers and scatters). So, in gate-times a vector:

    cost(B) = sum over levels [waves x (gt + 1) + KS_GATE_TIMES x B x S
                               + LEVEL_GATE_TIMES] / B

Fill is the gates the launches carry over the gate positions they occupy
(waves x clusters a wave x gt): idle cluster slots of a wave cost its full
time. On a CPU engine there are no tiles: as the reference's non-`mxu`
branch does, the cost is the slots a vector and the fill 1.0.

`calibrate` fits the gate-time and the two constants to measured seconds
a vector; `chip_smoke.py` phase `serve` prints the measured table beside
the model and the fit. The constants below are that fit, on an NVIDIA
H100 80GB HBM3 at 700.00 W, to c880-like at GATES_128_K3 through K1,
fused, at B = 1, 2, 4, 8, 12, 15, 16 (PERF.md §6, PR 9): the model came
within 3% of every measured point. They are ratios to a gate-time, so
other sets and routes reuse them with their own tile plans.
"""

from __future__ import annotations

import itertools
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np

UNDERFILL_WARN = 0.75

#: keyswitch cost a bootstrapped slot, in gate-times (see the module docstring)
KS_GATE_TIMES = 0.000275
#: fixed cost a PBS level, in gate-times
LEVEL_GATE_TIMES = 0.849862
#: seconds of one gate-time at GATES_128_K3 on K1 (used only to print the
#: model's cost in seconds beside a measurement)
GATE_S = 1.573833e-3


@dataclass(frozen=True)
class Launch:
    """One PBS level's blind rotation at a batch: `gates` launched (B x
    slots), `real` of them carrying gate work, tiles of `gt` gates run in
    `waves` waves of `slots` clusters."""

    gates: int
    real: int
    gt: int
    waves: int
    slots: int

    @property
    def gate_times(self) -> int:
        return self.waves * (self.gt + 1)

    @property
    def positions(self) -> int:
        return self.waves * self.slots * self.gt


def launch_plan(params, widths, batch: int, slots: int | Callable[[int], int],
                kernel: str = "blind_rotate_mb") -> list[Launch]:
    """The launches of one evaluation at `batch`: a pure function of the
    set, the levels' (launched, real) slot counts `widths`, the batch and
    the clusters the card holds a wave (`slots`, or slots(gt))."""
    from .ops import mb_pbs

    per = slots if callable(slots) else (lambda gt: slots)
    B = max(1, int(batch))
    out = []
    for launched, real in widths:
        G = B * launched
        plan = mb_pbs.tile_plan(params, G, per, kernel)
        s = max(1, per(plan.gt))
        out.append(Launch(G, B * real, plan.gt, -(-plan.tiles // s), s))
    return out


def level_widths(engine) -> list[tuple[int, int]]:
    """(launched, real) slots of every PBS level of a compiled boolean
    engine's plan."""
    return [(lp.slot_in.shape[0], lp.real_slots) for lp in engine.plan.levels if lp.slot_in.shape[0]]


def plan_cost(launches: list[Launch], batch: int, ks: float = KS_GATE_TIMES,
              level: float = LEVEL_GATE_TIMES) -> tuple[float, float]:
    """(gate-times a vector, fill) of one evaluation's launches at `batch`."""
    B = max(1, int(batch))
    cost = sum(x.gate_times + ks * x.gates + level for x in launches)
    pos = sum(x.positions for x in launches)
    return cost / B, (sum(x.real for x in launches) / pos if pos else 1.0)


def engine_launches(engine, batch: int) -> list[Launch]:
    """The launches of a compiled boolean engine on the card at `batch`,
    on its route (the wrapper `mb_pbs.blind_rotation` picks is named after
    its kernel), with the card's clusters a wave."""
    from .ops import mb_pbs

    kernel = mb_pbs.blind_rotation(engine.params).__name__
    return launch_plan(
        engine.params, level_widths(engine), batch,
        lambda gt: mb_pbs.cluster_slots(engine.dsk, gt, kernel), kernel,
    )


def predicted_cost_per_vector(engine, batch: int) -> tuple[float, float]:
    """(cost a vector, fill) at `batch` for a compiled boolean engine: on
    the card gate-times a vector (`plan_cost` of its launches); on the CPU
    the slots a vector and fill 1.0."""
    B = max(1, int(batch))
    if engine.device.type != "cuda":
        return float(sum(w for w, _ in level_widths(engine))), 1.0
    return plan_cost(engine_launches(engine, B), B)


def suggest_batch(engine, max_batch: int = 16) -> tuple[int, list[dict]]:
    """Best batch in 1..max_batch by predicted cost a vector, with the
    full table (batch, fill, cost) for logging. Ties within 2% prefer the
    larger batch."""
    table = []
    for b in range(1, max(1, max_batch) + 1):
        cost, fill = predicted_cost_per_vector(engine, b)
        table.append({"batch": b, "fill": round(fill, 3), "cost_per_vector": round(cost, 4)})
    min_cost = min(t["cost_per_vector"] for t in table)
    best = max(t["batch"] for t in table if t["cost_per_vector"] <= min_cost * 1.02)
    return best, table


def check_batch(engine, batch: int, max_batch: int = 16) -> str | None:
    """Warning string when `batch` fills the card's cluster slots below
    UNDERFILL_WARN, else None."""
    _, fill = predicted_cost_per_vector(engine, batch)
    if fill >= UNDERFILL_WARN:
        return None
    best, table = suggest_batch(engine, max_batch)
    bf = next(t["fill"] for t in table if t["batch"] == best)
    return (
        f"batch {batch} fills the card's cluster slots to only {fill:.0%} — an idle"
        f" slot of a wave costs the wave's full time. Nearest suggestion: batch"
        f" {best} ({bf:.0%} fill)."
    )


def calibrate(launches_by_batch: dict, measured: dict) -> tuple[float, float, float]:
    """(seconds a gate-time, KS_GATE_TIMES, LEVEL_GATE_TIMES) fitted by
    least squares, all three non-negative, to measured seconds a vector:
    `launches_by_batch[B]` the launches at batch B, `measured[B]` its
    seconds a vector."""
    Bs = sorted(measured)
    rows = []
    for B in Bs:
        xs = launches_by_batch[B]
        rows.append([sum(x.gate_times for x in xs) / B, sum(x.gates for x in xs) / B, len(xs) / B])
    A = np.array(rows, dtype=np.float64)
    y = np.array([measured[B] for B in Bs], dtype=np.float64)
    best = None
    for keep in itertools.product((True, False), repeat=2):  # the non-negative fit
        cols = [0] + [i + 1 for i in range(2) if keep[i]]
        sol = np.linalg.lstsq(A[:, cols], y, rcond=None)[0]
        if (sol < 0).any() or sol[0] <= 0:
            continue
        full = np.zeros(3)
        full[cols] = sol
        err = float(((A @ full - y) ** 2).sum())
        if best is None or err < best[0]:
            best = (err, full)
    if best is None:
        raise ValueError(f"no fit with a positive gate-time to {measured}")
    gate_s, ks_s, level_s = best[1]
    return float(gate_s), float(ks_s / gate_s), float(level_s / gate_s)
