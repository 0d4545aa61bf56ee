"""Analytic reference wall-clock bounds from a circuit's level profile.

The reference evaluates one gate bootstrap per boolean gate, rayon-parallel
WITHIN a topological level and strictly sequential ACROSS levels (reference
src/circuit.rs:524-548: the level loop; :531 the per-level par_iter). Two
rigorous bounds follow from the level profile alone, independent of any
estimate of aggregate CPU throughput:

- **Infinite-core critical-path floor**: a level cannot finish before one
  bootstrap completes, so even a machine with unlimited cores needs
  `(#levels containing >=1 bootstrap) x t_bootstrap` for one vector. No
  core count beats this for single-vector latency.
- **Width-capped C-core bound**: with C cores, a level of b bootstraps
  needs `ceil(b / C) x t_bootstrap`; summing over levels gives the best
  possible C-core wall-clock at PERFECT scaling (no work-stealing or
  memory-bandwidth losses).

Cost model (deliberately generous to the reference): every 2-input
boolean gate, MUX, and LUT counts as ONE bootstrap; NOT/BUF/DFF/COPY and
constants are free (reference src/gates.rs:255-271 — `not` is linear;
tfhe-rs `mux` internally costs more than one PBS, and n>=3-input LUT
packing adds scalar-shift PBS work, both ignored here).
t_bootstrap defaults to 10 ms — the commonly measured tfhe-rs CPU gate
bootstrap latency on a server core (the same figure behind BASELINE.md's
throughput anchor).

The port's own copy of `helm_tpu/refbound.py`, trimmed to what the port's
bench (`helm_tpu_torch/bench.py`) calls: the gates/LUT bounds, not the
arith-mode radix floor model. tests/test_torch_isolation.py holds it
against the original.
"""

from __future__ import annotations

from .circuit.gates import BOOL_2IN, GateType
from .circuit.graph import Circuit

#: single-thread CPU gate-bootstrap latency (seconds) — see module docstring
T_BOOTSTRAP_S = 0.010

#: gate types that cost one bootstrap in the reference gates/LUT engines
_PBS_TYPES = BOOL_2IN | {GateType.MUX, GateType.LUT}


def level_bootstrap_profile(circuit: Circuit) -> list[int]:
    """Bootstraps per topological level under the reference's cost model.

    Requires `compute_levels()` to have run (`circuit.levels` populated).
    """
    return [
        sum(1 for g in gates if g.type in _PBS_TYPES)
        for _, gates in circuit.levels
    ]


def reference_bounds(
    profile: list[int],
    cores: int = 64,
    t_bootstrap_s: float = T_BOOTSTRAP_S,
    cycles: int = 1,
) -> dict:
    """Both analytic bounds for one full evaluation (x `cycles`).

    Returns {"infinite_core_floor_s", "core_bound_s", "cores",
    "bootstraps", "pbs_levels"}; see module docstring for semantics.
    """
    pbs_levels = sum(1 for b in profile if b > 0)
    total = sum(profile)
    core_steps = sum(-(-b // cores) for b in profile if b > 0)
    return {
        "infinite_core_floor_s": round(pbs_levels * t_bootstrap_s * cycles, 4),
        "core_bound_s": round(core_steps * t_bootstrap_s * cycles, 4),
        "cores": cores,
        "bootstraps": total * cycles,
        "pbs_levels": pbs_levels,
    }


def bounds_for_netlist(path: str, cores: int = 64, cycles: int = 1) -> dict:
    """Parse + levelize a netlist and return its reference bounds."""
    from .circuit.verilog import read_verilog_file

    nl = read_verilog_file(path)
    c = Circuit.from_netlist(nl)
    return reference_bounds(
        level_bootstrap_profile(c), cores=cores, cycles=cycles
    )
