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

The port's own copy of `helm_tpu/refbound.py`: the gates/LUT bounds that
the bench (`helm_tpu_torch/bench.py`) and `tools/family_bench.py` report,
and the arith-mode radix floor model that `tools/chi2_bench.py` reports.
tests/test_torch_isolation.py and tests/test_torch_tools.py hold it
against the original.
"""

from __future__ import annotations

from .circuit.gates import BOOL_2IN, GateType
from .circuit.graph import Circuit, _is_numeric

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


# ---------------------------------------------------------------------------
# Arithmetic mode: the reference evaluates each arith gate as a tfhe-rs
# radix-integer operator (reference src/gates.rs:306-702 — `ct1 * ct2`
# etc. on FheUintN; keygen at PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3,
# bin/helm.rs:81-88, i.e. 2-bit message blocks: a uW integer is W/2
# radix blocks). The internal PBS counts live inside the tfhe-rs crate,
# not the reference repo, so the model below is a DOCUMENTED FLOOR,
# deliberately generous to the reference (real tfhe-rs 0.4 costs are
# strictly higher):
#
#   op (nb = width//2 blocks)   total PBS (work)     sequential rounds
#   add/sub (+/- plain), neg    nb                   1
#   mul (ct x ct)               nb^2                 2
#   mul (ct x pt)               nb                   1
#   div/mod (ct / ct)           width * nb           width
#   div (ct / pt)               nb                   1
#   shl/shr by ct               nb*ceil(log2 width)  ceil(log2 width)
#   shl/shr by pt, copy, dff    0                    0
#
# Work floors: every block of a carry-propagating result needs >= 1 PBS;
# schoolbook mul has nb^2 block pair products each needing >= 1 bivariate
# PBS (the msb halves and the carry tree are ignored); encrypted division
# is a width-iteration shift-subtract-select loop needing >= nb PBS per
# iteration; an encrypted-amount shift is a log2(width)-stage barrel mux.
# Round floors: assume PERFECT intra-op parallelism except structurally
# sequential stages (each division iteration depends on the previous
# remainder; barrel stages chain) — the real library propagates carries
# sequentially across blocks, so true rounds are higher.
# ---------------------------------------------------------------------------

_ARITH_COSTS = {
    GateType.ADD: ("linear", 1),
    GateType.SUB: ("linear", 1),
    GateType.MULT: ("mul", 2),
    GateType.DIV: ("div", None),  # rounds = width
    GateType.SHL: ("shift", None),  # rounds = ceil(log2 width)
    GateType.SHR: ("shift", None),
}


def radix_op_costs(
    gate_type: GateType, width: int, plain: bool
) -> tuple[int, int]:
    """(total_pbs, sequential_rounds) floor for one reference radix op."""
    nb = max(1, width // 2)
    if gate_type not in _ARITH_COSTS:
        return 0, 0  # copy / dff / const
    kind, rounds = _ARITH_COSTS[gate_type]
    if kind == "linear":
        return nb, 1
    if kind == "mul":
        return (nb, 1) if plain else (nb * nb, 2)
    if kind == "div":
        return (nb, 1) if plain else (width * nb, width)
    # shift
    if plain:
        return 0, 0
    lg = max(1, (width - 1).bit_length())
    return nb * lg, lg


def arith_level_profile(
    circuit: Circuit, width: int
) -> list[tuple[int, int]]:
    """Per-level (total_pbs, max_sequential_rounds) under the floor model.

    A gate's operand is plaintext when its wire name is a numeric literal
    (reference src/circuit.rs:100-102, 1330-1334)."""
    prof = []
    for _, gates in circuit.levels:
        work = 0
        rounds = 0
        for g in gates:
            plain = any(_is_numeric(w) for w in g.inputs)
            w, r = radix_op_costs(g.type, width, plain)
            work += w
            rounds = max(rounds, r)
        prof.append((work, rounds))
    return prof


def arith_reference_bounds(
    circuit: Circuit,
    width: int,
    cores: int = 64,
    t_bootstrap_s: float = T_BOOTSTRAP_S,
) -> dict:
    """Analytic reference bounds for an arithmetic-mode circuit.

    - infinite-core floor: sum over levels of the level's max sequential
      rounds (levels are strictly sequential, reference circuit.rs:1327;
      intra-op structure floors each level's latency).
    - C-core bound: per level, max(rounds, ceil(work / C)) — perfect
      scaling over C cores can beat neither the work bound nor the
      structural round count.
    """
    prof = arith_level_profile(circuit, width)
    floor_steps = sum(r for _, r in prof)
    core_steps = sum(
        max(r, -(-w // cores)) for w, r in prof if w or r
    )
    return {
        "infinite_core_floor_s": round(floor_steps * t_bootstrap_s, 4),
        "core_bound_s": round(core_steps * t_bootstrap_s, 4),
        "cores": cores,
        "bootstraps": sum(w for w, _ in prof),
        "pbs_levels": sum(1 for w, r in prof if w or r),
        "model": (
            "tfhe-rs radix floor; 2-bit blocks (bin/helm.rs:81-88); "
            "10ms/bootstrap; levels sequential (circuit.rs:1327)"
        ),
    }


def bounds_for_netlist(path: str, cores: int = 64, cycles: int = 1) -> dict:
    """Parse + levelize a netlist and return its reference bounds."""
    from .circuit.verilog import read_verilog_file

    nl = read_verilog_file(path)
    c = Circuit.from_netlist(nl)
    return reference_bounds(
        level_bootstrap_profile(c), cores=cores, cycles=cycles
    )
