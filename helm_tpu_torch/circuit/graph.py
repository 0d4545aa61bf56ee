"""Topological sort, levelization, and the plaintext oracle.

Semantics mirror the reference scheduler: Kahn-style wave peeling with
DFF/Const gates always-ready (Circuit::sort_circuit, src/circuit.rs:122-171),
`level(gate) = max(level(inputs)) + 1` with DFFs moved to a final state-update
level (Circuit::compute_levels, src/circuit.rs:174-239), numeric-literal wire
names treated as always-ready constants (arith mode), per-wave name sort for
determinism.

One deliberate improvement: const gates are scheduled at level 0 instead of
being dropped from the ordered list (the reference discards `const_level` at
circuit.rs:167, which would break netlists whose gates consume const outputs).

The plaintext oracle (`Circuit.evaluate`) replicates Circuit::evaluate
(src/circuit.rs:348-381) and is the primary correctness harness.

The port's own copy of `helm_tpu/circuit/graph.py`, trimmed to what the
port calls, so that helm_tpu_torch imports nothing of the JAX package;
the tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations


from .gates import Gate, GateType, evaluate_arith_ptxt, evaluate_ptxt
from .verilog import Netlist


def _is_numeric(s: str) -> bool:
    return s.isdigit()


class Circuit:
    def __init__(
        self,
        gates: list[Gate],
        inputs: list[str],
        outputs: list[str],
        dff_outputs: list[str],
    ):
        self.gates = list(gates)
        self.input_wires = list(inputs)
        self.output_wires = list(outputs)
        self.dff_outputs = list(dff_outputs)
        self.ordered_gates: list[Gate] = []
        self.level_map: dict[int, list[Gate]] = {}

    @classmethod
    def from_netlist(cls, nl: Netlist) -> "Circuit":
        c = cls(nl.gates, nl.inputs, nl.outputs, nl.dff_outputs)
        c.sort_circuit()
        c.compute_levels()
        return c

    # -- scheduling ----------------------------------------------------
    def sort_circuit(self) -> None:
        """Kahn wave peeling, O(V+E) via in-degree counting.

        Wave semantics match the reference retain-loop (circuit.rs:122-171):
        DFF/Const gates are always-ready and peel in the first pass (their
        outputs become ready for wave 2), each wave is name-sorted, and
        const gates lead / DFFs trail the final order.
        """
        assert self.gates and not self.ordered_gates
        dff_level: list[Gate] = []
        const_level: list[Gate] = []
        comb: list[Gate] = []
        for g in self.gates:
            if g.type == GateType.DFF:
                dff_level.append(g)
            elif g.type in (GateType.CONST_ONE, GateType.CONST_ZERO):
                const_level.append(g)
            else:
                comb.append(g)
        ready = set(self.input_wires)
        consumers: dict[str, list[Gate]] = {}
        pending: dict[int, int] = {}  # id(gate) -> unready distinct inputs
        wave: list[Gate] = []
        for g in comb:
            need = 0
            for w in set(g.inputs):
                if w not in ready and not _is_numeric(w):
                    need += 1
                    consumers.setdefault(w, []).append(g)
            if need:
                pending[id(g)] = need
            else:
                wave.append(g)
        # DFF/Const outputs are peeled in pass 1 and ready from wave 2 on
        extra = [g.output for g in dff_level + const_level]
        while wave or extra:
            wave.sort(key=lambda g: g.name)
            self.ordered_gates.extend(wave)
            newly = [g.output for g in wave] + extra
            extra = []
            wave = []
            for w in newly:
                for g in consumers.pop(w, ()):
                    pending[id(g)] -= 1
                    if not pending[id(g)]:
                        del pending[id(g)]
                        wave.append(g)
        if pending:
            ids = set(pending)
            stuck = [g.name for g in comb if id(g) in ids]
            raise ValueError(
                "Cyclic or underdriven netlist; stuck gates: "
                + ", ".join(stuck[:5])
            )
        const_level.sort(key=lambda g: g.name)
        self.ordered_gates = const_level + self.ordered_gates + dff_level
        self.gates = []

    def compute_levels(self) -> None:
        assert not self.gates and self.ordered_gates
        wire_levels: dict[str, int] = {w: 0 for w in self.input_wires}
        self.level_map = {}
        dffs: list[Gate] = []
        for g in self.ordered_gates:
            if g.type == GateType.DFF:
                dffs.append(g)
                continue
            if g.type in (GateType.CONST_ONE, GateType.CONST_ZERO):
                depth = 0
            else:
                depth = 0
                for w in g.inputs:
                    if w in wire_levels:
                        d = wire_levels[w]
                    elif _is_numeric(w):
                        d = 0
                    else:
                        raise ValueError(f"Input {w} not found in wire_levels")
                    depth = max(depth, d + 1)
            g.level = depth
            self.level_map.setdefault(depth, []).append(g)
            wire_levels[g.output] = depth
        if dffs:
            last = max(self.level_map) + 1 if self.level_map else 0
            for g in dffs:
                g.level = last
            self.level_map[last] = dffs
        self.ordered_gates = []

    @property
    def levels(self) -> list[tuple[int, list[Gate]]]:
        return sorted(self.level_map.items())

    # -- plaintext oracle ----------------------------------------------
    def initialize_wire_map(
        self, wire_set: set[str], user_inputs: dict, default=False
    ) -> dict:
        """Reference Circuit::initialize_wire_map (circuit.rs:245-333)."""
        wire_map = {w: None for w in wire_set}
        dff = set(self.dff_outputs)
        for w in self.input_wires:
            if w in dff:
                continue  # state wires are initialized below, not user-provided
            if not user_inputs:
                wire_map[w] = default
            elif w not in user_inputs:
                raise KeyError(f'Input wire "{w}" not in input wires!')
            else:
                wire_map[w] = user_inputs[w]
        for w in self.dff_outputs:
            wire_map[w] = default
        return wire_map

    def evaluate(self, wire_map: dict) -> dict:
        """Boolean/LUT plaintext evaluation by level (circuit.rs:348-381)."""
        values = dict(wire_map)
        for _, gates in self.levels:
            updates = {}
            for g in gates:
                ins = [values[w] for w in g.inputs]
                updates[g.output] = evaluate_ptxt(g, ins)
            values.update(updates)
        return values

    def evaluate_arith(self, wire_map: dict, width: int) -> dict:
        """Arithmetic plaintext evaluation (oracle for arith mode).

        The reference has no arith oracle (gates.rs:182-188 unreachable!)
        and tests against recorded CSVs; we provide one so every mode can be
        checked against plaintext.
        """
        values = dict(wire_map)
        for _, gates in self.levels:
            updates = {}
            for g in gates:
                ops = []
                for w in g.inputs:
                    if _is_numeric(w):
                        ops.append(int(w))
                    else:
                        ops.append(values[w])
                a = ops[0]
                b = ops[1] if len(ops) > 1 else None
                updates[g.output] = evaluate_arith_ptxt(g, a, b, width)
            values.update(updates)
        return values
