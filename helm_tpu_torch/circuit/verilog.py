"""Processed-netlist parser — same grammar as the reference.

Line-oriented structural Verilog in "HELM processed netlist" form
(reference: src/verilog_parser.rs:138-276, parse_gate :31-120,
parse_range :122-136). Behavior replicated:

- skips blank lines, `module`/`endmodule`, `//` comments
- `input`/`output` declarations: `[N:M]` ranges expand to `name[i]` bits
  unless in arithmetic mode (whole words); plain lists pass through
- `wire` declarations recorded but unused for scheduling
- gate instances per the GateType grammar; DFF outputs become pseudo-inputs;
  LUT consts parse as decimal or 0x-hex into a 2^w bitvec
- errors on empty netlists and on mixing LUTs with arithmetic ops
  (verilog_parser.rs:248-265)

The port's own copy of `helm_tpu/circuit/verilog.py`, trimmed to what
the port calls, so that helm_tpu_torch imports nothing of the JAX
package; the tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

from dataclasses import dataclass

from .gates import ARITH_TYPES, Gate, GateType

_KEYWORDS = {t.value: t for t in GateType}
_KEYWORDS.update({"czero": GateType.CONST_ZERO, "cone": GateType.CONST_ONE})


@dataclass
class Netlist:
    gates: list[Gate]
    wire_set: set[str]
    inputs: list[str]
    outputs: list[str]
    dff_outputs: list[str]
    has_luts: bool
    has_arith: bool


def _usize_to_bitvec(value: int, lut_size: int) -> list[int]:
    return [(value >> i) & 1 for i in range(lut_size)]


def _extract_const_val(tok: str) -> str:
    start = tok.index("(")
    end = tok.index(")", start + 1)
    return tok[start + 1 : end]


def parse_gate(tokens: list[str]) -> Gate:
    try:
        gtype = _KEYWORDS[tokens[0]]
    except KeyError:
        raise ValueError(f'Invalid gate type "{tokens[0]}"') from None

    name_and_inputs = [
        s for s in tokens[1].replace("(", ",").split(",") if s.strip()
    ]
    gate_name = name_and_inputs[0]

    def strip_out(tok: str) -> str:
        return tok.rstrip(";").rstrip(")")

    if gtype in (GateType.NOT, GateType.DFF, GateType.BUF, GateType.COPY):
        inputs = [name_and_inputs[1].strip()]
        output = strip_out(tokens[2].strip())
    elif gtype in (GateType.MUX, GateType.LUT):
        inputs = [name_and_inputs[1]]
        inputs += [t.rstrip(",").strip() for t in tokens[2:-1]]
        output = strip_out(tokens[-1])
    elif gtype in (GateType.CONST_ONE, GateType.CONST_ZERO):
        inputs = []
        output = _extract_const_val(tokens[1])
    else:
        inputs = [name_and_inputs[1], tokens[2].rstrip(",").strip()]
        output = strip_out(tokens[3])

    lut_const = None
    if gtype == GateType.LUT:
        const_str = inputs.pop(0)
        if const_str.startswith("0x"):
            const_int = int(const_str[2:], 16)
        else:
            const_int = int(const_str)
        lut_const = _usize_to_bitvec(const_int, 1 << len(inputs))

    return Gate(gate_name, gtype, inputs, output, lut_const)


def _parse_range(tok: str) -> tuple[int, int] | None:
    trimmed = tok.strip("[]")
    parts = trimmed.split(":")
    try:
        first = int(parts[0])
    except ValueError:
        return None
    second = int(parts[1]) if len(parts) > 1 and parts[1] else first
    return (min(first, second), max(first, second))


def read_verilog_file(file_name: str, is_arith: bool = False) -> Netlist:
    with open(file_name) as f:
        return parse_verilog(f.read(), is_arith)


def parse_verilog(text: str, is_arith: bool = False) -> Netlist:
    has_luts = False
    has_arith = False
    gates: list[Gate] = []
    seen_names: set[str] = set()
    wire_set: set[str] = set()
    inputs: list[str] = []
    outputs: list[str] = []
    dff_outputs: list[str] = []

    for raw in text.splitlines():
        line = raw.strip()
        if (
            not line
            or line.startswith("module")
            or line.startswith("endmodule")
            or line.startswith("//")
        ):
            continue
        tokens = [t for t in line.replace(",", " ").split(" ") if t]
        kind = tokens[0]
        if kind in ("input", "output"):
            dest = inputs if kind == "input" else outputs
            rng = _parse_range(tokens[1])
            if rng is not None:
                if is_arith:
                    dest.extend(
                        t.strip(",").rstrip(";") for t in tokens[2:]
                    )
                else:
                    name = tokens[2].strip(",").rstrip(";")
                    dest.extend(f"{name}[{i}]" for i in range(rng[0], rng[1] + 1))
            else:
                dest.extend(t.strip(",").rstrip(";") for t in tokens[1:])
        elif kind == "wire":
            continue
        else:
            gate = parse_gate(tokens)
            if gate.type == GateType.DFF:
                inputs.append(gate.output)
                dff_outputs.append(gate.output)
            elif gate.type == GateType.LUT:
                has_luts = True
            elif gate.type in ARITH_TYPES:
                has_arith = True
            wire_set.add(gate.output)
            # HashSet<Gate> semantics: gates are keyed by name
            if gate.name not in seen_names:
                seen_names.add(gate.name)
                gates.append(gate)

    if not gates:
        if has_arith:
            raise ValueError("Parser error, no arithmetic gates detected.")
        raise ValueError(
            "Parser error, no gates detected. Make sure to use the "
            "'no-expr' flag in Yosys."
        )
    if has_arith and has_luts:
        raise ValueError("Can't mix LUTs with arithmetic operators!")

    return Netlist(gates, wire_set, inputs, outputs, dff_outputs, has_luts, has_arith)
