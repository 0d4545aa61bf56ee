"""Gate model and plaintext semantics.

Gate grammar and evaluation semantics mirror the reference exactly
(GateType enum: src/gates.rs:24-45; instance syntax comments ibid.;
plaintext evaluation: src/gates.rs:151-239). The plaintext evaluator is the
framework's correctness oracle, as in the reference's test strategy
(SURVEY.md §4).

The port's own copy of `helm_tpu/circuit/gates.py`, trimmed to what the
port calls, so that helm_tpu_torch imports nothing of the JAX package;
the tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class GateType(enum.Enum):
    AND = "and"  # and  ID(in0, in1, out);
    DFF = "dff"  # dff  ID(in, out);
    LUT = "lut"  # lut  ID(const, in0, ..., inN-1, out);
    MUX = "mux"  # mux  ID(in0, in1, sel, out);
    NAND = "nand"
    NOR = "nor"
    NOT = "not"
    OR = "or"
    XNOR = "xnor"
    XOR = "xor"
    BUF = "buf"
    CONST_ONE = "cone"  # one(out);
    CONST_ZERO = "czero"  # zero(out);
    MULT = "mult"
    ADD = "add"
    SUB = "sub"
    DIV = "div"
    SHL = "shl"
    SHR = "shr"
    COPY = "copy"


ARITH_TYPES = frozenset(
    {
        GateType.ADD,
        GateType.SUB,
        GateType.MULT,
        GateType.DIV,
        GateType.SHL,
        GateType.SHR,
        GateType.COPY,
    }
)

BOOL_2IN = frozenset(
    {GateType.AND, GateType.NAND, GateType.OR, GateType.NOR, GateType.XOR, GateType.XNOR}
)


@dataclass
class Gate:
    name: str
    type: GateType
    inputs: list[str]
    output: str
    lut_const: list[int] | None = None  # bit i = lut value at index i
    level: int = field(default=0, compare=False)

    def __hash__(self):
        return hash(self.name)


def evaluate_ptxt(gate: Gate, input_values: list) -> object:
    """Boolean/LUT plaintext semantics (reference: src/gates.rs:151-239).

    n-ary AND/OR, XOR/XNOR as parity, MUX select = inputs[2], LUT index
    packs the *first* wire as MSB. Arithmetic gate types are handled by the
    arithmetic oracle, not here (they are `unreachable!` in the reference).
    """
    t = gate.type
    if t == GateType.DFF or t == GateType.BUF:
        return input_values[0]
    if t == GateType.AND:
        return all(input_values)
    if t == GateType.OR:
        return any(input_values)
    if t == GateType.NAND:
        return not all(input_values)
    if t == GateType.NOR:
        return not any(input_values)
    if t == GateType.XOR:
        return sum(map(bool, input_values)) % 2 == 1
    if t == GateType.XNOR:
        return sum(map(bool, input_values)) % 2 != 1
    if t == GateType.NOT:
        return not input_values[0]
    if t == GateType.MUX:
        sel, in0, in1 = input_values[2], input_values[0], input_values[1]
        return (sel and in0) or ((not sel) and in1)
    if t == GateType.CONST_ONE:
        return True
    if t == GateType.CONST_ZERO:
        return False
    if t == GateType.LUT:
        end = len(input_values) - 1
        idx = 0
        for i, v in enumerate(input_values):
            if v:
                idx += 1 << (end - i)
        assert gate.lut_const is not None, f"LUT const missing on {gate.name}"
        return (gate.lut_const[idx] & 1) > 0
    raise AssertionError(f"gate type {t} has no boolean plaintext semantics")


def evaluate_arith_ptxt(gate: Gate, a: int, b: int | None, width: int) -> int:
    """Arithmetic plaintext semantics, wrapping at 2^width
    (reference: src/gates.rs:306-702 via native Rust integer ops)."""
    mask = (1 << width) - 1
    t = gate.type
    if t == GateType.COPY:
        return a & mask
    assert b is not None
    if t == GateType.ADD:
        return (a + b) & mask
    if t == GateType.SUB:
        return (a - b) & mask
    if t == GateType.MULT:
        return (a * b) & mask
    if t == GateType.DIV:
        # div-by-zero yields all-ones (restoring-division semantics; the
        # encrypted engine behaves identically)
        return (a // b) & mask if b else mask
    if t == GateType.SHL:
        return (a << b) & mask if b < width else 0
    if t == GateType.SHR:
        return (a >> b) & mask if b < width else 0
    raise AssertionError(f"not an arithmetic gate: {t}")
