"""Level plan compiler: levelized circuit -> batched-launch execution plans.

The reference evaluates each level by fanning gates out to rayon threads
(circuit.rs:531) or packing per-gate-type CUDA vector launches
(circuit.rs:672-875). Here every level becomes ONE batched PBS launch over
all its bootstrapping gates plus vectorized linear ops:

- 2-input Boolean gates       -> 1 PBS slot (linear combo + sign bootstrap)
- MUX                          -> 2 PBS slots (sel&a, !sel&b) + linear combine
- LUT gates (1..3 inputs)      -> 1 PBS slot with a per-gate test polynomial
- NOT/BUF/DFF/COPY/consts      -> pure linear ops (no bootstrap), matching
  tfhe-rs gate semantics (NOT = ciphertext negation, DFF/BUF = copy,
  consts = trivial encryptions; reference gates.rs:254-275)

Plans are static numpy index/coefficient arrays padded to power-of-two
buckets so the jitted level step compiles once per bucket shape, not once
per level.

The port's own copy of `helm_tpu/circuit/plan.py`, trimmed to what the
port calls, so that helm_tpu_torch imports nothing of the JAX package;
the tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import Q, TfheParams
from .gates import Gate, GateType
from .graph import Circuit

Q8 = 1 << 29  # q/8

# linear-combination recipes for the sign bootstrap (DESIGN.md §3):
#   AND: c1+c2-q/8   OR: c1+c2+q/8   NAND: -(c1+c2)+q/8   NOR: -(c1+c2)-q/8
#   XOR: 2(c1+c2)+q/4   XNOR: -2(c1+c2)-q/4
_BOOL_RECIPE = {
    GateType.AND: (1, 1, (-Q8) % Q),
    GateType.OR: (1, 1, Q8),
    GateType.NAND: (-1, -1, Q8),
    GateType.NOR: (-1, -1, (-Q8) % Q),
    GateType.XOR: (2, 2, 2 * Q8),
    GateType.XNOR: (-2, -2, (-2 * Q8) % Q),
}

MAX_SLOT_INPUTS = 3


@dataclass
class LevelPlan:
    """One level's worth of batched work (padded static arrays)."""

    num_slots: int  # PBS slots after pow2 padding (= slot_in.shape[0])
    real_slots: int  # PBS slots carrying real gate work (before padding)
    slot_in: np.ndarray  # int32 [S, 3] wire indices
    slot_coef: np.ndarray  # int32 [S, 3]
    slot_off: np.ndarray  # uint32 [S] body offsets
    slot_dst: np.ndarray  # int32 [S] output wire index (trash for mux slots)
    testv_sel: np.ndarray | None  # int32 [S] index into the testv bank (lut)
    mux_pairs: np.ndarray  # int32 [M, 2] slot indices
    mux_dst: np.ndarray  # int32 [M]
    lin_src: np.ndarray  # int32 [L]
    lin_coef: np.ndarray  # int32 [L]
    lin_off: np.ndarray  # uint32 [L]
    lin_dst: np.ndarray  # int32 [L]


@dataclass
class CircuitPlan:
    params: TfheParams
    wire_index: dict[str, int]
    num_wires: int  # includes trash slot at index num_wires-1
    levels: list[LevelPlan]
    testv_bank: np.ndarray | None  # uint32 [T, N] distinct LUT test polys
    mode: str  # "gates" | "lut"
    input_wires: list[str]
    output_wires: list[str]
    dff_outputs: list[str]


def _pad_pow2(n: int, minimum: int = 1) -> int:
    m = max(n, minimum)
    return 1 << (m - 1).bit_length() if m > 0 else minimum


def build_plan(
    circuit: Circuit,
    wire_set: set[str],
    params: TfheParams,
    mode: str,
    lut_test_poly_fn=None,
    min_slots: int = 1,
) -> CircuitPlan:
    all_wires = sorted(
        set(wire_set) | set(circuit.input_wires) | set(circuit.dff_outputs)
    )
    wire_index = {w: i for i, w in enumerate(all_wires)}
    trash = len(all_wires)
    num_wires = trash + 1

    testv_cache: dict[tuple, int] = {}
    testv_rows: list[np.ndarray] = []

    def testv_id(table: tuple) -> int:
        if table not in testv_cache:
            testv_cache[table] = len(testv_rows)
            testv_rows.append(lut_test_poly_fn(np.array(table, dtype=np.uint64)))
        return testv_cache[table]

    enc_true = np.uint32(Q8 if mode == "gates" else params.delta)
    enc_false = np.uint32((-Q8) % Q if mode == "gates" else 0)

    level_plans = []
    for _, gates in circuit.levels:
        slots_in, slots_coef, slots_off, slots_dst, slots_tv = [], [], [], [], []
        mux_pairs, mux_dst = [], []
        lin = []  # (src, coef, off, dst)

        def add_slot(idxs, coefs, off, dst, tv=None):
            idxs = list(idxs) + [0] * (MAX_SLOT_INPUTS - len(idxs))
            coefs = list(coefs) + [0] * (MAX_SLOT_INPUTS - len(coefs))
            slots_in.append(idxs)
            slots_coef.append(coefs)
            slots_off.append(off)
            slots_dst.append(dst)
            slots_tv.append(tv if tv is not None else 0)
            return len(slots_in) - 1

        for g in gates:
            dst = wire_index[g.output]
            t = g.type
            if t in _BOOL_RECIPE:
                if mode == "lut":
                    raise ValueError(
                        f"Boolean gate {g.name} in LUT-mode circuit"
                    )
                if len(g.inputs) != 2:
                    raise ValueError(
                        f"{t.value} gate {g.name} has {len(g.inputs)} inputs; "
                        "run binarize() first"
                    )
                c1, c2, off = _BOOL_RECIPE[t]
                i1, i2 = (wire_index[w] for w in g.inputs)
                add_slot([i1, i2], [c1, c2], np.uint32(off), dst)
            elif t == GateType.MUX:
                i0, i1, isel = (wire_index[w] for w in g.inputs)
                # out = (sel & in0) | (!sel & in1): two ANDs, linear combine
                s1 = add_slot([isel, i0], [1, 1], np.uint32((-Q8) % Q), trash)
                s2 = add_slot([isel, i1], [-1, 1], np.uint32((-Q8) % Q), trash)
                mux_pairs.append([s1, s2])
                mux_dst.append(dst)
            elif t == GateType.LUT:
                if mode != "lut":
                    raise ValueError("Can't mix LUTs with Boolean gates!")
                w = len(g.inputs)
                if w > MAX_SLOT_INPUTS:
                    raise ValueError(
                        f"LUT {g.name}: {w} inputs exceeds the "
                        f"{MAX_SLOT_INPUTS}-input message space"
                    )
                table = g.lut_const
                if w == 1 and all(v == 0 for v in table):
                    # reference gates.rs:765-767: all-zero 1-input LUT = copy
                    lin.append((wire_index[g.inputs[0]], 1, np.uint32(0), dst))
                    continue
                idxs = [wire_index[x] for x in g.inputs]
                coefs = [1 << (w - 1 - i) for i in range(w)]
                half_space = params.msg_space // 2
                full = tuple(
                    (table[m % (1 << w)] & 1) for m in range(half_space)
                )
                add_slot(idxs, coefs, np.uint32(0), dst, testv_id(full))
            elif t == GateType.NOT:
                lin.append((wire_index[g.inputs[0]], -1, np.uint32(0), dst))
                if mode == "lut":
                    # msg-encoded NOT: 1 - x  => delta - x
                    lin[-1] = (
                        wire_index[g.inputs[0]],
                        -1,
                        np.uint32(params.delta),
                        dst,
                    )
            elif t in (GateType.BUF, GateType.DFF):
                lin.append((wire_index[g.inputs[0]], 1, np.uint32(0), dst))
            elif t == GateType.CONST_ONE:
                lin.append((0, 0, enc_true, dst))
            elif t == GateType.CONST_ZERO:
                lin.append((0, 0, enc_false, dst))
            else:
                raise ValueError(
                    f"gate type {t.value} not supported in {mode} mode"
                )

        real_S = len(slots_in)  # PBS slots carrying real gate work
        S = _pad_pow2(len(slots_in), min_slots) if slots_in else 0
        while len(slots_in) < S:
            add_slot([0], [0], np.uint32(0), trash, 0)
        M = _pad_pow2(len(mux_pairs)) if mux_pairs else 0
        while len(mux_pairs) < M:
            mux_pairs.append([0, 0])
            mux_dst.append(trash)
        L = _pad_pow2(len(lin)) if lin else 0
        while len(lin) < L:
            lin.append((0, 0, np.uint32(0), trash))

        level_plans.append(
            LevelPlan(
                num_slots=S,
                real_slots=real_S,
                slot_in=np.array(slots_in, dtype=np.int32).reshape(S, MAX_SLOT_INPUTS),
                slot_coef=np.array(slots_coef, dtype=np.int32).reshape(S, MAX_SLOT_INPUTS),
                slot_off=np.array(slots_off, dtype=np.uint32).reshape(S),
                slot_dst=np.array(slots_dst, dtype=np.int32).reshape(S),
                testv_sel=(
                    np.array(slots_tv, dtype=np.int32).reshape(S)
                    if mode == "lut"
                    else None
                ),
                mux_pairs=np.array(mux_pairs, dtype=np.int32).reshape(M, 2),
                mux_dst=np.array(mux_dst, dtype=np.int32).reshape(M),
                lin_src=np.array([x[0] for x in lin], dtype=np.int32),
                lin_coef=np.array([x[1] for x in lin], dtype=np.int32),
                lin_off=np.array([x[2] for x in lin], dtype=np.uint32),
                lin_dst=np.array([x[3] for x in lin], dtype=np.int32),
            )
        )

    testv_bank = np.stack(testv_rows) if testv_rows else None
    return CircuitPlan(
        params=params,
        wire_index=wire_index,
        num_wires=num_wires,
        levels=level_plans,
        testv_bank=testv_bank,
        mode=mode,
        input_wires=list(circuit.input_wires),
        output_wires=list(circuit.output_wires),
        dff_outputs=list(circuit.dff_outputs),
    )


def decompose_wide_luts(gates: list[Gate], max_inputs: int = MAX_SLOT_INPUTS) -> list[Gate]:
    """Shannon-decompose LUTs wider than the message space into 3-input trees.

    Covers the reference's high-precision LUT capability (C11,
    gates.rs:721-743 WoPBS path) without wide-plaintext bootstrapping: an
    n-input LUT splits on its first (MSB) input into two (n-1)-input LUTs
    plus a 3-input select LUT (idx = a*4 + f1*2 + f0 -> a ? f1 : f0).
    """
    # select table: out = a ? n1 : n0 for idx = a*4 + n1*2 + n0
    SELECT = [((i >> 1) & 1) if (i >> 2) & 1 else (i & 1) for i in range(8)]
    out: list[Gate] = []

    def expand(name: str, table: list[int], inputs: list[str], output: str, d=0):
        if len(inputs) <= max_inputs:
            out.append(Gate(name, GateType.LUT, list(inputs), output, list(table)))
            return
        half = 1 << (len(inputs) - 1)
        a, rest = inputs[0], inputs[1:]
        w0, w1 = f"{name}__s{d}l", f"{name}__s{d}h"
        expand(w0 + "g", table[:half], rest, w0, d + 1)
        expand(w1 + "g", table[half:], rest, w1, d + 1)
        out.append(
            Gate(name, GateType.LUT, [a, w1, w0], output, list(SELECT))
        )

    for g in gates:
        if g.type == GateType.LUT and len(g.inputs) > max_inputs:
            expand(g.name, g.lut_const, g.inputs, g.output)
        else:
            out.append(g)
    return out


def binarize(gates: list[Gate]) -> list[Gate]:
    """Expand n-ary Boolean gates into 2-input chains (plan requirement).

    The reference oracle supports n-ary gates (gates.rs:154-232) but its
    encrypted engines only ever see 2-input netlists; we lower explicitly.
    """
    out = []
    for g in gates:
        if g.type in _BOOL_RECIPE and len(g.inputs) > 2:
            base = {
                GateType.NAND: GateType.AND,
                GateType.NOR: GateType.OR,
                GateType.XNOR: GateType.XOR,
            }.get(g.type, g.type)
            cur = g.inputs[0]
            for i, w in enumerate(g.inputs[1:-1]):
                tmp = f"{g.name}__bin{i}"
                out.append(Gate(tmp, base, [cur, w], tmp))
                cur = tmp
            out.append(Gate(g.name, g.type if g.type != base else base,
                            [cur, g.inputs[-1]], g.output))
        else:
            out.append(g)
    return out
