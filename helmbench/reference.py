"""The plain reference: what a circuit's outputs must be, and how far the
program's output ciphertexts lie from them. NumPy only; it imports nothing
of the program, of JAX or of the JAX package.

- `read_netlist`: a frozen reader of the "HELM processed netlist" form
  (`module`/`endmodule`/`//` lines skipped; `input`/`output` ranges expand
  to `name[i]` bits in gates mode and stay whole words in arith mode;
  `wire` lines ignored; one gate instance a line, its output last);
- `evaluate_gates` / `evaluate_arith`: the plaintext circuit over many
  vectors at once (and, or, nand, nor, xor, xnor, not, buf on bits;
  mult, add, sub on unsigned words with wrap-around, numeric literals as
  plaintext operands);
- `phase`: LWE decryption b - <a, s> mod 2^32 with the benchmark's own key;
- `judge_gates` / `judge_arith`: every output decoded (gates: phase in
  (0, q/2) is true; arith: each 2-bit radix block rounded to the nearest
  multiple of delta = q / 2^msg_space_log, its message bits read) and
  compared with the plaintext value, and each output ciphertext's phase
  error against the exact encoding of that value (gates +-q/8; arith the
  block's digit x delta), as a share of the distance at which decoding
  flips (gates q/8, arith delta/2): its deviation about the run's mean
  (`noise_std`; the mean is one offset that the keyswitching key's fixed
  noise puts on every output of a key), its rms and its largest.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

Q = 1 << 32
_GATE = re.compile(r"^(\w+)\s+\w+\s*\((.*)\)\s*;\s*$")
_BOOL = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "nand": lambda a, b: ~(a & b),
    "nor": lambda a, b: ~(a | b),
    "xor": lambda a, b: a ^ b,
    "xnor": lambda a, b: ~(a ^ b),
}
_UNARY = {"buf": lambda a: a, "not": lambda a: ~a}
_ARITH = {
    "mult": lambda a, b: a * b,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
}


@dataclass
class Netlist:
    inputs: list
    outputs: list
    gates: list  # (type, [inputs], output), in an order that evaluates


def read_netlist(path: str, arith: bool) -> Netlist:
    inputs, outputs, gates = [], [], []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(("module", "endmodule", "//", "wire")):
                continue
            kind = line.split()[0]
            if kind in ("input", "output"):
                dest = inputs if kind == "input" else outputs
                rest = line[len(kind):].strip().rstrip(";")
                m = re.match(r"^\[(\d+):(\d+)\]\s*(.*)$", rest)
                names = [s.strip() for s in (m.group(3) if m else rest).split(",") if s.strip()]
                if m and not arith:
                    lo, hi = sorted((int(m.group(1)), int(m.group(2))))
                    for name in names:
                        dest.extend(f"{name}[{i}]" for i in range(lo, hi + 1))
                else:
                    dest.extend(names)
                continue
            m = _GATE.match(line)
            if m is None:
                raise ValueError(f"{path}: cannot read the line {line!r}")
            args = [a.strip() for a in m.group(2).split(",")]
            gtype = m.group(1)
            if gtype not in (_ARITH if arith else {**_BOOL, **_UNARY}):
                raise ValueError(f"{path}: gate type {gtype!r} is not in the reference")
            gates.append((gtype, args[:-1], args[-1]))
    return Netlist(inputs, outputs, _ordered(gates, set(inputs)))


def _is_literal(name: str) -> bool:
    return name.isdigit()


def _ordered(gates: list, known: set) -> list:
    """The gates in an order in which every input is known before use."""
    known = set(known)
    out, left = [], list(gates)
    while left:
        rest = [g for g in left if not all(a in known or _is_literal(a) for a in g[1])]
        ready = [g for g in left if g not in rest]
        if not ready:
            raise ValueError(f"netlist has a cycle or an undriven wire near {rest[0]}")
        out.extend(ready)
        known.update(g[2] for g in ready)
        left = rest
    return out


def evaluate_gates(nl: Netlist, bits: np.ndarray) -> np.ndarray:
    """bits [V, len(inputs)] bool -> outputs [V, len(outputs)] bool."""
    wires = {w: bits[:, i].astype(bool) for i, w in enumerate(nl.inputs)}
    for gtype, ins, out in nl.gates:
        if gtype in _UNARY:
            wires[out] = _UNARY[gtype](wires[ins[0]])
        else:
            wires[out] = _BOOL[gtype](wires[ins[0]], wires[ins[1]])
    return np.stack([wires[w] for w in nl.outputs], axis=1)


def evaluate_arith(nl: Netlist, values: np.ndarray, bits: int = 32) -> np.ndarray:
    """values [V, len(inputs)] of `bits`-bit words -> outputs [V, len(outputs)],
    every operation mod 2^bits."""
    V = values.shape[0]
    mask = np.uint64((1 << bits) - 1)
    wires = {w: values[:, i].astype(np.uint64) & mask for i, w in enumerate(nl.inputs)}

    def operand(name):
        return np.full(V, int(name), np.uint64) & mask if _is_literal(name) else wires[name]

    with np.errstate(over="ignore"):  # uint64 wraps mod 2^64, a multiple of 2^bits
        for gtype, ins, out in nl.gates:
            wires[out] = _ARITH[gtype](operand(ins[0]), operand(ins[1])) & mask
    return np.stack([wires[w] for w in nl.outputs], axis=1).astype(np.uint64)


def phase(ct: np.ndarray, key: np.ndarray) -> np.ndarray:
    """b - <a, s> mod 2^32 of LWE ciphertexts [..., n+1] under key [n]."""
    ct = np.asarray(ct, dtype=np.uint64)
    n = key.shape[0]
    dot = (ct[..., :n] * key.astype(np.uint64)).sum(axis=-1)
    return (ct[..., n] - dot) % Q


def _signed(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64) % Q
    return np.where(x >= Q // 2, x - Q, x)


@dataclass
class Judgement:
    failed: int  # vectors with at least one wrong output
    wrong_outputs: int  # outputs whose decryption differs from the plaintext
    noise_std: float  # the phase errors' deviation about their mean, as a share of the decoding distance
    noise_rms: float  # their rms (the mean, one offset the key puts on every output, included)
    noise_max: float


def _judgement(wrong: np.ndarray, rel: np.ndarray) -> Judgement:
    V = wrong.shape[0]
    per_vector = wrong.reshape(V, -1).any(axis=1)
    return Judgement(
        failed=int(per_vector.sum()),
        wrong_outputs=int(wrong.sum()),
        noise_std=float(np.std(rel)) if rel.size else 0.0,
        noise_rms=float(np.sqrt(np.mean(rel**2))) if rel.size else 0.0,
        noise_max=float(np.abs(rel).max()) if rel.size else 0.0,
    )


def judge_gates(expected: np.ndarray, cts: np.ndarray, key: np.ndarray) -> Judgement:
    """expected [V, n_out] bool; cts [V, n_out, n+1] the program's output
    ciphertexts."""
    ph = phase(cts, key)
    decoded = ph < Q // 2
    enc = np.where(expected, Q // 8, Q - Q // 8).astype(np.uint64)
    rel = _signed(ph - enc) / (Q // 8)
    return _judgement(decoded != expected, rel)


def judge_arith(expected: np.ndarray, cts: np.ndarray, key: np.ndarray, msg_space_log: int,
                message_bits: int) -> Judgement:
    """expected [V, n_out] words; cts [V, n_out, blocks, n+1], block i holding
    bits [message_bits * i, message_bits * (i + 1)) of the word."""
    ph = phase(cts, key)
    delta = Q >> msg_space_log
    blocks = cts.shape[-2]
    shifts = (message_bits * np.arange(blocks)).astype(np.uint64)
    mask = np.uint64((1 << message_bits) - 1)
    digits = (expected[..., None].astype(np.uint64) >> shifts) & mask
    msgs = ((ph + delta // 2) // delta) % (1 << msg_space_log)
    got = ((msgs & mask) << shifts).sum(axis=-1)
    rel = _signed(ph - digits * delta) / (delta // 2)
    return _judgement(got != expected.astype(np.uint64), rel)
