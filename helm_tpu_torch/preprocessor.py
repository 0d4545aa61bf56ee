"""Netlist preprocessor: Yosys output / behavioral arith -> processed form.

The port's own copy of `helm_tpu/preprocessor.py` (standard library only;
the output text is the original's byte for byte,
tests/test_torch_preprocessor.py). Counterpart of the reference's external
`preprocessor` binary (hdl-benchmarks submodule, invoked per
README.md:116-137): converts

1. gate-level structural Verilog as emitted by Yosys (`write_verilog
   -noexpr`), with named-port standard-cell or `$_AND_`-style instances,
   into HELM processed-netlist gate lines; and
2. behavioral arithmetic Verilog (`assign out = expr;` with + - * / << >>)
   into arith gate lines (`--arithmetic` mode), introducing temporaries via
   a precedence-climbing expression parser.

CLI: python -m helm_tpu_torch.preprocessor --input X.v --output Y.v [--arithmetic]
"""

from __future__ import annotations

import argparse
import re
import sys

# ----------------------------------------------------------------------
# 1. Gate-level (Yosys) conversion
# ----------------------------------------------------------------------

# cell-name prefix -> (helm keyword, output port names)
CELL_MAP = {
    "NAND": "nand",
    "NOR": "nor",
    "XNOR": "xnor",
    "XOR": "xor",
    "AND": "and",
    "OR": "or",
    "NOT": "not",
    "INV": "not",
    "BUF": "buf",
    "DFF": "dff",
    "MUX": "mux",
}
YOSYS_INTERNAL = {
    "$_AND_": "and",
    "$_OR_": "or",
    "$_NAND_": "nand",
    "$_NOR_": "nor",
    "$_XOR_": "xor",
    "$_XNOR_": "xnor",
    "$_NOT_": "not",
    "$_BUF_": "buf",
    "$_MUX_": "mux",
    "$_DFF_P_": "dff",
    "$_DFF_N_": "dff",
}

# Yosys internal cells with no single-gate HELM equivalent, lowered to a
# short network of the 20 reference gate types (semantics per Yosys
# simcells.v; clock polarity is irrelevant in the single-clock cycle model,
# matching the reference's treatment of $_DFF_P_/$_DFF_N_)
YOSYS_COMPLEX = {
    "$_ANDNOT_": "andnot",  # Y = A & ~B
    "$_ORNOT_": "ornot",  # Y = A | ~B
    "$_NMUX_": "nmux",  # Y = ~(S ? B : A)
    "$_AOI3_": "aoi3",  # Y = ~((A & B) | C)
    "$_OAI3_": "oai3",  # Y = ~((A | B) & C)
    "$_AOI4_": "aoi4",  # Y = ~((A & B) | (C & D))
    "$_OAI4_": "oai4",  # Y = ~((A | B) & (C | D))
    "$_MUX4_": "mux4",  # Y = T ? (S ? D : C) : (S ? B : A)
    "$_MUX8_": "mux8",
    "$_MUX16_": "mux16",
}
# flip-flops with synchronous controls (enable / sync reset): representable
# as a mux/logic network in front of a plain dff, since HELM dff outputs are
# pseudo-inputs readable in the same cycle (verilog_parser.rs:225-239)
_DFFE_RE = re.compile(r"^\$_DFFE_[PN]([PN])_$")
_SDFF_RE = re.compile(r"^\$_SDFF_[PN]([PN])([01])_$")
_SDFFE_RE = re.compile(r"^\$_SDFFE_[PN]([PN])([01])([PN])_$")
# async-control cells cannot be modeled in a synchronous cycle loop
_ASYNC_RE = re.compile(
    r"^\$_(DFF_[PN][PN][01]|DFFE_[PN][PN][01][PN]|DFFSR|DFFSRE|ALDFF|"
    r"DLATCH|SR|FF)"
)
OUT_PORTS = ("Y", "Q", "Z", "OUT")
# port order for helm gate lines
PORT_ORDER = ("A", "B", "C", "D", "S", "E", "IN", "D0", "D1")


def _cell_kind(name: str) -> str | None:
    if name in YOSYS_INTERNAL:
        return YOSYS_INTERNAL[name]
    if name in YOSYS_COMPLEX:
        return YOSYS_COMPLEX[name]
    m = _DFFE_RE.match(name)
    if m:
        return f"dffe:{m.group(1)}"
    m = _SDFF_RE.match(name)
    if m:
        return f"sdff:{m.group(1)}{m.group(2)}"
    m = _SDFFE_RE.match(name)
    if m:
        return f"sdffe:{m.group(1)}{m.group(2)}{m.group(3)}"
    if _ASYNC_RE.match(name):
        raise ValueError(
            f"cell {name!r} has asynchronous controls, which a synchronous "
            "cycle-based evaluation cannot model; re-synthesize with "
            "synchronous resets (yosys: dfflegalize -cell $_SDFF_???_ 01)"
        )
    up = name.upper()
    for prefix, kw in CELL_MAP.items():
        if up.startswith(prefix):
            return kw
    return None


_INSTANCE_RE = re.compile(
    r"^\s*([\w$\\]+)\s+([\w$\\.\[\]]+)\s*\(\s*(.*)\s*\)\s*;\s*$", re.S
)
_PORT_RE = re.compile(r"\.(\w+)\s*\(\s*([^)]*?)\s*\)")


def _flatten_statements(text: str) -> list[str]:
    # strip comments, join statements split across lines
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    stmts, cur = [], []
    for ch in text:
        cur.append(ch)
        if ch == ";":
            stmts.append("".join(cur).strip())
            cur = []
    if "".join(cur).strip():
        stmts.append("".join(cur).strip())
    return stmts


def _clean_name(w: str) -> str:
    return w.strip().replace("\\", "")


def convert_gates(text: str) -> str:
    """Yosys gate-level verilog -> HELM processed netlist text."""
    out_lines = []
    header: list[str] = []
    extra_wires: list[str] = []
    clock_wires: set[str] = set()
    used_wires: set[str] = set()
    gid = [0]
    wid = [0]

    def emit(kind: str, *args: str) -> None:
        gid[0] += 1
        used_wires.update(args)
        out_lines.append(f"  {kind} g{gid[0]}({', '.join(args)});")

    def fresh() -> str:
        wid[0] += 1
        w = f"_p{wid[0]}"
        extra_wires.append(w)
        return w

    def emit_t(kind: str, *ins: str) -> str:
        t = fresh()
        emit(kind, *ins, t)
        return t

    def sel_mux(a: str, b: str, s: str, out: str | None = None) -> str:
        # yosys S ? B : A -> helm mux ID(in0, in1, sel, out) = sel ? in0 : in1
        # (gates.rs:189-194)
        if out is None:
            return emit_t("mux", b, a, s)
        emit("mux", b, a, s, out)
        return out

    def mux_tree(data: list[str], sels: list[str], out: str) -> None:
        # yosys $_MUX4/8/16_: first select chooses within adjacent pairs,
        # last select chooses between halves
        while len(data) > 2:
            s, sels = sels[0], sels[1:]
            data = [
                sel_mux(data[i], data[i + 1], s)
                for i in range(0, len(data), 2)
            ]
        sel_mux(data[0], data[1], sels[0], out)

    def dff_data(kind: str, ports: dict, q: str) -> str:
        """Effective D for enable/sync-reset flop variants (Q readable in
        the same cycle: HELM dff outputs are pseudo-inputs)."""
        variant, flags = kind.split(":")
        d = ports["D"]
        if variant in ("dffe", "sdffe"):
            epol = flags[0] if variant == "dffe" else flags[2]
            en = ports["E"]
            # active-high: E ? D : Q;  active-low: E ? Q : D
            d = sel_mux(q, d, en) if epol == "P" else sel_mux(d, q, en)
        if variant in ("sdff", "sdffe"):
            rpol, rval = flags[0], flags[1]
            r = ports["R"]
            # reset has priority over enable (simcells.v $_SDFFE_*)
            if rpol == "P" and rval == "0":  # D & ~R
                d = emit_t("and", d, emit_t("not", r))
            elif rpol == "P" and rval == "1":  # D | R
                d = emit_t("or", d, r)
            elif rpol == "N" and rval == "0":  # D & R
                d = emit_t("and", d, r)
            else:  # N, 1: D | ~R
                d = emit_t("or", d, emit_t("not", r))
        return d

    for stmt in _flatten_statements(text):
        s = " ".join(stmt.split())
        if not s:
            continue
        kw = s.split()[0]
        if kw in ("module", "endmodule", "input", "output", "wire", "reg"):
            header.append(s if s.endswith(";") or kw in ("module", "endmodule") else s + ";")
            continue
        m = _INSTANCE_RE.match(stmt)
        if not m:
            continue
        cell, _inst, ports_text = m.group(1), m.group(2), m.group(3)
        kind = _cell_kind(cell)
        if kind is None:
            raise ValueError(f"unknown cell type {cell!r}")
        ports = {p.upper(): _clean_name(v) for p, v in _PORT_RE.findall(ports_text)}
        outw = None
        for op in OUT_PORTS:
            if op in ports:
                outw = ports.pop(op)
                break
        if outw is None:
            raise ValueError(f"no output port on {cell} instance: {ports}")
        if kind == "dff" or kind.startswith(("dffe:", "sdff:", "sdffe:")):
            # drop clock pins: processed netlists are clockless (the cycle
            # loop IS the clock), and pure clock nets leave the input list
            for cp in ("C", "CK", "CLK", "CLOCK"):
                if cp in ports:
                    clock_wires.add(ports.pop(cp))
        if kind == "mux":
            sel_mux(ports["A"], ports["B"], ports["S"], outw)
        elif kind == "nmux":
            emit("not", sel_mux(ports["A"], ports["B"], ports["S"]), outw)
        elif kind == "andnot":  # Y = A & ~B
            emit("and", ports["A"], emit_t("not", ports["B"]), outw)
        elif kind == "ornot":  # Y = A | ~B
            emit("or", ports["A"], emit_t("not", ports["B"]), outw)
        elif kind == "aoi3":  # Y = ~((A & B) | C)
            emit("nor", emit_t("and", ports["A"], ports["B"]), ports["C"], outw)
        elif kind == "oai3":  # Y = ~((A | B) & C)
            emit("nand", emit_t("or", ports["A"], ports["B"]), ports["C"], outw)
        elif kind == "aoi4":  # Y = ~((A & B) | (C & D))
            emit(
                "nor",
                emit_t("and", ports["A"], ports["B"]),
                emit_t("and", ports["C"], ports["D"]),
                outw,
            )
        elif kind == "oai4":  # Y = ~((A | B) & (C | D))
            emit(
                "nand",
                emit_t("or", ports["A"], ports["B"]),
                emit_t("or", ports["C"], ports["D"]),
                outw,
            )
        elif kind in ("mux4", "mux8", "mux16"):
            nd = {"mux4": 4, "mux8": 8, "mux16": 16}[kind]
            data = [ports[chr(ord("A") + i)] for i in range(nd)]
            sels = [chr(ord("S") + i) for i in range(nd.bit_length() - 1)]
            mux_tree(data, [ports[s] for s in sels], outw)
        elif kind.startswith(("dffe:", "sdff:", "sdffe:")):
            emit("dff", dff_data(kind, ports, outw), outw)
        elif kind in ("not", "buf", "dff"):
            ins = [ports[p] for p in PORT_ORDER if p in ports]
            emit(kind, ins[0], outw)
        else:
            ins = [ports[p] for p in PORT_ORDER if p in ports]
            emit(kind, ins[0], ins[1], outw)
    if extra_wires:
        out_lines.insert(0, f"  wire {', '.join(extra_wires)};")
    dead_clocks = clock_wires - used_wires
    if dead_clocks:
        pruned = []
        for h in header:
            if h.startswith("input"):
                names = [
                    n.strip() for n in h[len("input"):].rstrip(";").split(",")
                ]
                names = [n for n in names if n not in dead_clocks]
                if not names:
                    continue
                h = "input " + ", ".join(names) + ";"
            pruned.append(h)
        header = pruned
    body = "\n".join(out_lines)
    hdr = "\n".join("  " + h if not h.startswith(("module", "endmodule")) else h for h in header if not h.startswith("endmodule"))
    return f"{hdr}\n{body}\nendmodule\n"


# ----------------------------------------------------------------------
# 2. Behavioral arithmetic conversion
# ----------------------------------------------------------------------

_TOKEN_RE = re.compile(r"\s*(<<|>>|[()+\-*/]|\w+)")

_PRec = {"+": 1, "-": 1, "*": 2, "/": 2, "<<": 0, ">>": 0}
_OP_GATE = {"+": "add", "-": "sub", "*": "mult", "/": "div", "<<": "shl", ">>": "shr"}


class _ExprParser:
    """Precedence-climbing parser emitting 3-address arith gates."""

    def __init__(self, emit, fresh):
        self.emit = emit
        self.fresh = fresh

    def parse(self, expr: str) -> str:
        self.toks = [t for t in _TOKEN_RE.findall(expr)]
        self.pos = 0
        result = self._expr(0)
        if self.pos != len(self.toks):
            raise ValueError(f"trailing tokens in expression: {expr!r}")
        return result

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def _next(self):
        t = self._peek()
        self.pos += 1
        return t

    def _atom(self) -> str:
        t = self._next()
        if t == "(":
            v = self._expr(0)
            if self._next() != ")":
                raise ValueError("unbalanced parentheses")
            return v
        if t is None or t in _PRec or t == ")":
            raise ValueError(f"unexpected token {t!r}")
        return t

    def _expr(self, min_prec: int) -> str:
        lhs = self._atom()
        while True:
            op = self._peek()
            if op not in _PRec or _PRec[op] < min_prec:
                return lhs
            self._next()
            rhs = self._expr(_PRec[op] + 1)
            tmp = self.fresh()
            self.emit(_OP_GATE[op], lhs, rhs, tmp)
            lhs = tmp


_ASSIGN_RE = re.compile(r"^\s*assign\s+([\w\[\]]+)\s*=\s*(.+?)\s*;\s*$", re.S)


def convert_arith(text: str) -> str:
    """Behavioral arith verilog (`assign` expressions) -> processed form."""
    header: list[str] = []
    gates: list[str] = []
    tmp_wires: list[str] = []
    counter = [0]
    gid = [0]

    def fresh() -> str:
        counter[0] += 1
        tmp_wires.append(f"_t{counter[0]}")
        return f"_t{counter[0]}"

    assigns: list[tuple[str, str]] = []
    for stmt in _flatten_statements(text):
        s = " ".join(stmt.split())
        if not s:
            continue
        kw = s.split()[0]
        if kw in ("module", "endmodule", "input", "output", "wire", "reg"):
            if not s.startswith("endmodule"):
                header.append(s)
            continue
        m = _ASSIGN_RE.match(stmt)
        if m:
            assigns.append((m.group(1), m.group(2)))
        elif s.startswith("assign"):
            raise ValueError(f"unsupported assign statement: {s!r}")

    for dst, expr in assigns:
        def emit(op, a, b, out):
            gid[0] += 1
            gates.append(f"  {op} a{gid[0]}({a}, {b}, {out});")

        parser = _ExprParser(emit, fresh)
        result = parser.parse(expr)
        if result != dst:
            if gates and gates[-1].endswith(f" {result});"):
                # retarget the last gate straight onto dst
                gates[-1] = gates[-1].replace(f" {result});", f" {dst});")
                tmp_wires.remove(result)
            else:
                gid[0] += 1
                gates.append(f"  copy a{gid[0]}({result}, {dst});")

    hdr = "\n".join(
        "  " + h if not h.startswith("module") else h for h in header
    )
    wires = f"  wire {', '.join(tmp_wires)};\n" if tmp_wires else ""
    return f"{hdr}\n{wires}" + "\n".join(gates) + "\nendmodule\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="helm-tpu-torch-preprocess")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--arithmetic", action="store_true")
    args = ap.parse_args(argv)
    text = open(args.input).read()
    out = convert_arith(text) if args.arithmetic else convert_gates(text)
    with open(args.output, "w") as f:
        f.write(out)
    print(f"[✓] wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
