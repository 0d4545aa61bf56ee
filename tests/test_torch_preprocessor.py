"""helm_tpu_torch.preprocessor against helm_tpu.preprocessor: the same
processed-netlist text byte for byte, the same oracle values, the same
errors, the same CLI output files.

The netlist texts are tests/test_preprocessor.py's, copied here as
parametrised cases, plus seeded random trees of Yosys `$_MUX4_`,
`$_MUX8_`, `$_MUX16_` and `$_MUX_` cells.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from helm_tpu import preprocessor as ref
from helm_tpu.circuit.graph import Circuit as RefCircuit
from helm_tpu.circuit.verilog import parse_verilog as ref_parse
from helm_tpu_torch import preprocessor as port
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import parse_verilog
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]

YOSYS_FA = """
// full adder, yosys -noexpr style
module fa(a, b, cin, s, cout);
  input a, b, cin;
  output s, cout;
  wire w1, w2, w3;
  XOR2X1 u1 (.A(a), .B(b), .Y(w1));
  XOR2X1 u2 (.A(w1), .B(cin), .Y(s));
  $_AND_ u3 (.A(a), .B(b), .Y(w2));
  AND2X2 u4 (.A(cin), .B(w1), .Y(w3));
  OR2X1 u5 (.A(w2), .B(w3), .Y(cout));
endmodule
"""

MUX = """
module m(a, b, s, y);
  input a, b, s;
  output y;
  $_MUX_ u1 (.A(a), .B(b), .S(s), .Y(y));
endmodule
"""

MUX4 = """
module m(a, b, c, d, s, t, y);
  input a, b, c, d, s, t;
  output y;
  $_MUX4_ u1 (.A(a), .B(b), .C(c), .D(d), .S(s), .T(t), .Y(y));
endmodule
"""

MUX8 = """
module m(a, b, c, d, e, f, g, h, s, t, u, y);
  input a, b, c, d, e, f, g, h, s, t, u;
  output y;
  $_MUX8_ u1 (.A(a), .B(b), .C(c), .D(d), .E(e), .F(f), .G(g), .H(h),
              .S(s), .T(t), .U(u), .Y(y));
endmodule
"""

DFF = """
module m(d, clk, q);
  input d, clk;
  output q;
  $_DFF_P_ u1 (.D(d), .C(clk), .Q(q));
endmodule
"""

DFFE = """
module m(d, clk, e, q);
  input d, clk, e;
  output q;
  $_DFFE_PP_ u1 (.D(d), .C(clk), .E(e), .Q(q));
endmodule
"""

SDFF = """
module m(d, clk, r, q);
  input d, clk, r;
  output q;
  $_SDFF_PP0_ u1 (.D(d), .C(clk), .R(r), .Q(q));
endmodule
"""

SDFFE = """
module m(d, clk, r, e, q);
  input d, clk, r, e;
  output q;
  $_SDFFE_PN1P_ u1 (.D(d), .C(clk), .R(r), .E(e), .Q(q));
endmodule
"""

ASYNC = """
module m(d, clk, r, q);
  input d, clk, r;
  output q;
  $_DFF_PP0_ u1 (.D(d), .C(clk), .R(r), .Q(q));
endmodule
"""

BEHAVIORAL = """
// chi-squared style behavioral design
module chi(n0, n1, n2, alpha, beta1);
  input [31:0] n0, n1, n2;
  output [31:0] alpha, beta1;
  assign alpha = (4 * n0 * n2 - n1 * n1) * (4 * n0 * n2 - n1 * n1);
  assign beta1 = 2 * (2 * n0 + n1) * (2 * n0 + n1);
endmodule
"""

SHIFTS = """
module m(x, y, z);
  input [7:0] x, y;
  output [7:0] z;
  assign z = x + y * 2 >> 1;
endmodule
"""


def _cell_module(cell, ports):
    conns = ", ".join(f".{p}({w})" for p, w in ports.items())
    ins = ", ".join(w for p, w in ports.items() if p != "Y")
    return f"""
module m({ins}, y);
  input {ins};
  output y;
  {cell} u1 ({conns}, .Y(y));
endmodule
"""


COMPLEX = [
    ("$_ANDNOT_", dict(A="a", B="b")),
    ("$_ORNOT_", dict(A="a", B="b")),
    ("$_NMUX_", dict(A="a", B="b", S="s")),
    ("$_AOI3_", dict(A="a", B="b", C="c")),
    ("$_OAI3_", dict(A="a", B="b", C="c")),
    ("$_AOI4_", dict(A="a", B="b", C="c", D="d")),
    ("$_OAI4_", dict(A="a", B="b", C="c", D="d")),
]

GATE_TEXTS = {
    "full_adder": YOSYS_FA, "mux": MUX, "mux4": MUX4, "mux8": MUX8,
    "dff": DFF, "dffe": DFFE, "sdff": SDFF, "sdffe": SDFFE,
    **{cell.strip("$_").lower(): _cell_module(cell, ports) for cell, ports in COMPLEX},
}
ARITH_TEXTS = {"behavioral": BEHAVIORAL, "shifts": SHIFTS}


def _random_mux_tree(seed: int) -> str:
    """A module of random Yosys mux cells ($_MUX_, $_MUX4_, $_MUX8_,
    $_MUX16_), each data input a primary input or an earlier cell's output."""
    rng = np.random.default_rng(seed)
    ins = [f"i{j}" for j in range(12)]
    sels = [f"s{j}" for j in range(5)]
    avail, body, wires = list(ins), [], []
    for c in range(int(rng.integers(3, 8))):
        nd = int(rng.choice([2, 4, 8, 16]))
        cell = "$_MUX_" if nd == 2 else f"$_MUX{nd}_"
        data = [avail[int(rng.integers(0, len(avail)))] for _ in range(nd)]
        ss = [sels[int(rng.integers(0, len(sels)))] for _ in range(nd.bit_length() - 1)]
        ports = [f".{chr(ord('A') + i)}({w})" for i, w in enumerate(data)]
        ports += [f".{chr(ord('S') + i)}({w})" for i, w in enumerate(ss)]
        out = f"w{c}"
        wires.append(out)
        body.append(f"  {cell} u{c} ({', '.join(ports)}, .Y({out}));")
        avail.append(out)
    outs = wires[-2:]
    wires = wires[:-2]
    decl = ", ".join(ins + sels + outs)
    return (
        f"module rnd({decl});\n  input {', '.join(ins + sels)};\n  output {', '.join(outs)};\n"
        + (f"  wire {', '.join(wires)};\n" if wires else "")
        + "\n".join(body) + "\nendmodule\n"
    )


@pytest.mark.parametrize("name", sorted(GATE_TEXTS))
def test_convert_gates_is_the_reference_text(name):
    src = GATE_TEXTS[name]
    assert port.convert_gates(src) == ref.convert_gates(src)


@pytest.mark.parametrize("name", sorted(ARITH_TEXTS))
def test_convert_arith_is_the_reference_text(name):
    src = ARITH_TEXTS[name]
    assert port.convert_arith(src) == ref.convert_arith(src)


def _oracles(text: str, seed: int, arith: bool = False):
    """The port's and the reference's Circuit oracles on the processed
    netlist `text` (each parsed by its own package), on seeded inputs."""
    rng = np.random.default_rng(seed)
    nl, rnl = parse_verilog(text, arith), ref_parse(text, arith)
    c, rc = Circuit.from_netlist(nl), RefCircuit.from_netlist(rnl)
    got, exp = [], []
    for _ in range(16):
        if arith:
            vals = {w: int(rng.integers(0, 256)) for w in sorted(nl.inputs)}
            got.append(c.evaluate_arith(c.initialize_wire_map(nl.wire_set, vals, default=0), 8))
            exp.append(rc.evaluate_arith(rc.initialize_wire_map(rnl.wire_set, vals, default=0), 8))
        else:
            vals = {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}
            got.append({w: bool(v) for w, v in c.evaluate(c.initialize_wire_map(nl.wire_set, vals)).items()})
            exp.append({w: bool(v) for w, v in rc.evaluate(rc.initialize_wire_map(rnl.wire_set, vals)).items()})
    return got, exp, nl.outputs


@pytest.mark.parametrize("seed", range(6))
def test_random_mux_trees_text_and_oracle(seed):
    src = _random_mux_tree(seed)
    text = port.convert_gates(src)
    assert text == ref.convert_gates(src)
    got, exp, outs = _oracles(text, seed)
    assert [{w: g[w] for w in outs} for g in got] == [{w: e[w] for w in outs} for e in exp]


@pytest.mark.parametrize("name", ["full_adder", "mux8", "aoi4", "sdffe"])
def test_processed_gates_oracle_equals_the_reference(name):
    got, exp, outs = _oracles(port.convert_gates(GATE_TEXTS[name]), 3)
    assert [{w: g[w] for w in outs} for g in got] == [{w: e[w] for w in outs} for e in exp]


def test_processed_arith_oracle_equals_the_reference():
    got, exp, outs = _oracles(port.convert_arith(BEHAVIORAL), 4, arith=True)
    assert [{w: g[w] for w in outs} for g in got] == [{w: e[w] for w in outs} for e in exp]


@pytest.mark.parametrize("cell", [
    "$_DFF_PP0_", "$_DFF_NN1_", "$_DFFE_PP0P_", "$_DFFSR_PPP_", "$_DFFSRE_PPPP_",
    "$_ALDFF_PP_", "$_DLATCH_P_", "$_SR_PP_", "$_FF_", "FOO_CELL",
])
def test_rejected_cells_raise_the_reference_error(cell):
    src = ASYNC.replace("$_DFF_PP0_", cell)
    with pytest.raises(ValueError) as want:
        ref.convert_gates(src)
    with pytest.raises(ValueError) as got:
        port.convert_gates(src)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arith", [False, True], ids=["gates", "arith"])
def test_the_two_clis_write_identical_files(tmp_path, arith):
    src = tmp_path / "in.v"
    src.write_text(BEHAVIORAL if arith else YOSYS_FA)
    outs = []
    for pkg in ("helm_tpu_torch", "helm_tpu"):
        out = tmp_path / f"{pkg}.v"
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.preprocessor", "--input", str(src), "--output", str(out),
             *(["--arithmetic"] if arith else [])],
            capture_output=True, text=True, timeout=60, cwd=ROOT,
        )
        assert res.returncode == 0, res.stderr
        assert f"[✓] wrote {out}" in res.stdout
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
