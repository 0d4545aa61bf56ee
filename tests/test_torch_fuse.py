"""Fused level evaluation in helm_tpu_torch, on the CPU, against helm_tpu's.

`BooleanEngine(fuse_levels=...)` decides at `compile()` by the reference's
rule, so the same circuits fuse in both packages: the port's `fused` must
equal the reference's `_scan_levels is not None` on every netlist (these
cases build only the plans; the keys are built once, at module scope).
On the CPU fusing changes nothing (the CUDA graph is card-only, held
against the eager loop by chip_smoke.py): the port's fused and eager
evaluation both equal the reference's fused `lax.scan` word for word on
every real wire (tolerance 0: exact arithmetic; the reference's trash
wire, written by its padded no-op slots, excluded), in gates and LUT mode,
and `evaluate_cycles` equals both `cycles` evaluate calls and the
reference's `evaluate_cycles`. The CLI's `--fuse-levels`,
`--no-fuse-levels` and `--fuse-cycles` parse and run; the daemon's
`--fuse-levels` run is tests/test_torch_serve.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from helm_tpu import params as RP
from helm_tpu.circuit.verilog import read_verilog_file as ref_read_verilog_file
from helm_tpu.engines.boolean import BooleanEngine as RefEngine
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import BooleanEngine, cli
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import read_verilog_file
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.ntt import to_host
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.io import csv_io
from helm_tpu_torch.params import from_reference
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

NETLISTS = "benchmarks/netlists"
SETS = {"gates": (RP.TEST_PARAMS, 22), "lut": (RP.TEST_PARAMS_LUT, 23)}


def _keys(mode):
    p, seed = SETS[mode]
    ck = ref_lwe.keygen(p, seed)
    return ck, ref_gen_server_key(ck)


KEYS = {mode: _keys(mode) for mode in SETS}


def _ref(mode, fuse_levels):
    p, _ = SETS[mode]
    return RefEngine(mode=mode, params=p, backend="jnp", keys=KEYS[mode], fuse_levels=fuse_levels)


def _port(mode, fuse_levels):
    p, _ = SETS[mode]
    ck, sk = KEYS[mode]
    return BooleanEngine(
        mode=mode, params=from_reference(p), device="cpu", fuse_levels=fuse_levels,
        keys=(client_key_from_reference(ck), server_key_from_reference(sk)),
    )


@pytest.fixture(scope="module")
def auto():
    """A reference and a port engine per mode, both with fuse_levels=None."""
    return {mode: (_ref(mode, None), _port(mode, None)) for mode in SETS}


@pytest.mark.parametrize("name", [
    "2-bit-adder", "s27", "c880-like", "8-bit-adder-lut-3-1", "8-bit-adder-lut-2-1",
    "8-bit-adder", "8-bit-mult", "crc32", "c1355-like",
])
def test_auto_decision_equals_the_reference(auto, name):
    """The reference's auto-rule (boolean.py:354-366) and the port's fuse
    the same circuits; c880-like and the 2-bit adder are
    test_fuse_levels_auto_heuristic's pair (fused, not fused)."""
    path = f"{NETLISTS}/{name}.v"
    nl = read_verilog_file(path)
    ref, port = auto["lut" if nl.has_luts else "gates"]
    ref.compile(ref_read_verilog_file(path))
    port.compile(nl)
    assert port.fused == (ref._scan_levels is not None)
    assert port.fuse_levels is None  # the request stays; `fused` is the decision
    if name in ("c880-like", "8-bit-adder-lut-3-1"):
        assert port.fused
    if name in ("2-bit-adder", "s27"):
        assert not port.fused


@pytest.mark.parametrize("fuse", [True, False])
def test_forced_decision_overrides_the_rule(fuse):
    port = _port("gates", fuse)
    port.compile(read_verilog_file(f"{NETLISTS}/2-bit-adder.v"))
    assert port.fused is fuse
    port.compile(read_verilog_file(f"{NETLISTS}/c880-like.v"))
    assert port.fused is fuse


@pytest.fixture(scope="module")
def fused_trio():
    """Per mode: the reference with fuse_levels=True, and the port fused
    and eager."""
    return {mode: (_ref(mode, True), _port(mode, True), _port(mode, False)) for mode in SETS}


def _golden(name):
    return csv_io.read_input_wires(f"benchmarks/test-cases/{name}", "bool")


def _oracle(nl, inputs, cycles=1):
    c = Circuit.from_netlist(nl)
    st = c.initialize_wire_map(nl.wire_set, inputs)
    for _ in range(cycles):
        st = c.evaluate(st)
    return {w: bool(st[w]) for w in nl.outputs}


@pytest.mark.parametrize("mode,name,inputs,golden,batch", [
    ("gates", "2-bit-adder", "2-bit-adder.inputs.csv", "2-bit-adder.outputs.csv", False),
    ("gates", "2-bit-adder", "2-bit-adder.inputs.csv", "2-bit-adder.outputs.csv", True),
    ("lut", "8-bit-adder-lut-3-1", "8-bit-adder.inputs.csv", "8-bit-adder-lut-3-1.outputs.csv", False),
], ids=["gates-2-bit-adder", "gates-2-bit-adder-batch", "lut-8-bit-adder-lut-3-1"])
def test_fused_and_eager_equal_the_reference_fused_words(fused_trio, mode, name, inputs, golden, batch):
    ref, fused, eager = fused_trio[mode]
    path = f"{NETLISTS}/{name}.v"
    nl = read_verilog_file(path)
    ref.compile(ref_read_verilog_file(path))
    fused.compile(nl)
    eager.compile(nl)
    assert ref._scan_levels is not None and fused.fused and not eager.fused
    vec = _golden(inputs)
    maps = [vec, {w: not v for w, v in vec.items()}] if batch else vec
    w0 = fused.encrypt_inputs(maps)
    exp = np.asarray(ref.evaluate(jnp.asarray(to_host(w0))))
    real = fused.plan.num_wires - 1  # the reference's padded slots write the trash wire
    for port in (fused, eager):
        got = port.evaluate(w0)
        np.testing.assert_array_equal(to_host(got)[..., :real, :], exp[..., :real, :])
    outs = fused.decrypt_outputs(got)
    for m, out in zip(maps if batch else [maps], outs if batch else [outs]):
        assert {w: bool(v) for w, v in out.items()} == _oracle(nl, m)
    if not batch:
        assert {w: bool(v) for w, v in outs.items()} == {w: bool(v) for w, v in _golden(golden).items()}


@pytest.mark.parametrize("fuse", [None, True, False])
def test_evaluate_cycles_equals_evaluate_calls_and_the_reference(fused_trio, fuse):
    """s27 x 3: evaluate_cycles == three evaluate calls == the reference's
    evaluate_cycles (one lax.scan over cycles), word for word."""
    ref = fused_trio["gates"][0]
    port = _port("gates", fuse)
    path = f"{NETLISTS}/s27.v"
    nl = read_verilog_file(path)
    ref.compile(ref_read_verilog_file(path))
    port.compile(nl)
    inputs = _golden("s27.inputs.csv")
    w0 = port.encrypt_inputs(inputs)
    got = port.evaluate_cycles(w0, 3)
    loop = w0
    for _ in range(3):
        loop = port.evaluate(loop)
    exp = np.asarray(ref.evaluate_cycles(jnp.asarray(to_host(w0)), 3))
    real = port.plan.num_wires - 1
    np.testing.assert_array_equal(to_host(got), to_host(loop))
    np.testing.assert_array_equal(to_host(got)[:real], exp[:real])
    assert port.decrypt_outputs(got) == _golden("s27_3cycles.outputs.csv") == _oracle(nl, inputs, 3)


@pytest.mark.parametrize("argv,fuse_levels,fuse_cycles", [
    ([], None, False),
    (["--fuse-levels"], True, False),
    (["--no-fuse-levels"], False, False),
    (["--fuse-cycles"], None, True),
    (["--no-fuse-levels", "--fuse-cycles"], False, True),
])
def test_cli_parses_the_fuse_flags(argv, fuse_levels, fuse_cycles):
    args = cli.build_argparser().parse_args(["-v", "x.v", *argv])
    assert args.fuse_levels is fuse_levels
    assert args.fuse_cycles is fuse_cycles


def test_cli_fuse_cycles_runs_s27_and_prints_the_amortized_cycle(tmp_path, capsys):
    out = tmp_path / "out.csv"
    argv = ["-v", f"{NETLISTS}/s27.v", "-i", "benchmarks/test-cases/s27.inputs.csv", "-c", "3",
            "--fuse-cycles", "--test-params", "--device", "cpu", "--seed", "5", "-o", str(out)]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "Cycles 0..2) Evaluation done in" in printed and "s/cycle amortized" in printed
    assert csv_io.read_input_wires(str(out), "bool") == _golden("s27_3cycles.outputs.csv")


@pytest.mark.parametrize("flag", ["--fuse-levels", "--no-fuse-levels"])
def test_cli_fuse_levels_runs_the_2_bit_adder(tmp_path, capsys, flag):
    out = tmp_path / "out.csv"
    argv = ["-v", f"{NETLISTS}/2-bit-adder.v", "-i", "benchmarks/test-cases/2-bit-adder.inputs.csv",
            flag, "-p", "--test-params", "--device", "cpu", "--seed", "5", "-o", str(out)]
    assert cli.main(argv) == 0
    assert "Evaluated gates in level [5/5]" in capsys.readouterr().out  # the CPU runs the loop
    assert csv_io.read_input_wires(str(out), "bool") == _golden("2-bit-adder.outputs.csv")
