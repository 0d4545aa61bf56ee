"""helm_tpu_torch.cli on the CPU: golden CSVs, error paths, and no JAX.

The subprocess matters: tests/conftest.py imports jax into this process,
so only a fresh interpreter can show that the port's main path (keygen,
engine, bootstrap, CLI) never imports it.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import read_verilog_file
from helm_tpu.io import csv_io
from helm_tpu_torch import cli
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

GOLDEN_IN = "benchmarks/test-cases/2-bit-adder.inputs.csv"
ADDER = ["-v", "benchmarks/netlists/2-bit-adder.v", "-i", GOLDEN_IN]
GOLDEN = "benchmarks/test-cases/2-bit-adder.outputs.csv"


def _read(path):
    return csv_io.read_input_wires(str(path), "bool")


def test_cli_matches_golden_without_jax(tmp_path):
    out = tmp_path / "out.csv"
    code = textwrap.dedent(
        f"""
        import sys
        from helm_tpu_torch import cli
        rc = cli.main({ADDER + ["-o", str(out), "--params", "test_tiny_k3",
                                "--device", "cpu", "--seed", "7"]!r})
        assert rc == 0, rc
        leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
        assert not leaked, leaked
        print("NO_JAX_OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout
    assert _read(out) == _read(GOLDEN)


def test_cli_sequential_and_keys_dir(tmp_path):
    """s27 over 3 cycles with persisted keys (second run loads them)."""
    args = [
        "-v", "benchmarks/netlists/s27.v",
        "-i", "benchmarks/test-cases/s27.inputs.csv",
        "-c", "3", "--params", "test_tiny_mb2", "--device", "cpu",
        "--keys", str(tmp_path / "keys"),
    ]
    for i in range(2):
        out = tmp_path / f"out{i}.csv"
        assert cli.main(args + ["-o", str(out)]) == 0
        assert _read(out) == _read("benchmarks/test-cases/s27_3cycles.outputs.csv")


@pytest.mark.parametrize("flag", ["-g", "--gpu", "--tpu"])
def test_cli_accepts_the_reference_device_flags(flag):
    """-g, --gpu and --tpu parse as no-ops, as in helm_tpu/cli.py, and leave
    the device at its default, the card."""
    args = cli.build_argparser().parse_args(["-v", "x.v", flag])
    assert args.tpu and args.device == "cuda"


@pytest.mark.parametrize("extra", [[], ["-c", "2", "--fuse-cycles"]], ids=["one_cycle", "fuse_cycles"])
def test_cli_profile_writes_a_chrome_trace(tmp_path, capsys, extra):
    """--profile DIR on the CPU: the evaluation runs under torch.profiler
    (host activity only), the reference's line is printed, and DIR holds a
    Chrome trace that parses as JSON and records the level loop's ops.
    The s27 case covers the --fuse-cycles branch."""
    prof = tmp_path / "prof"
    out = tmp_path / "out.csv"
    if extra:
        argv = ["-v", "benchmarks/netlists/s27.v", "-i", "benchmarks/test-cases/s27.inputs.csv", *extra]
    else:
        argv = list(ADDER)
    assert cli.main(argv + ["-o", str(out), "--test-params", "--device", "cpu", "--seed", "5",
                            "--profile", str(prof)]) == 0
    assert f"[✓] profiler trace written to {prof}" in capsys.readouterr().out
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)  # no CUDA activity on the CPU
    if not extra:
        assert _read(out) == _read(GOLDEN)


def test_cli_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(ADDER + ["--device", "cuda"])


# The ids are kept from before -I was ported, when the first case checked
# that -I exited with a ROADMAP pointer. Now extra0 is a positive -I run
# (two vectors, one batched pass) and extra1 arith mode's refusal of -c > 1.
@pytest.mark.parametrize("extra,what", [
    (["-I"], None),
    (["-a", "u32", "-c", "2"], "Arithmetic does not currently support sequential"),
], ids=["extra0-not ported yet .ROADMAP.md", "extra1-Arithmetic does not currently support sequential"])
def test_cli_unported_modes_point_to_roadmap(tmp_path, capsys, extra, what):
    """-I evaluates two 2-bit-adder vectors in one batched pass: each
    vector's outputs print under [vector i: file] and land in <-o>.<i>,
    equal to the plaintext oracle. Arith mode refuses -c > 1, as the
    reference does."""
    if what is not None:
        with pytest.raises(SystemExit, match=what):
            cli.main(ADDER + extra + ["--device", "cpu"])
        return
    second = tmp_path / "v1.csv"
    second.write_text("wire,value\na[0],1\na[1],1\nb[0],0\nb[1],1\ncin,1\n")
    files = [GOLDEN_IN, str(second)]
    out = tmp_path / "out.csv"
    argv = ["-v", "benchmarks/netlists/2-bit-adder.v", "-I", *files, "-o", str(out),
            "--test-params", "--device", "cpu", "--seed", "3"]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    c = Circuit.from_netlist(nl)
    for i, f in enumerate(files):
        assert f" [vector {i}: {f}]" in printed
        ins = _read(f)
        exp = c.evaluate(c.initialize_wire_map(nl.wire_set, ins))
        assert _read(f"{out}.{i}") == {w: bool(exp[w]) for w in nl.outputs}
    assert _read(f"{out}.0") == _read(GOLDEN)
