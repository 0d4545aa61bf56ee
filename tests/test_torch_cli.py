"""helm_tpu_torch.cli on the CPU: golden CSVs, error paths, and no JAX.

The subprocess matters: tests/conftest.py imports jax into this process,
so only a fresh interpreter can show that the port's main path (keygen,
engine, bootstrap, CLI) never imports it.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from helm_tpu.io import csv_io
from helm_tpu_torch import cli

ADDER = [
    "-v", "benchmarks/netlists/2-bit-adder.v",
    "-i", "benchmarks/test-cases/2-bit-adder.inputs.csv",
]
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


def test_cli_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(ADDER + ["--device", "cuda"])


@pytest.mark.parametrize("extra,what", [
    (["-I", "benchmarks/test-cases/2-bit-adder.inputs.csv"], "not ported yet .ROADMAP.md"),
    (["-a", "u32", "-c", "2"], "Arithmetic does not currently support sequential"),
])
def test_cli_unported_modes_point_to_roadmap(extra, what):
    with pytest.raises(SystemExit, match=what):
        cli.main(ADDER + extra + ["--device", "cpu"])
