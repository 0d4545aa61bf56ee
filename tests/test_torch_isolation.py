"""helm_tpu_torch stands alone: it imports nothing of JAX or of helm_tpu.

Two checks. An AST scan of every module of the port and of chip_smoke.py
finds no import of `jax` or `helm_tpu` (the port's own copies of the
reference's numpy modules take their place). A fresh interpreter runs the
CLI in gates, LUT and arith modes on the CPU and finds neither `jax*` nor
`helm_tpu` / `helm_tpu.*` in `sys.modules` afterwards (tests/conftest.py
imports jax into this process, so only a subprocess can show that).
The copies themselves are held against the originals: tables, plans,
parsers and CSV I/O give the same values from both.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from helm_tpu import refbound as ref_refbound
from helm_tpu.circuit import plan as ref_plan
from helm_tpu.circuit import verilog as ref_verilog
from helm_tpu.circuit.graph import Circuit as RefCircuit
from helm_tpu.fhe import csprng as ref_csprng
from helm_tpu.fhe import modring as ref_modring
from helm_tpu.fhe import security as ref_security
from helm_tpu.io import csv_io as ref_csv_io
from helm_tpu_torch import params as P
from helm_tpu_torch import refbound
from helm_tpu_torch.circuit import plan, verilog
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.fhe import csprng, modring, pbs, security
from helm_tpu_torch.io import csv_io
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "helm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "helm_tpu")


def _imports(path: Path) -> list[str]:
    """Every module name an import statement in `path` names (absolute
    imports only: a relative import stays inside the package)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("netlist,inputs,golden", [
    ("2-bit-adder.v", "2-bit-adder.inputs.csv", "2-bit-adder.outputs.csv"),
    ("8-bit-adder-lut-3-1.v", "8-bit-adder.inputs.csv", "8-bit-adder-lut-3-1.outputs.csv"),
])
def test_cli_in_a_fresh_interpreter_imports_neither(tmp_path, netlist, inputs, golden):
    out = tmp_path / "out.csv"
    argv = [
        "-v", f"benchmarks/netlists/{netlist}", "-i", f"benchmarks/test-cases/{inputs}",
        "-o", str(out), "--test-params", "--device", "cpu", "--seed", "7",
    ]
    code = textwrap.dedent(
        f"""
        import sys
        from helm_tpu_torch import cli
        assert cli.main({argv!r}) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("ISOLATED_OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "ISOLATED_OK" in res.stdout
    got = {w: int(v) for w, v in csv_io.read_input_wires(str(out), "bool").items()}
    exp = {w: int(v) for w, v in csv_io.read_input_wires(
        str(ROOT / "benchmarks/test-cases" / golden), "bool").items()}
    assert got == exp


def test_arith_cli_in_a_fresh_interpreter_imports_neither(tmp_path):
    """Arith mode through the CLI (chi-squared u8, inline -w inputs) in a
    fresh interpreter: the outputs are the plaintext oracle's and neither
    JAX nor helm_tpu was imported."""
    out = tmp_path / "out.csv"
    netlist = "benchmarks/netlists/chi_squared_arith.v"
    inputs = {"n0": 2, "n1": 7, "n2": 9}
    argv = ["-v", netlist, "-a", "u8", "--test-params", "--device", "cpu", "--seed", "7", "-o", str(out)]
    for w, v in inputs.items():
        argv += ["-w", w, str(v)]
    code = textwrap.dedent(
        f"""
        import sys
        from helm_tpu_torch import cli
        assert cli.main({argv!r}) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("ISOLATED_OK")
        """
    )
    # one intra-op thread: ~12 s alone, and no slower when other test
    # processes hold the cores
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "ISOLATED_OK" in res.stdout
    nl = verilog.read_verilog_file(str(ROOT / netlist), True)
    c = Circuit.from_netlist(nl)
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), 8)
    assert csv_io.read_input_wires(str(out), "u8") == {w: exp[w] for w in nl.outputs}


def test_mesh_cli_in_a_fresh_interpreter_imports_neither(tmp_path):
    """The CLI on a mesh of two virtual CPU shards (`--mesh 2`, the
    parallel package) in a fresh interpreter: the golden CSV, and neither
    JAX nor helm_tpu was imported."""
    out = tmp_path / "out.csv"
    argv = ["-v", "benchmarks/netlists/2-bit-adder.v", "-i", "benchmarks/test-cases/2-bit-adder.inputs.csv",
            "-o", str(out), "--test-params", "--device", "cpu", "--seed", "7", "--mesh", "2"]
    code = textwrap.dedent(
        f"""
        import sys
        from helm_tpu_torch import cli
        assert cli.main({argv!r}) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("ISOLATED_OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "ISOLATED_OK" in res.stdout and "Gate batches sharded on GateMesh('gates': 2 shards" in res.stdout
    assert csv_io.read_input_wires(str(out), "bool") == csv_io.read_input_wires(
        str(ROOT / "benchmarks/test-cases/2-bit-adder.outputs.csv"), "bool")


def test_serve_and_sweep_in_a_fresh_interpreter_import_neither(tmp_path):
    """The daemon (one-shot, --device cpu) on the golden 2-bit-adder
    vector, with K4's and K3's wrappers and the multi-bit sweep imported
    too, in a fresh interpreter: the golden outputs, and neither JAX nor
    helm_tpu in sys.modules."""
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    (watch / "v.csv").write_text((ROOT / "benchmarks/test-cases/2-bit-adder.inputs.csv").read_text())
    argv = ["-v", "benchmarks/netlists/2-bit-adder.v", "--watch", str(watch), "--outdir", str(outd),
            "--test-params", "--device", "cpu", "--seed", "7", "--batch", "2", "--max-batches", "1"]
    code = textwrap.dedent(
        f"""
        import sys
        from helm_tpu_torch import serve
        from helm_tpu_torch.ops import gm_pbs, ts_pbs
        from helm_tpu_torch.tools import mb_sweep
        assert serve.main({argv!r}) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("ISOLATED_OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "ISOLATED_OK" in res.stdout
    got = csv_io.read_input_wires(str(outd / "v.out.csv"), "bool")
    exp = csv_io.read_input_wires(str(ROOT / "benchmarks/test-cases/2-bit-adder.outputs.csv"), "bool")
    assert got == exp
    assert (watch / "done" / "v.csv").exists()


@pytest.mark.parametrize("module,argv,last", [
    ("helm_tpu_torch.examples.library_api", ["--device", "cpu"], "all examples OK"),
    ("helm_tpu_torch.tools.verify_baseline", ["--fast", "--only", "2-bit"], "ALL BIT-EXACT"),
], ids=["library_api", "verify_baseline"])
def test_module_entry_points_in_a_fresh_interpreter_import_neither(module, argv, last):
    """`python -m <module> <argv>` (run as runpy runs -m) in a fresh
    interpreter: exit code 0, its last line, and neither JAX nor helm_tpu
    in sys.modules."""
    code = textwrap.dedent(
        f"""
        import runpy, sys
        sys.argv = [{module!r}, *{argv!r}]
        try:
            runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert e.code in (0, None), e.code
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("ISOLATED_OK")
        """
    )
    # one intra-op thread (the example ~30 s alone): no slower when other
    # test processes hold the cores, where 8 threads each stall for minutes
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "ISOLATED_OK" and lines[-2] == last, lines[-3:]


@pytest.mark.parametrize("N", [64, 128, 512, 1024, 2048])
def test_ntt_tables_equal_the_reference(N):
    mine, ref = modring.get_tables(N), ref_modring.get_tables(N)
    for f in ("primes", "psi_rev", "psi_rev_sh", "psi_inv_rev", "psi_inv_rev_sh", "n_inv", "n_inv_sh"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f), err_msg=f)
    assert vars(mine.garner) == vars(ref.garner)


def test_csprng_stream_equals_the_reference():
    a, b = csprng.ChaChaGenerator(99), ref_csprng.ChaChaGenerator(99)
    np.testing.assert_array_equal(a.random_u32(1000), b.random_u32(1000))
    np.testing.assert_array_equal(a.integers(0, 12345, size=77), b.integers(0, 12345, size=77))
    np.testing.assert_array_equal(a.normal(0.0, 3.0, size=9), b.normal(0.0, 3.0, size=9))


@pytest.mark.parametrize("name", ["gates_tpu_v32", "lut3_v32", "gates_128_k3", "lut_128_k2"])
def test_security_estimate_equals_the_reference(name):
    from helm_tpu import params as RP

    assert security.security_bits(P.ALL_PARAMS[name]) == ref_security.security_bits(RP.ALL_PARAMS[name])


@pytest.mark.parametrize("netlist,mode", [
    ("s27.v", "gates"),
    ("c880-like.v", "gates"),
    ("8-bit-adder-lut-3-1.v", "lut"),
])
def test_parser_and_level_plan_equal_the_reference(netlist, mode):
    """The port's verilog parser, scheduler and level planner give the
    reference's plan array for array (LUT test polynomials included)."""
    from helm_tpu import params as RP
    from helm_tpu.fhe import pbs_jnp

    src = ROOT / "benchmarks/netlists" / netlist
    plans = []
    for vl, pl, circ, params, tp in (
        (verilog, plan, Circuit, P, pbs.lut_test_poly),
        (ref_verilog, ref_plan, RefCircuit, RP, pbs_jnp.lut_test_poly),
    ):
        nl = vl.read_verilog_file(str(src))
        p = params.TEST_PARAMS if mode == "gates" else params.TEST_PARAMS_LUT
        gates = pl.binarize(nl.gates)
        if mode == "lut":
            gates = pl.decompose_wide_luts(gates)
        c = circ(gates, nl.inputs, nl.outputs, nl.dff_outputs)
        c.sort_circuit()
        c.compute_levels()
        wires = set(nl.wire_set) | {g.output for g in gates}
        plans.append(pl.build_plan(c, wires, p, mode, lut_test_poly_fn=lambda t, p=p, tp=tp: tp(p, t)))
    mine, ref = plans
    assert mine.wire_index == ref.wire_index and len(mine.levels) == len(ref.levels)
    for a, b in zip(mine.levels, ref.levels):
        for f in ("slot_in", "slot_coef", "slot_off", "slot_dst", "testv_sel", "mux_pairs",
                  "mux_dst", "lin_src", "lin_coef", "lin_off", "lin_dst"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
    if ref.testv_bank is not None:
        np.testing.assert_array_equal(mine.testv_bank, ref.testv_bank)


def test_csv_io_equals_the_reference():
    for name, kind in (("8-bit-adder.inputs.csv", "bool"), ("c880-like.inputs.csv", "bool"),
                       ("chi_squared_arith_1.inputs.csv", "u32")):
        path = str(ROOT / "benchmarks/test-cases" / name)
        assert csv_io.read_input_wires(path, kind) == ref_csv_io.read_input_wires(path, kind)


@pytest.mark.parametrize("name", ["2-bit-adder", "c880-like", "aes128-gates", "s27", "8-bit-adder-lut-3-1"])
def test_refbound_equals_the_reference(name):
    """The bench's reference bounds (the port's trimmed copy of
    helm_tpu/refbound.py) on tests/test_refbound.py's netlists: the same
    level profile and bounds, at the default and at other cores and
    cycles."""
    path = str(ROOT / "benchmarks/netlists" / f"{name}.v")
    mine = refbound.level_bootstrap_profile(Circuit.from_netlist(verilog.read_verilog_file(path)))
    ref = ref_refbound.level_bootstrap_profile(RefCircuit.from_netlist(ref_verilog.read_verilog_file(path)))
    assert mine == ref
    for kw in ({}, {"cores": 7, "cycles": 3}):
        assert refbound.bounds_for_netlist(path, **kw) == ref_refbound.bounds_for_netlist(path, **kw)
    assert refbound.reference_bounds(mine, 16, 0.02, 2) == ref_refbound.reference_bounds(ref, 16, 0.02, 2)


@pytest.mark.parametrize("module,argv,env,last", [
    ("helm_tpu_torch.tools.expand8_probe", ["--device", "cpu"], {}, "expand8 [6144,8] -> [6144,128] on cpu"),
    ("helm_tpu_torch.tools.splat_repro", ["--device", "cpu"], {"STEPS": "2"}, "splat vs scalar: "),
    ("helm_tpu_torch.tools.liveset_harness", ["--device", "cpu"], {"STEPS": "2", "RS": "1", "AS": "1"},
     "R= 1 A= 1 splat"),
    ("helm_tpu_torch.tools.ptw_probe", ["--device", "cpu", "A", "C"], {"STEPS": "1"}, "{'A': "),
    ("helm_tpu_torch.tools.family_bench", ["--device", "cpu"],
     {"PSET": "TEST_PARAMS", "NETLIST": "benchmarks/netlists/2-bit-adder.v"}, 'RESULT {"family": "2-bit-adder"'),
    ("helm_tpu_torch.tools.chi2_bench", ["--device", "cpu"], {"PARAMS": "TEST_PARAMS_ARITH_MB", "WIDTH": "u8"},
     'RESULT {"family": "chi_squared_arith"'),
    ("helm_tpu_torch.tools.noise_validate", ["--device", "cpu"],
     {"PSET": "TEST_NOISY_GATES_MB", "SAMPLES": "32", "G": "32"}, 'RESULT {"params": "test_noisy_gates_mb"'),
    ("helm_tpu_torch.fhe.security", [], {}, "arith_128_mb2      glwe"),
    ("helm_tpu_torch.tools.g1_fs_test", ["--device", "cpu"], {}, "decrypt-verified ok"),
    ("helm_tpu_torch.tools.collect_results", ["benchmarks/netlists/2-bit-adder.v"], {}, "}"),
], ids=["expand8_probe", "splat_repro", "liveset_harness", "ptw_probe", "family_bench", "chi2_bench",
        "noise_validate", "security", "g1_fs_test", "collect_results"])
def test_tools_in_a_fresh_interpreter_import_neither(tmp_path, module, argv, env, last):
    """The ported tools (`python -m <module> <argv>` with their env knobs,
    as runpy runs -m) in a fresh interpreter on the CPU: exit code 0, the
    start of their last line, and neither JAX nor helm_tpu in
    sys.modules. The noise tool's key cache goes to a temporary directory."""
    code = textwrap.dedent(
        f"""
        import runpy, sys
        sys.argv = [{module!r}, *{argv!r}]
        try:
            runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert e.code in (0, None), e.code
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("ISOLATED_OK")
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, **env, "OMP_NUM_THREADS": "1", "BENCH_KEY_CACHE": str(tmp_path)},
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "ISOLATED_OK" and lines[-2].startswith(last), lines[-3:]
