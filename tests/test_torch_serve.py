"""helm_tpu_torch.serve, the serving daemon, on the CPU: the reference
daemon's intake, batching, quarantine and restart behaviour, with every
output held against its golden CSV or the plaintext oracle.

Runs `main([... "--device", "cpu", ...])` in process with CSVs dropped in
the watch directory beforehand, as tests/test_serve.py drives
`helm_tpu.serve`.
"""

import time

import numpy as np
import pytest
import torch

from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import read_verilog_file
from helm_tpu.io import csv_io
from helm_tpu_torch import params as P
from helm_tpu_torch.ops import mb_pbs, ts_pbs
from helm_tpu_torch.serve import _stable_inputs, main
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ADDER = "benchmarks/netlists/2-bit-adder.v"
WIRES = ("a[0]", "a[1]", "b[0]", "b[1]", "cin")


def _write(path, vec):
    path.write_text("wire,value\n" + "".join(f"{w},{int(v)}\n" for w, v in vec.items()))


def _oracle(vec):
    nl = read_verilog_file(ADDER)
    c = Circuit.from_netlist(nl)
    st = c.evaluate(c.initialize_wire_map(nl.wire_set, vec))
    return {w: bool(st[w]) for w in nl.outputs}


def _read(path, kind="bool"):
    return csv_io.read_input_wires(str(path), kind)


def _serve(watch, outd, *extra):
    return main(["-v", ADDER, "--watch", str(watch), "--outdir", str(outd), "--device", "cpu", *extra])


@pytest.mark.parametrize("sel,mb_kernel", [(["--test-params"], None), (["--params", "test_tiny_mb2"], "ts")])
def test_serve_oneshot_gates(tmp_path, monkeypatch, sel, mb_kernel):
    """The golden 2-bit-adder vector and two from a numpy seed in one
    batch of 4 (padded): outputs equal the golden CSV and the oracle, and
    every input moves to done/. The multi-bit case runs under
    HELM_TPU_MB_KERNEL=ts, K4's plain version on the CPU."""
    if mb_kernel:
        monkeypatch.setenv("HELM_TPU_MB_KERNEL", mb_kernel)
        assert mb_pbs.blind_rotation(P.TEST_PARAMS_MB) is ts_pbs.blind_rotate_ts
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    golden_in = _read("benchmarks/test-cases/2-bit-adder.inputs.csv")
    rng = np.random.default_rng(5)
    vecs = {"golden": golden_in, **{f"v{i}": {w: bool(rng.integers(0, 2)) for w in WIRES} for i in range(2)}}
    for name, vec in vecs.items():
        _write(watch / f"{name}.csv", vec)
    assert _serve(watch, outd, *sel, "--seed", "3", "--batch", "4", "--max-batches", "1") == 0
    assert _read(outd / "golden.out.csv") == _read("benchmarks/test-cases/2-bit-adder.outputs.csv")
    for name, vec in vecs.items():
        assert _read(outd / f"{name}.out.csv") == _oracle(vec), name
        assert not (watch / f"{name}.csv").exists()
        assert (watch / "done" / f"{name}.csv").exists()


def test_serve_oneshot_arith(tmp_path):
    """chi-squared u8 through the daemon's arith engine: the oracle's
    outputs for two vectors in one batch."""
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    vecs = {"q": {"n0": 3, "n1": 5, "n2": 7}, "r": {"n0": 2, "n1": 7, "n2": 9}}
    for name, vec in vecs.items():
        (watch / f"{name}.csv").write_text("wire,value\n" + "".join(f"{w},{v}\n" for w, v in vec.items()))
    rc = main(["-v", "benchmarks/netlists/chi_squared_arith.v", "-a", "u8", "--watch", str(watch),
               "--outdir", str(outd), "--test-params", "--device", "cpu", "--seed", "4",
               "--batch", "2", "--max-batches", "1"])
    assert rc == 0
    nl = read_verilog_file("benchmarks/netlists/chi_squared_arith.v", True)
    c = Circuit.from_netlist(nl)
    for name, vec in vecs.items():
        exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, vec, default=0), 8)
        assert _read(outd / f"{name}.out.csv", "u8") == {w: exp[w] for w in nl.outputs}
        assert (watch / "done" / f"{name}.csv").exists()


def test_serve_quarantines_malformed_csv(tmp_path):
    """A garbage or truncated CSV moves to failed/ with an error note and
    never sinks the batch it arrived with."""
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    (watch / "bad1.csv").write_bytes(b"\x00\xff\xfenot a csv")
    (watch / "bad2.csv").write_text("wire,value\na[0],1\n")  # missing wires
    good = {"a[0]": 1, "a[1]": 0, "b[0]": 1, "b[1]": 1, "cin": 0}
    _write(watch / "good.csv", good)
    assert _serve(watch, outd, "--test-params", "--batch", "3", "--max-batches", "1", "--linger", "0.1") == 0
    assert _read(outd / "good.out.csv") == _oracle(good)
    assert (watch / "done" / "good.csv").exists()
    for bad in ("bad1.csv", "bad2.csv"):
        assert (watch / "failed" / bad).exists(), bad
        assert (watch / "failed" / f"{bad}.error.txt").read_text().strip()
        assert not (outd / f"{bad[:-4]}.out.csv").exists()
    assert "missing input wires" in (watch / "failed" / "bad2.csv.error.txt").read_text()


def test_serve_partial_batch_linger_flush(tmp_path, capsys):
    """Fewer inputs than --batch still evaluate after the linger window
    (padded to the fixed shape internally)."""
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    only = {"a[0]": 1, "a[1]": 1, "b[0]": 0, "b[1]": 1, "cin": 1}
    _write(watch / "only.csv", only)
    t0 = time.time()
    assert _serve(watch, outd, "--test-params", "--batch", "4", "--max-batches", "1",
                  "--linger", "0.2", "--poll", "0.05") == 0
    assert time.time() - t0 >= 0.2
    assert _read(outd / "only.out.csv") == _oracle(only)
    assert (watch / "done" / "only.csv").exists()
    assert "batch 0: 1 vectors" in capsys.readouterr().out


def test_stable_inputs_holds_growing_file(tmp_path):
    """A file that grows between scans is held until its (size, mtime) has
    been unchanged for stable_s; zero-byte files are held longer; a removed
    file leaves the cache."""
    cache: dict = {}
    f = tmp_path / "vec.csv"
    f.write_text("wire,value\na[0],1\n")
    assert _stable_inputs(str(tmp_path), cache, stable_s=0.2) == []
    assert _stable_inputs(str(tmp_path), cache, stable_s=0.2) == []
    time.sleep(0.25)
    with open(f, "a") as fh:
        fh.write("a[1],0\n")
    assert _stable_inputs(str(tmp_path), cache, stable_s=0.2) == []
    assert _stable_inputs(str(tmp_path), cache, stable_s=0.2) == []
    time.sleep(0.25)
    assert _stable_inputs(str(tmp_path), cache, stable_s=0.2) == ["vec.csv"]
    (tmp_path / "zero.csv").write_text("")
    assert "zero.csv" not in _stable_inputs(str(tmp_path), cache, stable_s=0.2)
    time.sleep(0.25)
    assert "zero.csv" not in _stable_inputs(str(tmp_path), cache, stable_s=0.2)
    f.unlink()
    _stable_inputs(str(tmp_path), cache, stable_s=0.2)
    assert "vec.csv" not in cache


def test_serve_supervisor_restarts_after_crash(tmp_path):
    """--supervise: the worker (a child `python -m helm_tpu_torch.serve`)
    hard-exits after its first batch through the --crash-after hook; the
    restarted worker, with the hook stripped, finishes the other input."""
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    vecs = [dict(zip(WIRES, bits)) for bits in [(1, 0, 1, 0, 0), (0, 1, 1, 1, 1)]]
    for i, vec in enumerate(vecs):
        _write(watch / f"v{i}.csv", vec)
    rc = _serve(watch, outd, "--test-params", "--batch", "1", "--max-batches", "1",
                "--linger", "0.1", "--poll", "0.05",
                "--supervise", "--crash-after", "1", "--max-restarts", "2")
    assert rc == 0
    for i, vec in enumerate(vecs):
        assert _read(outd / f"v{i}.out.csv") == _oracle(vec)
        assert (watch / "done" / f"v{i}.csv").exists()
    assert not list(watch.glob("*.csv"))


# The ids are kept from before --batch auto and --fuse-levels were ported,
# when both cases checked that they exited with a ROADMAP pointer. Now
# both are positive runs: extra0 --batch auto --max-batch 4 (on the CPU
# every batch costs the same a vector, so the model picks the largest, 4),
# extra1 --fuse-levels (fused level evaluation: on the CPU the level loop,
# on the card one CUDA graph replay a batch).
@pytest.mark.parametrize("extra,printed", [
    (["--batch", "auto", "--max-batch", "4"], "--batch auto -> 4 (100% fill;"),
    (["--batch", "2", "--fuse-levels"], "levels fused: True"),
], ids=["extra0---batch auto is not ported.*ROADMAP.md", "extra1---fuse-levels is not ported.*ROADMAP.md"])
def test_serve_unported_options_point_to_roadmap(tmp_path, capsys, extra, printed):
    """--batch auto --max-batch 4 serves the 2-bit adder in one batch of
    4 (two vectors, padded); --fuse-levels serves it with a fused engine.
    Both reach the plaintext oracle."""
    watch, outd = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    vecs = [dict(zip(WIRES, bits)) for bits in ((1, 0, 1, 1, 0), (0, 1, 1, 0, 1))]
    for i, vec in enumerate(vecs):
        _write(watch / f"v{i}.csv", vec)
    assert _serve(watch, outd, "--test-params", "--max-batches", "1", "--linger", "0.1", *extra) == 0
    out = capsys.readouterr().out
    assert printed in out
    if "auto" in extra:
        assert "(batch=4," in out
    for i, vec in enumerate(vecs):
        assert _read(outd / f"v{i}.out.csv") == _oracle(vec)
        assert (watch / "done" / f"v{i}.csv").exists()


def test_serve_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["-v", ADDER, "--watch", str(tmp_path / "in"), "--outdir", str(tmp_path / "out")])
