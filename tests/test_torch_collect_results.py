"""The port of `tools/collect_results.py`, against the reference's script.

Logs are made from the port tools' own format strings (`mb_sweep`'s
sweep line, `aes_bench`'s steady-state line, `RESULT {json}` lines as the
tools print them, a malformed one among them): the port reads them into
the reference's three keys, with the reference's field names, and reads
every RESULT line as the reference does; the reference's regexes miss
the port's sweep and AES lines, which is why the port has its own.
"""

import json
import os
import subprocess
import sys

import pytest

from helm_tpu_torch.tools import aes_bench, collect_results, mb_sweep
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RESULTS = [{"family": "c880-like", "s_per_vector": 0.1246, "correct": True},
           {"tool": "k1_phases", "kernel": "mb", "set": "gates_128_k3_g1", "G": 1024, "clocks": {"garner": 3.5}}]


def _log(tmp_path, name, lines):
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _reference(logs):
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "collect_results.py"), *logs],
                         capture_output=True, text=True, check=True, cwd=REPO)
    return json.loads(out.stdout)


@pytest.fixture
def port_log(tmp_path):
    return _log(tmp_path, "tools.log", [
        "[tools] unrelated line",
        mb_sweep.sweep_line("fs", 32, 13413.5123, 2.04),
        mb_sweep.sweep_line("gm", 64, 12001.0, 0.5),
        *("RESULT " + json.dumps(r) for r in RESULTS),
        "RESULT {not json",
        aes_bench.steady_line(3.2544, 0, "gates_128_k3", "blind_rotate_mb", True),
        aes_bench.steady_line(6.08, 4, "gates_128_k3", "blind_rotate_mb", True),
        aes_bench.steady_line(40.0, 2, "test_params", "plain (cpu)", False),
    ])


def test_port_lines_parse_into_the_reference_keys(port_log):
    got = collect_results.collect([port_log, "/nonexistent/unreadable.log"])
    assert set(got) == {"sweeps", "results", "aes"}
    assert got["sweeps"] == [
        {"layout": "fs", "gt": 32, "ablate": "", "rot_s": 13413.5, "compile_s": 2.0, "log": port_log},
        {"layout": "gm", "gt": 64, "ablate": "", "rot_s": 12001.0, "compile_s": 0.5, "log": port_log},
    ]
    assert got["results"] == RESULTS  # the malformed line is skipped
    assert got["aes"] == [
        {"total_s": 3.25, "blocks": 1, "s_per_block": 3.25, "params": "gates_128_k3", "backend": "blind_rotate_mb"},
        {"total_s": 6.08, "blocks": 4, "s_per_block": 1.52, "params": "gates_128_k3", "backend": "blind_rotate_mb"},
        {"total_s": 40.0, "blocks": 2, "s_per_block": 20.0, "params": "test_params", "backend": "plain (cpu)"},
    ]


def test_results_as_the_reference_reads_them(port_log):
    ref = _reference([port_log, "/nonexistent/unreadable.log"])
    assert set(ref) == {"sweeps", "results", "aes"}
    assert collect_results.collect([port_log])["results"] == ref["results"] == RESULTS
    assert ref["sweeps"] == ref["aes"] == []  # the reference's regexes miss the port's lines


def test_field_names_are_the_reference_ones(tmp_path):
    """The reference's own line formats give the same field names as the
    port's lines do in the port."""
    ref_log = _log(tmp_path, "ref.log", [
        "fs gt=256 ablate='nob': 3431.0 rot/s (compile 12.5s)",
        "AES-128 steady-state: 6.08s for 4 blocks = 1.52s/block (gates_tpu_mb2, backend=mxu)",
    ])
    ref = _reference([ref_log])
    mine = collect_results.collect([_log(tmp_path, "port.log", [
        mb_sweep.sweep_line("fs", 256, 3431.0, 12.5),
        aes_bench.steady_line(6.08, 4, "gates_tpu_mb2", "blind_rotate_mb", True)])])
    assert set(ref["sweeps"][0]) == set(mine["sweeps"][0])
    assert set(ref["aes"][0]) == set(mine["aes"][0])
    assert {k: v for k, v in mine["aes"][0].items() if k != "backend"} == {
        k: v for k, v in ref["aes"][0].items() if k != "backend"}


def test_default_logs_are_chiprun_out(tmp_path, monkeypatch, capsys):
    """Without arguments: every *.log under chiprun_out/, nested too."""
    (tmp_path / "c1").mkdir()
    _log(tmp_path / "c1", "a.log", ["RESULT " + json.dumps(RESULTS[0])])
    _log(tmp_path, "b.txt", ["RESULT " + json.dumps(RESULTS[1])])
    monkeypatch.setattr(collect_results, "LOG_DIR", tmp_path)
    assert collect_results.main([]) == 0
    assert json.loads(capsys.readouterr().out) == {"sweeps": [], "results": [RESULTS[0]], "aes": []}
