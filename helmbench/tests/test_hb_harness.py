"""The harness: BENCHMARK.json against its required shape, everything
found by name, a configuration added as a file alone, the isolation check,
and the command without a card."""

import json
import re
import subprocess
import sys

import pytest

import numpy as np

from helmbench import generator, harness, run
from helmbench.tests.hbutil import TEST_CONFIGS, run_cpu, spec_with

ROOT = harness.ROOT
SPEC = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_names_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["helmbench"] and SPEC["command"] == ["python3", "helmbench/run.py"]
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("helmbench/")
        assert harness.load_config(c["name"])["name"] == c["name"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (ROOT / "helmbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (ROOT / "helmbench" / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        assert callable(harness.reader(m["name"]).read)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(SPEC, cell, "per_layer")
    for m in harness.cell_metrics(SPEC, cell, "per_layer"):
        assert m["moves"] in e2e


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configs_hold_the_program_sets(config):
    cfg = harness.load_config(config)
    p = harness.program_params(cfg)
    assert p.name == cfg["params"]["name"]


def test_a_config_added_as_a_file_alone(tmp_path):
    cfg = json.loads((TEST_CONFIGS / "c880_test.json").read_text())
    cfg["name"] = "brand_new"
    (tmp_path / "brand_new.json").write_text(json.dumps(cfg))
    out = run_cpu("brand_new", "one_vector", configs_dir=tmp_path)
    assert out["correct"] and set(out["metrics"]) >= {"setup_s", "latency_p50_s"}


def test_a_traffic_mix_added_as_a_file_alone(tmp_path):
    """An open-loop mix is a data file: no code of the harness changes."""
    mix = {"what": "test", "batch": 2, "arrival": {"kind": "poisson", "rate_per_s": 4.0, "linger_s": 0.05}}
    (tmp_path / "open_test.json").write_text(json.dumps(mix))
    spec = spec_with("c880_test", "open_test")
    out = harness.run_cell(spec, "test.cell", (1 << 31) + 3, 0.5, False, "cpu", 0.0,
                           configs_dir=TEST_CONFIGS, traffic_dir=tmp_path)
    assert out["correct"] and out["attempted"] >= 1 and out["batch"] == 2
    assert set(out["metrics"]) >= {"setup_s", "latency_p50_s"}


class FakeServer:
    """A server whose call takes `t` seconds and returns one output a slot."""

    def __init__(self, batch, t):
        self.batch, self.t, self.n = batch, t, 0

    def call(self, rows, tracing):
        import time

        assert len(rows) == self.batch
        time.sleep(self.t)
        self.n += 1
        return np.asarray(rows)[:, None]

    def counters(self):
        return {"launches": self.n}


def test_closed_loop_serves_whole_calls_until_the_window_closes():
    srv = FakeServer(3, 0.01)
    part = generator.run(srv, {"arrival": {"kind": "closed"}}, 10, 0.1, False, 4, np.random.default_rng(0))
    assert part.seconds >= 0.1 and part.vectors == part.slots == 3 * part.calls
    assert part.rows[:4] == [4, 5, 6, 7] and all(0 <= r < 10 for r in part.rows)
    assert (part.latencies > 0).all() and part.after["launches"] == part.calls


def test_open_loop_serves_every_arrival_and_pads_the_calls():
    mix = {"arrival": {"kind": "poisson", "rate_per_s": 200.0, "linger_s": 0.005}}
    srv = FakeServer(4, 0.01)
    part = generator.run(srv, mix, 1000, 0.3, False, 0, np.random.default_rng(1))
    gaps = generator._gaps(mix, 0.3)
    expected = int((np.cumsum(np.random.default_rng(1).permutation(gaps)) < 0.3).sum())
    assert part.vectors == expected and part.rows == list(range(expected))
    assert part.slots >= part.vectors and part.calls == srv.n
    assert (part.latencies >= 0).all() and part.seconds >= 0.3
    assert sum(len(o) for o in part.outputs) == part.vectors
    # every seed has the same set of gaps, in an order of its own
    a, b = (np.sort(np.random.default_rng(s).permutation(gaps)) for s in (1, 2))
    assert np.array_equal(a, b)


def test_traced_run_reads_every_layer_metric_it_can_on_the_cpu():
    out = run_cpu("c880_test", "backlog16", trace=True)
    assert out["correct"] and out["device"]["window_s"] > 0
    # counts the program makes on any device; the device's own are the card's
    assert out["metrics"]["bootstraps_per_vector.latency"]["value"] == 383
    assert out["metrics"]["step_mfu.rate"]["value"] > 0
    assert list(out)[-1] == "checks" and len(out["breakdown"]["idle_gaps"]) <= 10


def test_isolation_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "helm_tpu_torch_lookalike", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "helm_tpu.params", object())
    assert run.forbidden_modules() == ["helm_tpu"]
    with pytest.raises(SystemExit):
        run.check_isolation("in a test")


def test_the_command_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "helmbench" / "run.py"), "--workload", "c880_gates128.one_vector",
         "--seed", str((1 << 31) + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0 and "correct" not in proc.stdout


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys, runpy; sys.argv = ['x', '--workload', 'none', '--seed', '1', '--seconds', '1'];"
        "sys.path.insert(0, %r);" % str(ROOT)
        + "from helmbench import harness, reference, yardstick, trace, control;"
        "import helmbench.modes.gates, helmbench.modes.arith;"
        "import helm_tpu_torch.engines.boolean, helm_tpu_torch.engines.arith;"
        "from helmbench.run import forbidden_modules; print(forbidden_modules())"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stderr
