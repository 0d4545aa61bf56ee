"""helm_tpu_torch.bench, the port's bench, on the CPU at a tiny size.

`python -m helm_tpu_torch.bench --device cpu` at TEST_PARAMS, a batch of 8,
one window of one batch and the 2-bit adder must print the root
bench.py's two JSON lines: the circuit's first, with bench.py's fields
and the reference bounds of `helm_tpu.refbound`, and the bootstrap rate
last; exit 0; and load its keys from BENCH_KEY_CACHE on a second run. A
wrong output fails the run: no line prints, no exception is swallowed.
The numbers are CPU times, named so (`device`); the card's are
chip_smoke.py's phase bench.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from helm_tpu.refbound import bounds_for_netlist
from helm_tpu_torch import bench
from helm_tpu_torch.engines.boolean import BooleanEngine
from helm_tpu_torch.ops import mb_pbs
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]
ADDER = "benchmarks/netlists/2-bit-adder.v"
#: bench.py's fields (bench.py:222-234, 368-376), less its TPU `capture` dict
CIRCUIT_FIELDS = {"metric", "value", "unit", "vs_baseline", "ref_infinite_core_floor_s", "ref_core_bound_s",
                  "ref_cores", "ref_bootstraps", "bounds_model", "windows"}
RATE_FIELDS = {"metric", "value", "unit", "vs_baseline", "median_of", "windows"}


def _env(cache):
    return {**os.environ, "BENCH_PARAMS": "TEST_PARAMS", "BENCH_BATCH": "8", "BENCH_ITERS": "1",
            "BENCH_MEDIAN_N": "1", "BENCH_NETLIST": ADDER, "BENCH_KEY_CACHE": str(cache),
            "OMP_NUM_THREADS": "1"}


def test_bench_prints_the_two_metric_lines_and_reuses_its_key_cache(tmp_path):
    runs = []
    for _ in range(2):
        res = subprocess.run([sys.executable, "-m", "helm_tpu_torch.bench", "--device", "cpu"],
                             cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        runs.append(res)
    assert "keys loaded from cache" not in runs[0].stderr
    assert "keys loaded from cache" in runs[1].stderr
    assert sorted(os.listdir(tmp_path)) == ["bench_ck_test_tiny_s2024.npz", "bench_sk_test_tiny_s2024.npz"]
    out = runs[0].stdout.strip().splitlines()
    assert len(out) == 2, out
    circuit, rate = (json.loads(x) for x in out)
    assert circuit["metric"] == "2-bit-adder_wall_clock_per_vector"
    assert CIRCUIT_FIELDS <= circuit.keys() and circuit.keys() - CIRCUIT_FIELDS == {"levels_fused", "device"}
    assert rate["metric"] == "gate_bootstraps_per_sec_per_chip"  # the last line
    assert RATE_FIELDS <= rate.keys() and rate.keys() - RATE_FIELDS == {"device", "capture"}
    assert circuit["device"] == rate["device"] == "cpu" and rate["capture"] is None
    assert len(circuit["windows"]) == 5 and circuit["value"] > 0
    assert rate["median_of"] == 1 and len(rate["windows"]) == 1 and rate["value"] > 0
    assert circuit["levels_fused"] is False  # the 2-bit adder is shallow: the auto-rule does not fuse
    ref = bounds_for_netlist(str(ROOT / ADDER))
    for k in ("infinite_core_floor_s", "core_bound_s", "cores", "bootstraps"):
        assert circuit[f"ref_{k}"] == ref[k], k
    assert circuit["vs_baseline"] == round(ref["infinite_core_floor_s"] / circuit["value"], 3)
    assert rate["vs_baseline"] == round(rate["value"] / bench.HELM_CPU_BASELINE_BS_PER_SEC, 3)


def test_bench_without_a_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])


@pytest.fixture(scope="module")
def tiny_keys():
    from helm_tpu_torch import params as P
    from helm_tpu_torch.fhe import lwe
    from helm_tpu_torch.fhe.server_key import gen_server_key

    ck = lwe.keygen(P.TEST_PARAMS, 9)
    return P.TEST_PARAMS, (ck, gen_server_key(ck, "cpu"))


def test_bench_wrong_bootstraps_fail_the_run(monkeypatch, tiny_keys):
    from helm_tpu_torch.fhe import pbs

    p, (ck, sk) = tiny_keys
    monkeypatch.setenv("BENCH_BATCH", "4")
    monkeypatch.setattr(mb_pbs, "bootstrap", lambda dsk, x, tv: torch.zeros_like(x))
    with pytest.raises(RuntimeError, match="bootstrap outputs wrong"):
        bench.bootstrap_rate(p, ck, pbs.DeviceServerKey.from_host(sk, "cpu"), torch.device("cpu"))


def test_bench_wrong_circuit_outputs_fail_the_run(monkeypatch, tiny_keys):
    p, (ck, sk) = tiny_keys
    monkeypatch.setenv("BENCH_NETLIST", str(ROOT / ADDER))
    flip = BooleanEngine.decrypt_outputs
    monkeypatch.setattr(BooleanEngine, "decrypt_outputs",
                        lambda self, w: {k: not v for k, v in flip(self, w).items()})
    with pytest.raises(RuntimeError, match="differ from the oracle"):
        bench.circuit_latency(p, ck, sk, torch.device("cpu"))
