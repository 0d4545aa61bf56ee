"""Two OS processes under `--multihost`: the port's CLI over a gloo process
group on the CPU.

The counterpart of tests/test_multihost.py: two processes run `python -m
helm_tpu_torch.cli --multihost 127.0.0.1:<port>,2,<pid> --mesh 2 --device
cpu --test-params`, each one shard of a two-shard mesh, every PBS batch
all-gathered between them (parallel/mesh.py). Both must print the
oracle's outputs and the same outputs as each other, and only rank 0 may
write `-o`. No process is waited on longer than 300 s (a rendezvous that
never completes fails within `distributed.TIMEOUT_S`). `init_multihost`'s
choice of card and backend is also checked in threads of this process,
with a faked card count and faked host names.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import read_verilog_file
from helm_tpu_torch.io import csv_io
from helm_tpu_torch.parallel import distributed
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _outputs(stdout: str) -> dict:
    """The ` wire: value` lines the CLI prints after `Encrypted Evaluation:`."""
    lines = stdout.split("Encrypted Evaluation:\n", 1)[1].splitlines()
    out = {}
    for line in lines:
        if not line.startswith(" ") or ": " not in line:
            break
        w, v = line.strip().split(": ")
        out[w] = v
    return out


def _run_two(argv, tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "helm_tpu_torch.cli", *argv, "--test-params", "--device", "cpu",
             "--multihost", f"{coordinator},2,{pid}", "--mesh", "2", "-o", str(tmp_path / f"out{pid}.csv")],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"},
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for pid, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"process {pid}:\n{out[-3000:]}"
        assert f"Process {pid} of 2 (gloo" in out
        assert "2 shards [cpu, cpu], 2 processes (gloo)" in out
    assert (tmp_path / "out0.csv").exists() and not (tmp_path / "out1.csv").exists()
    got = [_outputs(out) for out in outs]
    assert got[0] == got[1] and got[0]
    return got[0]


def test_two_process_gate_sharded_adder(tmp_path):
    inputs = {"a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True, "cin": True}
    argv = ["-v", "benchmarks/netlists/2-bit-adder.v"]
    for w, v in inputs.items():
        argv += ["-w", w, str(int(v))]
    out = _run_two(argv, tmp_path)
    # 1 + 3 + 1 = 5: sum[0]=1, sum[1]=0, cout=1
    assert out == {"cout": "True", "sum[0]": "True", "sum[1]": "False"}
    assert csv_io.read_input_wires(str(tmp_path / "out0.csv"), "bool") == {
        "cout": True, "sum[0]": True, "sum[1]": False,
    }


def test_two_process_arith_chi_squared(tmp_path):
    """Chi-squared u8 through the dataflow scheduler, every merged radix
    bootstrap sharded over the two processes."""
    inputs = {"n0": 3, "n1": 5, "n2": 7}
    argv = ["-v", "benchmarks/netlists/chi_squared_arith.v", "-a", "u8"]
    for w, v in inputs.items():
        argv += ["-w", w, str(v)]
    out = _run_two(argv, tmp_path)
    nl = read_verilog_file(str(ROOT / "benchmarks/netlists/chi_squared_arith.v"), True)
    c = Circuit.from_netlist(nl)
    exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), 8)
    assert out == {w: str(exp[w]) for w in nl.outputs}
    assert out["alpha"] == str(((4 * 3 * 7 - 5 * 5) ** 2) % 256)
    assert csv_io.read_input_wires(str(tmp_path / "out0.csv"), "u8") == {w: exp[w] for w in nl.outputs}


@pytest.mark.parametrize("spec", ["127.0.0.1:1,2", "127.0.0.1:1,two,0"])
def test_malformed_multihost_flag_exits(spec):
    res = subprocess.run(
        [sys.executable, "-m", "helm_tpu_torch.cli", "-v", "benchmarks/netlists/2-bit-adder.v",
         "--device", "cpu", "--multihost", spec],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0 and "Traceback" not in res.stderr, res.stderr[-2000:]


@pytest.mark.parametrize("hosts, cards, want", [
    # two hosts of eight cards, world 16: every rank has a card of its own
    (["a"] * 8 + ["b"] * 8, 8, [("nccl", r % 8) for r in range(16)]),
    # ranks dealt out across two hosts of two cards
    (["a", "b", "a", "b"], 2, [("nccl", 0), ("nccl", 0), ("nccl", 1), ("nccl", 1)]),
    # two ranks on a one-card host share the card: NCCL would refuse
    (["a", "a"], 1, [("gloo", 0), ("gloo", 0)]),
    # one host of two cards, three ranks
    (["a", "a", "a"], 2, [("gloo", 0), ("gloo", 1), ("gloo", 0)]),
], ids=["2x8", "interleaved", "shared-card", "3-on-2"])
def test_init_multihost_picks_card_and_backend_per_host(monkeypatch, hosts, cards, want):
    """Each rank of a faked layout (host names, cards a host) joins through
    `init_multihost` in a thread of its own; the backend it asks for and
    the card it takes follow the ranks of its own host, not the world size."""
    backends, devices, stores = {}, {}, []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)

    def init_process_group(backend, store, rank, **kw):
        backends[rank] = backend
        stores.append(store)  # rank 0's serves the others until they have read it

    monkeypatch.setattr(torch.distributed, "init_process_group", init_process_group)
    monkeypatch.setattr(distributed.socket, "gethostname",
                        lambda: hosts[int(threading.current_thread().name)])
    coordinator = f"127.0.0.1:{_free_port()}"

    def join(rank):
        devices[rank] = distributed.init_multihost(coordinator, len(hosts), rank, "cuda")

    threads = [threading.Thread(target=join, args=(r,), name=str(r)) for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    got = [(backends.get(r), devices[r].index if r in devices else None) for r in range(len(hosts))]
    assert got == want
    assert all(devices[r].type == "cuda" for r in devices)
