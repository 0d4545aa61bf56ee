#!/usr/bin/env python3
"""Smoke run of helm_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, on cuda:0
    python3 chip_smoke.py --only device,build,k1

Phases, in order (each prints one line, with its seconds):
  device  the card's name and power limit (nvidia-smi), torch / CUDA versions
  build   nvcc-builds the kernels in helm_tpu_torch/csrc
  k1      the multi-bit blind-rotation kernel against its plain torch version
          on the card, at TEST_PARAMS_K3, at tiny sets with N=1024, N=2048 and
          grouping 4, and at GATES_128_K3 at the main path's widths (G=8 to
          1024, ragged G=37 and 200): the words must be equal (tolerance 0,
          the arithmetic is exact); prints both times
  batch   the main path: G=1024 AND gates at GATES_128_K3 (keys seed 2024)
          through mb_pbs.bootstrap, decrypted against the truth table;
          bootstraps/s
  c880    c880-like through BooleanEngine(mode="gates", device="cuda"): the
          golden CSV and the Circuit.evaluate oracle, one vector and a batch
          of 8; seconds per vector
  cli     python -m helm_tpu_torch.cli on the 2-bit adder (default set,
          --device cuda) must reproduce its golden CSV
  profile torch.profiler over one G=1024 bootstrap batch and one c880-like
          vector: device time by kernel and the device's idle share

The kernels' launch counters are set to 0 just before the main path (batch,
c880) and read just after; the kernel JSON line reports those counts.
Exits non-zero on any failure, and when no CUDA device is present. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "k1", "batch", "c880", "cli", "profile")


def _sync():
    import torch

    torch.cuda.synchronize()


def _time_ms(fn, reps: int = 1, warm: bool = True) -> tuple[float, object]:
    """Mean milliseconds of `reps` calls by CUDA events (after one untimed
    call when `warm`)."""
    import torch

    out = fn() if warm else None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _ands(ck, G, seed):
    """AND gate pre-images for G random bit pairs (bench.py:298-302)."""
    import numpy as np

    from helm_tpu.fhe import lwe

    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, 2, G).astype(bool)
    b2 = rng.integers(0, 2, G).astype(bool)
    lin = (lwe.encrypt(ck, lwe.encode_bool(b1)) + lwe.encrypt(ck, lwe.encode_bool(b2))).astype(
        np.uint32
    )
    lin[:, ck.params.n] += np.uint32((-(1 << 29)) % (1 << 32))
    return lin, b1 & b2


class Smoke:
    def __init__(self, device: str):
        self.device = device
        self.keys = {}
        self.kernel = {
            "name": "blind_rotate_mb",
            "route": "cuda",
            "source": "helm_tpu_torch/csrc/blind_rotate_mb.cu",
            "replaces": "helm_tpu/ops/mxu_pbs.py:2706",
            "launches": None,
            "max_abs_err": None,
            "ms": None,
            "plain_ms": None,
        }
        self.card = ""

    def keys_for(self, params, seed):
        from helm_tpu.fhe import lwe
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.fhe.server_key import gen_server_key

        if params.name not in self.keys:
            t0 = time.perf_counter()
            ck = lwe.keygen(params, seed)
            sk = gen_server_key(ck, self.device)
            dsk = pbs.DeviceServerKey.from_host(sk, self.device)
            _sync()
            print(f"[keys] {params.name} seed {seed}: {time.perf_counter() - t0:.2f} s", flush=True)
            self.keys[params.name] = (ck, sk, dsk)
        return self.keys[params.name]

    def phase_device(self):
        import torch

        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        self.card = out[0].strip()
        print(self.card)
        return (
            f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}"
        )

    def phase_build(self):
        from helm_tpu_torch.ops import build

        build.load("blind_rotate_mb")
        return f"helm_tpu_torch/csrc/blind_rotate_mb.cu -> {build.BUILD_DIR.name}/"

    def phase_k1(self):
        import numpy as np

        from helm_tpu import params as P
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.fhe.ntt import words
        from helm_tpu_torch.ops import mb_pbs

        worst = 0
        notes = []
        # tiny sets at larger rings: N=1024 / 2048 take the kernel's 64-bit
        # accumulation path (PRIMES_1024, PRIMES with 65537), as does
        # grouping 4 (15 subsets); the main path's sets take the 32-bit one
        wide = (
            dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_n1024", N=1024),
            dataclasses.replace(P.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048),
            P.TEST_PARAMS_MB4,
        )
        # GATES_128_K3 at the main path's widths: c880-like levels are 8, 16
        # or 32 slots for one vector and 64-256 for a batch of 8, the AND
        # batch is 1024; 37 and 200 are ragged against the gate chunks
        for params, seed, gs in (
            (P.TEST_PARAMS_K3, 7, (5, 37)),
            *((w, 9, (5,)) for w in wide),
            (P.GATES_128_K3, 2024, (8, 16, 32, 37, 64, 128, 200, 256, 1024)),
        ):
            ck, _, dsk = self.keys_for(params, seed)
            for G in gs:
                lin, _ = _ands(ck, G, 100 + G)
                x = words(lin, self.device)
                tv = words(pbs.gates_test_poly(params), self.device)
                plain_ms, ref = _time_ms(lambda: pbs.blind_rotate_multibit(dsk, x, tv), warm=False)
                ms, got = _time_ms(lambda: mb_pbs.blind_rotate_mb(dsk, x, tv), reps=3)
                err = int((got - ref).abs().max().item())
                worst = max(worst, err)
                if not bool((got == ref).all()):
                    bad = int(np.flatnonzero((got != ref).cpu().numpy().ravel())[0])
                    raise AssertionError(
                        f"K1 != plain at {params.name} G={G}: first differing word "
                        f"{bad}: {int(got.reshape(-1)[bad])} vs {int(ref.reshape(-1)[bad])}"
                    )
                notes.append(f"{params.name} G={G}: {ms:.3f} ms vs plain {plain_ms:.3f} ms")
                print(f"[k1] {notes[-1]} — equal (tolerance 0)", flush=True)
                if params is P.GATES_128_K3 and G == 1024:
                    self.kernel["ms"] = round(ms, 4)
                    self.kernel["plain_ms"] = round(plain_ms, 4)
        self.kernel["max_abs_err"] = worst
        return "K1 == plain on every shape; " + "; ".join(notes)

    def phase_batch(self, iters: int = 5):
        import torch

        from helm_tpu import params as P
        from helm_tpu.fhe import lwe
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.fhe.ntt import to_host, words
        from helm_tpu_torch.ops import mb_pbs

        p = P.GATES_128_K3
        ck, _, dsk = self.keys_for(p, 2024)
        G = 1024
        lin, exp = _ands(ck, G, 0)
        x = words(lin, self.device)
        tv = words(pbs.gates_test_poly(p), self.device)
        before = mb_pbs.blind_rotate_mb.launches
        out = mb_pbs.bootstrap(dsk, x, tv)
        assert mb_pbs.blind_rotate_mb.launches > before, "the batch did not launch K1"
        got = lwe.decode_bool(lwe.decrypt_phase(ck, to_host(out)))
        assert (got == exp).all(), "G=1024 AND batch decrypts wrong"
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = mb_pbs.bootstrap(dsk, x, tv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return f"GATES_128_K3 G={G} AND truth table ok; {G * iters / dt:.2f} bootstraps/s over {iters} batches"

    def phase_c880(self):
        import numpy as np

        from helm_tpu import params as P
        from helm_tpu.circuit.graph import Circuit
        from helm_tpu.circuit.verilog import read_verilog_file
        from helm_tpu.io import csv_io
        from helm_tpu_torch import BooleanEngine

        p = P.GATES_128_K3
        ck, sk, _ = self.keys_for(p, 2024)
        path = os.path.join(ROOT, "benchmarks/netlists/c880-like.v")
        nl = read_verilog_file(path)
        eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device)
        eng.compile(nl)
        inputs = csv_io.read_input_wires(
            os.path.join(ROOT, "benchmarks/test-cases/c880-like.inputs.csv"), "bool"
        )
        golden = csv_io.read_input_wires(
            os.path.join(ROOT, "benchmarks/test-cases/c880-like.outputs.csv"), "bool"
        )
        c = Circuit.from_netlist(read_verilog_file(path))

        def oracle(m):
            st = c.evaluate(c.initialize_wire_map(nl.wire_set, m))
            return {w: bool(st[w]) for w in nl.outputs}

        times = []
        for _ in range(3):
            wires = eng.encrypt_inputs(inputs)
            _sync()
            t0 = time.perf_counter()
            wires = eng.evaluate(wires)
            _sync()
            times.append(time.perf_counter() - t0)
        got = eng.decrypt_outputs(wires)
        assert got == golden, "c880-like outputs differ from the golden CSV"
        assert got == oracle(inputs), "c880-like outputs differ from the oracle"
        rng = np.random.default_rng(8)
        vecs = [{w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)} for _ in range(8)]
        wires = eng.encrypt_inputs(vecs)
        _sync()
        t0 = time.perf_counter()
        wires = eng.evaluate(wires)
        _sync()
        tb = time.perf_counter() - t0
        outs = eng.decrypt_outputs(wires)
        for i, (m, o) in enumerate(zip(vecs, outs)):
            assert o == oracle(m), f"c880-like batch vector {i} differs from the oracle"
        return (
            f"golden CSV + oracle ok; {float(np.median(times)):.4f} s/vector "
            f"(median of {[round(t, 4) for t in times]}); batch of 8 ok, "
            f"{tb / 8:.4f} s/vector"
        )

    def phase_profile(self):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from helm_tpu import params as P
        from helm_tpu.circuit.verilog import read_verilog_file
        from helm_tpu.io import csv_io
        from helm_tpu_torch import BooleanEngine
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.fhe.ntt import words
        from helm_tpu_torch.ops import mb_pbs

        p = P.GATES_128_K3
        ck, sk, dsk = self.keys_for(p, 2024)
        lin, _ = _ands(ck, 1024, 0)
        x = words(lin, self.device)
        tv = words(pbs.gates_test_poly(p), self.device)
        eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device)
        eng.compile(read_verilog_file(os.path.join(ROOT, "benchmarks/netlists/c880-like.v")))
        vec = eng.encrypt_inputs(csv_io.read_input_wires(
            os.path.join(ROOT, "benchmarks/test-cases/c880-like.inputs.csv"), "bool"))
        runs = {
            "batch1024": lambda: mb_pbs.bootstrap(dsk, x, tv),
            "c880_vector": lambda: eng.evaluate(vec),
        }
        notes = []
        for name, fn in runs.items():
            fn()
            _sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = []
            for ev in prof.key_averages():
                # kernels only: CPU ops would count their kernels twice
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
                    rows.append((ev.self_device_time_total, ev.key, ev.count))
            rows.sort(reverse=True)
            busy = sum(r[0] for r in rows) / 1e6
            top = "; ".join(
                f"{k[:40]} x{c}: {us / 1e3:.3f} ms ({us / 1e6 / busy:.1%})" for us, k, c in rows[:6]
            )
            notes.append(
                f"{name}: wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms, "
                f"idle share {max(0.0, 1 - busy / wall):.1%}; top: {top}"
            )
            print(f"[profile] {notes[-1]}", flush=True)
        return f"{len(notes)} windows profiled"

    def phase_cli(self):
        from helm_tpu.io import csv_io

        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "out.csv")
            res = subprocess.run(
                [
                    sys.executable, "-m", "helm_tpu_torch.cli",
                    "-v", "benchmarks/netlists/2-bit-adder.v",
                    "-i", "benchmarks/test-cases/2-bit-adder.inputs.csv",
                    "-o", out, "--device", self.device,
                ],
                cwd=ROOT, capture_output=True, text=True, timeout=600,
            )
            if res.returncode != 0:
                raise AssertionError(f"CLI failed ({res.returncode}):\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            got = csv_io.read_input_wires(out, "bool")
        exp = csv_io.read_input_wires(
            os.path.join(ROOT, "benchmarks/test-cases/2-bit-adder.outputs.csv"), "bool"
        )
        assert got == exp, f"CLI outputs {got} != golden {exp}"
        return "2-bit-adder --device cuda reproduces 2-bit-adder.outputs.csv"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES), help="comma-separated phases")
    args = ap.parse_args(argv)
    only = [x for x in args.only.split(",") if x]
    unknown = set(only) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    smoke = Smoke("cuda")
    from helm_tpu_torch.ops import mb_pbs

    main_path = [x for x in ("batch", "c880") if x in only]
    for name in PHASES:
        if name not in only:
            continue
        if main_path and name == main_path[0]:
            mb_pbs.blind_rotate_mb.launches = 0  # the main path's run starts here
        t0 = time.perf_counter()
        msg = getattr(smoke, f"phase_{name}")()
        print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)
        if main_path and name == main_path[-1]:
            smoke.kernel["launches"] = mb_pbs.blind_rotate_mb.launches
            assert smoke.kernel["launches"] > 0, "the main path never launched K1"
    print(json.dumps({"kernels": [smoke.kernel]}))
    if smoke.card:
        print(smoke.card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
