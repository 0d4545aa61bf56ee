#!/usr/bin/env python3
"""Smoke run of helm_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, on cuda:0
    python3 chip_smoke.py --only device,build,k1,k6
    python3 chip_smoke.py --only device,build,k1,k4,k3
    python3 chip_smoke.py --only device,build,k1,k6,k2
    python3 chip_smoke.py --only device,build,probes,tools

Phases, in order (each prints one line, with its seconds):
  device  the card's name and power limit (nvidia-smi), torch / CUDA versions
  build   nvcc-builds the kernels in helm_tpu_torch/csrc, one nvcc per
          source, all started together
  k1      the multi-bit blind-rotation kernel (K1: one launch per rotation,
          a thread-block cluster of 4 blocks, one per CRT prime, per tile of
          gates, walking every CMux group with the tile's accumulators,
          gadget rows and products in shared memory: the body of
          csrc/rotate_tiles.cuh, which K6 and K2 share; the tile from
          ops/mb_pbs.py tile_plan, printed per width) against its plain torch
          version on the card, at TEST_PARAMS_K3, at tiny sets with N=1024,
          N=2048 and grouping 4, at GATES_128_K3 at the main path's widths
          (G=8 to 1024, ragged G=37 and 200) and at LUT_128_K2 (k=2, N=1024,
          9 gadget rows) and LUT_128_MB2 (k=1, N=2048, 6 rows at base 2^8,
          BASELINE's LUT set) at the LUT adder's level width (G=2) and G=256,
          and at ARITH_128_MB2 (N=2048, 6 rows, PRIMES with 65537) at a narrow
          merged-round width (G=8) and a wide one (G=1024): the words must be
          equal (tolerance 0, the arithmetic is exact); prints both times.
          Then K1's grouping-1 builds (P_1 = X^a - 1, on gen_bsk_multibit's
          keys) the same way: the tiny k=3 set and TEST_PARAMS at G=5 and
          37, GATES_128_K3 at g = 1 (g1_fs_test's set) at G=8, 37 and 1024
          and GATES_TPU at G=1024
  k6      the prime-split blind-rotation kernel (K6: K1's body with the CRT
          fold in place of Garner, one launch per rotation; its tile plan
          printed per width) against its plain torch
          version (blind_rotate_prime_split) the same way, at TEST_PARAMS_K3,
          a tiny grouping-4 set, GATES_128_K3 at K1's widths, LUT_128_K2
          at G=2 and 256 and ARITH_128_MB2 at G=8 and 1024. Where k1 ran the
          same inputs, K6 is held against k1's plain output (the two plain
          versions are equal word for word, tests/test_torch_ps.py); the
          plain prime-split version itself runs on the card at the tiny sets
          and at GATES_128_K3 G=1024, and must equal k1's words there too
  k4      the transposed blind-rotation kernel (K4: K1's body with the
          four-step transform, its N2-point stages on the int8 tensor cores,
          one launch per rotation; its tile plan and staged limb matrices
          printed per width) the same way, at every set and width of k1 and
          at GATES_TPU_MB4 (grouping 4, N=1024) G=8: first its four-step
          transforms alone (the rotation's device functions) against
          fhe/ntt.py at each ring size, p = 65537's matrices in two limbs
          at N=2048, then the rotation against K1's plain words; its own
          plain version (blind_rotate_transposed) runs on the card at the
          tiny sets, GATES_TPU_MB4 and GATES_128_K3 G=1024 and must equal
          them too
  k3      the gate-major blind-rotation kernel (K3: K1's body with the
          bit-ladder monomials, one launch per rotation) the same way at
          every set and width of k1 (its plain version: blind_rotate_ladder)
  k2      the single-bit blind-rotation kernel (K2: K1's body at grouping 1,
          decomposing the rotated difference, one launch per rotation; its
          tile plan printed per width) against its plain torch
          version the same way, at TEST_PARAMS (N=64), TEST_PARAMS_LUT
          (N=128), a tiny k=3 grouping-1 set, GATES_TPU at G=1 to 1024,
          GATES_PARAMS (6 rows) at G=37, LUT_PARAMS (N=2048) at the LUT
          adder's level width and G=37 and ARITH_PARAMS (N=2048, 6 rows) at
          G=8 and 1024 (per-gate test polynomials)
  probes  main path of the reference's four Pallas probes, ported as K7
          (ops/probes.py expand8, csrc/probe_expand8.cu), K8 (splat) and
          K9 (liveset, both csrc/probe_splat.cu) and K10 (ptw,
          csrc/probe_ptw.cu): each against its plain torch version on the
          card, tolerance 0, K7 at [6144, 8] -> [6144, 128] (and against
          np.tile), K8's four variants and K9's 60 builds (R 1-8 x A 1-16
          x splat, red, two) at 0, 1, 4 steps, a stage of the column ring
          -1, +0, +1 and the ring's depth -1, +1 (ops/probes.py
          SPLAT_STAGE, SPLAT_RING), and at G=200 (not a multiple of the
          block), K8's also at 8 steps of their own
          columns, K8 splat at 512 and K9 R=8 A=12 at 256,
          K10's five patterns at 3 steps, A, NOB, B, B2 and C at 64 (and C's
          limb buffer, after a launch of 0 steps, byte for byte against
          ops/probes.py's model of its swizzled layout); the timed shapes'
          kernel, plain and library times and bounds go into the kernels
          line (library: x.repeat(1, 16) for K7; for K10's C the bf16
          torch.matmul of a step's stacked (unit, group) limb matrices by
          its feedback, 64 of them; none for K8 and K9). K7's, K8's and
          K9's times and K7's library's are device times
          (tools/probe_timing.py graph_ms: 30 calls in a CUDA graph for K7,
          10 for K8 and K9, replayed), printed beside their eager times
          (CUDA events around calls launched from the host, whose gaps they
          include); C's library is timed the same way (a graph of its 64
          calls) beside the eager reading. C's clocks a block a step per
          phase (feedback, products, epilogue, barrier, and the concurrent
          build: ops/probes.py ptw_c_phases) and registers and spills are
          printed; every K8-K10 build must report 0 spill bytes. Then,
          with the four probes' counts set to 0, the probe tools
          (helm_tpu_torch/tools/expand8_probe, splat_repro,
          liveset_harness, ptw_probe) at the reference's defaults: their
          rates (K7 and K10 also as graph replays), registers a thread and
          spill bytes (cudaFuncGetAttributes of each build); their
          launches are the phase's (a graph's calls count once, when the
          wrapper captures them; its replays launch without the wrappers)
  batch   main path: G=1024 AND gates at GATES_128_K3 (K1, keys seed 2024)
          through mb_pbs.bootstrap, decrypted against the truth table;
          bootstraps/s
  c880    main path: c880-like through BooleanEngine(mode="gates") at
          GATES_128_K3 (K1), fused (the auto-rule must fuse it: one CUDA
          graph replay a call after a first, eager call that captures) and
          with fuse_levels=False, on the same encrypted wires: the replayed
          words must equal the eager ones on every wire but the plan's trash
          wire (tolerance 0), one vector and a batch of 8; the golden CSV and
          the Circuit.evaluate oracle; seconds per vector for both
  g1      main path at GATES_TPU (K2): 2-bit-adder against its golden CSV;
          s27 x 3 cycles through fused evaluate_cycles (one graph of 3 x the
          levels, replayed) and through three evaluate calls: equal words,
          the golden CSV, s/cycle for both; c880-like fused and eager as in
          c880; a G=1024 AND batch against the truth table (bootstraps/s)
  lut     main path: 8-bit-adder-lut-3-1 through BooleanEngine(mode="lut")
          at LUT_PARAMS (K2) and LUT_128_K2 (K1), fused (per-slot test
          polynomials inside the graph) and eager on the same wires: equal
          words, the golden CSV and the oracle; s/vector for both
  arith   main path: chi_squared_arith.v u32 through ArithEngine at
          ARITH_128_MB2 (K1) for the four recorded vector sets
          chi_squared_arith_{1..4}, one vector at a time, then as one batch
          of 4: each against its golden CSV and the Circuit.evaluate_arith
          oracle; s/vector, merged rounds and slots. Then chi_squared_arith_1
          at ARITH_PARAMS (grouping 1: K2) against its golden CSV and the
          oracle
  baseline main path: helm_tpu_torch.tools.verify_baseline.main([]) in
          process: the five BASELINE configs at GATES_128_K3, LUT_128_MB2 and
          ARITH_128_MB2 on the card must print ALL BIT-EXACT; seconds per
          config
  ps      main path under HELM_TPU_MB_KERNEL=ps (K6): the G=1024 AND batch
          and c880-like at GATES_128_K3 fused and eager as in c880 (truth
          table, equal words, golden CSV + oracle; K6 launches inside the
          graph); K6 must launch and K1 must not. Then one G=37 AND batch under
          HELM_TPU_MB_KERNEL=hb2, which must launch K1
  serve   main path of the daemon under HELM_TPU_MB_KERNEL=ts (K4):
          helm_tpu_torch.serve.main in process on c880-like at GATES_128_K3
          (8 request CSVs: the golden vector and 7 from a numpy seed, --batch
          4 --max-batches 2 --fuse-levels: the second batch must be a graph
          replay, K4 inside it) and chi-squared u32 at ARITH_128_MB2 (the four
          recorded vectors, --batch 4 --max-batches 1): every output against
          its golden CSV or the oracle, every input moved to done/; s/vector
          per batch; K4 must launch and K1 must not. Then, under the default
          kernel (K1), a fused c880-like engine at GATES_128_K3 at B = 1, 2,
          4, 7, 8, 12, 16 and the model's pick (the golden vector and 15
          from a numpy seed; first
          call captures, then the median of 3 replays, every output against
          the oracle): the measured s/vector beside the cost model's
          (helm_tpu_torch/batching.py), the model's constants fitted to the
          measurement, and the model's choice; then the daemon under
          --batch auto --max-batch 16 on two batches' worth of c880-like
          requests (the second batch a graph replay), which must choose the
          model's batch and reproduce the golden CSV and the oracle
  sweep   helm_tpu_torch.tools.mb_sweep at GATES_128_K3, G = 8, 64 and 1024,
          for LAYOUT fs (K1), ps (K6), ts (K4) and gm (K3, whose only path
          this is): one table of rot/s
  mesh    main path of gate sharding (helm_tpu_torch/parallel/mesh.py):
          four shards of cuda:0 (a GateMesh built by hand, each shard on
          its own stream) against the unsharded engines, tolerance 0 on
          every real wire: c880-like at GATES_128_K3 eager and fused (the
          shards' kernels inside one graph replay; golden CSV), the G=1024
          AND batch under fs (K1), ps (K6), ts (K4) and at GATES_TPU (K2),
          the LUT adder at LUT_128_K2 fused and chi-squared u32 at
          ARITH_128_MB2 (one vector): s/vector or ms sharded and
          unsharded, each shard's launches; dryrun_multichip(4) on the four
          shards; a process group of one on NCCL in process (a fused
          c880-like whose graph holds its 24 all-gathers, replayed) and,
          in subprocesses started first, the CLI under --multihost: c880-like
          at world size 1 on NCCL (--fuse-levels: the capture must hold
          the all-gathers; golden CSV) and the 2-bit adder in two processes
          on the one card (gloo: NCCL refuses two ranks on one device),
          rank 0's -o the golden CSV and both printing the same outputs.
          With two or more cards, make_gate_mesh(count) and the CLI on
          NCCL across them too; else it prints that the exchange across
          cards is not measured
  tools   main path of the reference's measurement tools, ported to
          helm_tpu_torch/tools with the keys of the earlier phases:
          family_bench at GATES_128_K3 on c1908-like, c6288-like,
          c880-like x 8 and s386-like x 4 cycles (CYCFUSE=1) and in LUT
          mode at LUT_128_K2 on both LUT adders (every wire of every cycle
          against the oracle); aes_bench at GATES_128_K3 fused (all 358
          levels in one CUDA graph) at BATCH 0 and 4 (every ciphertext
          against the oracle, FIPS-197 C.1); chi2_bench on chi-squared u32
          at ARITH_PARAMS (K2) and on chi-squared u32, euclidean u32 and
          box blur u16 at ARITH_128_MB2 (K1), against evaluate_arith;
          noise_validate at GATES_128_K3 over 2^18 samples (0 decision
          failures) and noise_decompose over 8192; their RESULT lines.
          g1_fs_test's A/B at GATES_128_K3, G=1024 AND gates, decrypt-checked:
          K1 at g = 2, K1 at g = 1 (the tool's run too) and K2 at g = 1 on
          the same key, ms and rot/s beside their bounds; param_search
          --measure 3 (its table; K1 at its first three rows with a build)
          and its model against K1 at the held-out LUT_128_MB2 and
          GATES_TPU_MB4; then collect_results over the phase's own output,
          which must find every RESULT, sweep and AES line printed
  cli     python -m helm_tpu_torch.cli --device cuda (default sets), four
          subprocesses started together: the 2-bit adder (with --profile
          DIR: its Chrome trace must name rotate_tiles), the LUT adder and
          chi-squared u32 (-a u32, chi_squared_arith_1) must reproduce their
          golden CSVs, and chi-squared u32 with -I, the four recorded vectors
          in one batch, their four golden CSVs
  bench   python -m helm_tpu_torch.bench in a subprocess at its defaults
          but BENCH_MEDIAN_N=3 and no key cache: its two JSON lines,
          c880-like_wall_clock_per_vector and, last,
          gate_bootstraps_per_sec_per_chip, printed
  profile torch.profiler over one G=1024 bootstrap batch and one c880-like
          vector at GATES_128_K3 (K1: eager, then fused, one graph replay;
          then K6 under HELM_TPU_MB_KERNEL=ps, and the batch under
          HELM_TPU_MB_KERNEL=ts: K4), one c880-like vector at GATES_TPU
          (eager, then fused) and one chi-squared u32 vector at
          ARITH_128_MB2: device time by kernel and the device's idle share;
          under ts the rotation must be one rotate_tiles launch per batch,
          with no rotate_group_ts or crt_accumulate; a fused window must
          show one rotate_tiles launch per PBS level in the trace of its
          replay

The kernels' launch counters are set to 0 just before each main-path phase
(probes, batch, c880, g1, lut, arith, baseline, ps, serve, sweep, mesh,
tools; in probes again after its comparisons) and read just after it;
the kernel JSON line reports the sums. A graph replay launches its
kernels without calling their wrappers: the engine adds, at each replay,
the launches the wrapper counted while the graph was captured (and takes
them back from the capture, which launched nothing), so the counts stay
the device's launches; phase profile checks them against the trace of a
replay. A kernel's bound_ms is the larger
of its integer operations over the card's INT32 rate and its bytes over
the memory rate (int_ops and min_bytes below; K6, K4 and K3 compute K1's
function: the same transforms, products and bytes, whatever their
transform's form, fold or monomial construction); K7-K10's is the larger
of their FP32 operations over the FP32 instruction rate, 132 SMs x 128
lanes x 1.98 GHz = 33.45e12 a second (a multiply and an add are one
instruction each, as the kernels never fuse them; the 67 TFLOP/s peak
counts a fused multiply-add as two), C's bf16 products over 989 TFLOP/s,
and their bytes over the memory rate (tools/probe_timing.py). Exits non-zero on
any failure, and when no CUDA device is present. Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = (
    "device", "build", "k1", "k6", "k4", "k3", "k2", "probes", "batch", "c880", "g1", "lut", "arith",
    "baseline", "ps", "serve", "sweep", "mesh", "tools", "cli", "bench", "profile",
)
MAIN_PATH = ("probes", "batch", "c880", "g1", "lut", "arith", "baseline", "ps", "serve", "sweep", "mesh", "tools")
KERNELS = ("blind_rotate_mb", "blind_rotate_sb", "blind_rotate_ps", "blind_rotate_ts", "blind_rotate_gm")
#: the probes' sources (K7; K8 and K9; K10), built with the kernels
PROBE_SOURCES = ("probe_expand8", "probe_splat", "probe_ptw")

#: H100 SXM peaks used for bound_ms: 132 SMs x 64 INT32 lanes x 1.98 GHz
#: boost (the guide's table has no INT32 row; its 67 TFLOP/s FP32 is the
#: same 132 x 128 x 2 x 1.98 GHz count) and 3.35 TB/s of HBM3
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
#: integer operations per NTT butterfly (a Shoup multiply: three
#: multiplies, a shift and a corrective subtract; a modular add and a
#: modular subtract: an add or subtract and a corrective select each) and
#: per multiply-add of the pointwise products
OPS_PER_BUTTERFLY = 10
OPS_PER_MULADD = 2
NP = 4  # CRT primes


def int_ops(p, G: int, kernel: str = "blind_rotate_mb") -> int:
    """Integer operations of one blind rotation of G gates at set p by
    `kernel`: per step (a mask element, or a group of g of them) and gate,
    the forward NTTs of the gadget rows and the inverse NTTs of the k+1
    components over NP primes, the rows x (2^g-1) x (k+1) x NP x N
    multiply-adds against the BSK and, where the kernel's word source
    scales by the subset polynomials (every kernel but K2, K1 at g = 1
    too: P_1 = X^a - 1), the (2^g-1) x (k+1) x NP x N multiply-adds by
    them."""
    N, kp1, rows, g = p.N, p.k + 1, p.gadget_rows, p.grouping
    bfly = (rows + kp1) * NP * (N // 2) * int(math.log2(N))
    nv1 = (1 << g) - 1
    subsets = kernel != "blind_rotate_sb"
    muladd = rows * nv1 * kp1 * NP * N + (nv1 * kp1 * NP * N if subsets else 0)
    return G * (p.n // g) * (OPS_PER_BUTTERFLY * bfly + OPS_PER_MULADD * muladd)


def min_bytes(p, G: int, testv_rows: int) -> int:
    """Bytes a blind rotation must move: the BSK, the LWE inputs and the
    test polynomials read once, the accumulators written once (u32). The
    same for every word source: K1's key at g = 1 has K2's size."""
    g = p.grouping
    bsk = (p.n // g) * ((1 << g) - 1) * p.gadget_rows * (p.k + 1) * NP * p.N
    return 4 * (bsk + G * (p.n + 1) + testv_rows * p.N + G * (p.k + 1) * p.N)


def bound_ms(p, G: int, testv_rows: int, kernel: str = "blind_rotate_mb") -> tuple[float, str]:
    t_ops = int_ops(p, G, kernel) / INT32_OPS_PER_S
    t_bytes = min_bytes(p, G, testv_rows) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


@contextlib.contextmanager
def _mb_kernel(name):
    """HELM_TPU_MB_KERNEL=name inside the block (mb_pbs.mb_kernel reads it
    at every bootstrap), restored after."""
    old = os.environ.get("HELM_TPU_MB_KERNEL")
    os.environ["HELM_TPU_MB_KERNEL"] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HELM_TPU_MB_KERNEL", None)
        else:
            os.environ["HELM_TPU_MB_KERNEL"] = old


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

    from helm_tpu_torch.fhe import lwe

    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, 2, G).astype(bool)
    b2 = rng.integers(0, 2, G).astype(bool)
    lin = (lwe.encrypt(ck, lwe.encode_bool(b1)) + lwe.encrypt(ck, lwe.encode_bool(b2))).astype(
        np.uint32
    )
    lin[:, ck.params.n] += np.uint32((-(1 << 29)) % (1 << 32))
    return lin, b1 & b2


def _golden(name, kind="bool"):
    from helm_tpu_torch.io import csv_io

    return csv_io.read_input_wires(os.path.join(ROOT, "benchmarks/test-cases", name), kind)


def _netlist(name, arith=False):
    from helm_tpu_torch.circuit.verilog import read_verilog_file

    return read_verilog_file(os.path.join(ROOT, "benchmarks/netlists", name), arith)


def _oracle(nl, inputs, cycles=1):
    from helm_tpu_torch.circuit.graph import Circuit

    c = Circuit.from_netlist(nl)
    st = c.initialize_wire_map(nl.wire_set, inputs)
    for _ in range(cycles):
        st = c.evaluate(st)
    return {w: bool(st[w]) for w in nl.outputs}


def _oracle_arith(nl, inputs, width):
    from helm_tpu_torch.circuit.graph import Circuit

    c = Circuit.from_netlist(nl)
    vals = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), width)
    return {w: vals[w] for w in nl.outputs}


def _free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Tee:
    """A text stream that writes to `stream` and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _same(out, exp):
    """Engine outputs (bool in gates mode, 0/1 in LUT mode) == expected bits."""
    return {w: bool(v) for w, v in out.items()} == {w: bool(v) for w, v in exp.items()}


class Smoke:
    def __init__(self, device: str):
        self.device = device
        self.keys = {}
        self.kernel = {
            "blind_rotate_mb": {
                "name": "blind_rotate_mb",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/blind_rotate_mb.cu",
                "replaces": "helm_tpu/ops/mxu_pbs.py:2706",
            },
            "blind_rotate_sb": {
                "name": "blind_rotate_sb",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/blind_rotate_sb.cu",
                "replaces": "helm_tpu/ops/mxu_pbs.py:1652",
            },
            "blind_rotate_ps": {
                "name": "blind_rotate_ps",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/blind_rotate_ps.cu",
                "replaces": "helm_tpu/ops/mxu_pbs.py:2425",
            },
            "blind_rotate_ts": {
                "name": "blind_rotate_ts",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/blind_rotate_ts.cu",
                "replaces": "helm_tpu/ops/ts_pbs.py:643",
            },
            "blind_rotate_gm": {
                "name": "blind_rotate_gm",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/blind_rotate_gm.cu",
                "replaces": "helm_tpu/ops/mxu_pbs.py:1811",
            },
            "expand8": {
                "name": "expand8",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/probe_expand8.cu",
                "replaces": "tools/expand8_hw_test.py:18",
            },
            "splat": {
                "name": "splat",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/probe_splat.cu",
                "replaces": "tools/mosaic_splat_repro.py:94",
            },
            "liveset": {
                "name": "liveset",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/probe_splat.cu",
                "replaces": "tools/liveset_harness.py:111",
            },
            "ptw": {
                "name": "ptw",
                "route": "cuda",
                "source": "helm_tpu_torch/csrc/probe_ptw.cu",
                "replaces": "tools/ptw_probe.py:213",
            },
        }
        for k in self.kernel.values():
            k.update(launches=0, max_abs_err=None, ms=None, plain_ms=None,
                     bound_ms=None, bound_by=None, library_ms=None)
        #: K1 at grouping 1 (GATES_128_K3 at g = 1, G = 1024; phase k1),
        #: its launches those at grouping 1 on the main path
        self.kernel["blind_rotate_mb"]["g1"] = dict(launches=0, ms=None, plain_ms=None, bound_ms=None,
                                                    bound_by=None)
        self.card = ""
        #: kernel inputs and plain outputs by (set, per-gate test polys), at
        #: the set's widest G: (lwe_in, testv, plain ms, words), so that the
        #: kernels, which compute one function, share them
        self.plain = {}

    def keys_for(self, params, seed, multibit=False):
        """(client key, host server key, device server key) of `params`
        from keygen at `seed`, made once per set name; `multibit`: the BSK
        from gen_bsk_multibit at any grouping (K1 at g = 1 takes its [n,
        1, rows, k+1, NP, N] layout, as the reference's g1_fs_test does)."""
        from helm_tpu_torch.fhe import lwe, pbs
        from helm_tpu_torch.fhe.server_key import ServerKey, gen_bsk_multibit, gen_ksk, gen_server_key

        if params.name not in self.keys:
            t0 = time.perf_counter()
            ck = lwe.keygen(params, seed)
            if multibit:
                sk = ServerKey(params, *gen_bsk_multibit(ck, self.device), gen_ksk(ck))
            else:
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

        t0 = time.perf_counter()
        build.load_all(KERNELS + PROBE_SOURCES)
        return (f"helm_tpu_torch/csrc/{{{','.join(KERNELS + PROBE_SOURCES)}}}.cu -> {build.BUILD_DIR.name}/ "
                f"in {time.perf_counter() - t0:.2f} s")

    def _check_kernel(self, name, label, plain, kernel, cases, timed, detail=None, record=None):
        """Hold `kernel` against the plain words word for word on every case
        (params, seed, Gs, per-gate testv, Gs where `plain` runs even when
        another kernel's plain version already ran these inputs, and must
        agree with it); record the timed case's numbers in `record`
        (default the kernel's row). `detail(params, G)`
        adds to each width's line. The inputs of a set are drawn once, at
        its widest G, and each narrower G takes their first G rows: every
        gate rotates alone, so the plain words of those rows are the widest
        run's (the plain versions, a host loop of small launches, then run
        once a set)."""
        import numpy as np
        import torch

        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.fhe.ntt import words

        worst = 0
        notes = []
        rec = self.kernel[name] if record is None else record
        for params, seed, gs, per_gate, fresh in cases:
            ck, _, dsk = self.keys_for(params, seed)
            top = max(gs)
            key = (params.name, per_gate)
            if key not in self.plain or self.plain[key][0].shape[0] < top:
                lin, _ = _ands(ck, top, 100 + top)
                x = words(lin, self.device)
                if per_gate:
                    rng = np.random.default_rng(top)
                    tv = words(rng.integers(0, 1 << 32, size=(top, params.N), dtype=np.uint64)
                               .astype(np.uint32), self.device)
                else:
                    tv = words(pbs.gates_test_poly(params), self.device)
                self.plain[key] = (x, tv, *_time_ms(lambda: plain(dsk, x, tv), warm=False))
            x_all, tv_all, all_ms, ref_all = self.plain[key]
            for G in gs:
                x, ref = x_all[:G], ref_all[:G]
                tv = tv_all[:G] if per_gate else tv_all
                plain_ms = all_ms if G == x_all.shape[0] else None
                if G in fresh:
                    plain_ms, own = _time_ms(lambda: plain(dsk, x, tv), warm=False)
                    assert torch.equal(own, ref), (
                        f"{plain.__name__} != the earlier plain version at {params.name} G={G}"
                    )
                ms, got = _time_ms(lambda: kernel(dsk, x, tv), reps=3)
                err = int((got - ref).abs().max().item())
                worst = max(worst, err)
                if not bool((got == ref).all()):
                    bad = int(np.flatnonzero((got != ref).cpu().numpy().ravel())[0])
                    raise AssertionError(
                        f"{label} != plain at {params.name} G={G}: first differing word "
                        f"{bad}: {int(got.reshape(-1)[bad])} vs {int(ref.reshape(-1)[bad])}"
                    )
                b_ms, b_by = bound_ms(params, G, tv.shape[0], name)
                vs = f"{plain_ms:.6f} ms" if plain_ms is not None else f"(rows of its G={x_all.shape[0]} run)"
                notes.append(
                    f"{params.name} G={G}: {ms:.6f} ms vs plain {vs}, "
                    f"bound {b_ms:.6f} ms ({b_by})" + (f", {detail(params, G)}" if detail else "")
                )
                print(f"[{label.lower()}] {notes[-1]} — equal (tolerance 0)", flush=True)
                if (params.name, G) == timed:
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        self.kernel[name]["max_abs_err"] = max(worst, self.kernel[name]["max_abs_err"] or 0)
        assert rec["ms"] is not None, f"{label}: timed shape {timed} not run"
        return f"{label} == plain on every shape; " + "; ".join(notes)

    def phase_k1(self):
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.ops import mb_pbs

        # tiny sets at larger rings: N=1024 / 2048 take the kernel's 64-bit
        # accumulation path (PRIMES_1024, PRIMES with 65537), as does
        # grouping 4 (15 subsets); GATES_128_K3 takes the 32-bit one.
        # GATES_128_K3 at the main path's widths: c880-like levels are 8, 16
        # or 32 slots for one vector and 64-256 for a batch of 8, the AND
        # batch is 1024; 37 and 200 are ragged against the gate chunks.
        # LUT_128_K2 (k=2, 9 rows, N=1024) and LUT_128_MB2 (k=1, 6 rows at
        # base 2^8, N=2048): the LUT adder's levels are 2 slots wide, each
        # with its own test polynomial. ARITH_128_MB2 (6
        # rows x 2048 words: 48 KB per decompose block): chi-squared u32's
        # merged rounds, each slot with its group's test polynomial
        msg = self._check_kernel(
            "blind_rotate_mb", "K1", pbs.blind_rotate_multibit, mb_pbs.blind_rotate_mb,
            self._k1_cases(), ("gates_128_k3", 1024), detail=self._tile("blind_rotate_mb"),
        )
        # grouping 1 (P_1 = X^a - 1), on gen_bsk_multibit's keys: the tiny
        # k=3 set (8 rows), TEST_PARAMS (4 rows, N=64), GATES_128_K3 at g = 1
        # (g1_fs_test's set and seed) at a narrow, a ragged and the A/B's
        # width, GATES_TPU (N=1024, 64-bit sums) at G=1024
        cases = self._k1_g1_cases()
        for params, seed, *_ in cases:
            self.keys_for(params, seed, multibit=True)
        return msg + "; " + self._check_kernel(
            "blind_rotate_mb", "K1 g=1", pbs.blind_rotate_multibit, mb_pbs.blind_rotate_mb, cases,
            ("gates_128_k3_g1", 1024), detail=self._tile("blind_rotate_mb"),
            record=self.kernel["blind_rotate_mb"]["g1"],
        )

    def _k1_g1_cases(self):
        """The grouping-1 sets and widths K1 is checked at (phase k1), named
        apart from phase k2's (a set name keys its inputs and plain words)."""
        from helm_tpu_torch import params as P
        from helm_tpu_torch.tools import g1_fs_test

        def k1(p, name):
            return dataclasses.replace(p, name=name, grouping=1)

        return (
            (k1(P.TEST_PARAMS_K3, "test_tiny_k3_g1_k1"), 13, (5, 37), False, ()),
            (k1(P.TEST_PARAMS, "test_params_k1"), 11, (5, 37), False, ()),
            (g1_fs_test.g1_params(False), 7, (8, 37, 1024), False, ()),
            (k1(P.GATES_TPU, "gates_tpu_v32_k1"), 2026, (1024,), False, ()),
        )

    def _tile(self, kernel):
        """The `detail` of phases k1, k6, k2, k4 and k3: the width's tile plan
        for `kernel` (for K4 also the directions of its limb matrices staged
        in shared memory), the bytes of the chunked BSK copy it reads
        (bsk_k1; K4: its own, in the four-step order) and those of the
        natural BSK every route keeps (dsk.bsk_ntt)."""
        from helm_tpu_torch.ops import mb_pbs, ts_pbs

        def tile(params, G):
            dsk = self.keys[params.name][2]
            plan = mb_pbs.plan_for(dsk, G, kernel)
            ts = kernel == "blind_rotate_ts"
            copy = ts_pbs.ts_server_key(dsk).bsk if ts else mb_pbs.mb_server_key(dsk).bsk_k1
            staged = f", {('no', 'the forward', 'both')[plan.staged]} limb matrices staged" if ts else ""
            return (f"{plan.tiles} tiles of {plan.gt} gates, {plan.smem} B of shared memory a block{staged}, "
                    f"the chunked BSK copy {copy.numel() * copy.element_size()} B, the natural BSK "
                    f"{dsk.bsk_ntt.numel() * dsk.bsk_ntt.element_size()} B")

        return tile

    def phase_k6(self):
        from helm_tpu_torch import params as P
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.ops import ps_pbs

        # every set K1 is checked at, and the widths of the main paths K6
        # takes under HELM_TPU_MB_KERNEL=ps (c880-like levels of 8-32
        # slots, the AND batch) and of the LUT adder and chi-squared u32
        cases = (
            (P.TEST_PARAMS_K3, 7, (5, 37), False, (5, 37)),
            (P.TEST_PARAMS_MB4, 9, (5,), False, (5,)),
            (P.GATES_128_K3, 2024, (8, 16, 32, 37, 64, 128, 200, 256, 1024), False, (1024,)),
            (P.LUT_128_K2, 2025, (2, 256), True, ()),
            (P.ARITH_128_MB2, 2030, (8, 1024), True, ()),
        )
        return self._check_kernel(
            "blind_rotate_ps", "K6", pbs.blind_rotate_prime_split, ps_pbs.blind_rotate_ps,
            cases, ("gates_128_k3", 1024), detail=self._tile("blind_rotate_ps"),
        )

    #: the sets and widths K1 is checked at (phase k1), with the shapes
    #: where a kernel's own plain version runs on the card too: the tiny
    #: sets and GATES_128_K3 G=1024
    def _k1_cases(self):
        from helm_tpu_torch import params as P

        wide = (
            dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_n1024", N=1024),
            dataclasses.replace(P.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048),
            P.TEST_PARAMS_MB4,
        )
        return (
            (P.TEST_PARAMS_K3, 7, (5, 37), False, (5, 37)),
            *((w, 9, (5,), False, (5,)) for w in wide),
            (P.GATES_128_K3, 2024, (8, 16, 32, 37, 64, 128, 200, 256, 1024), False, (1024,)),
            (P.LUT_128_K2, 2025, (2, 256), True, ()),
            (P.LUT_128_MB2, 2032, (2, 256), True, ()),
            (P.ARITH_128_MB2, 2030, (8, 1024), True, ()),
        )

    def phase_k4(self):
        import numpy as np
        import torch

        from helm_tpu_torch import params as P
        from helm_tpu_torch.fhe import ntt, pbs
        from helm_tpu_torch.ops import ts_pbs

        # the transforms alone first (their tensor-core products, p =
        # 65537's data in three limbs against its scaled matrices in two at
        # N=2048), then the rotation at every set and width of phase k1 and
        # at a full-size grouping-4 set
        cases = (*self._k1_cases(), (P.GATES_TPU_MB4, 2031, (8,), False, (8,)))
        notes = []
        for params, seed, *_ in cases:
            _, _, dsk = self.keys_for(params, seed)
            N = params.N
            rng = np.random.default_rng(N)
            res = np.stack([rng.integers(0, p, size=(3, N)) for p in dsk.tab.primes], axis=1)
            x = torch.from_numpy(res.astype(np.int64)).to(self.device)
            fwd = ntt.ntt_fwd_four_step(x, N)
            got = ts_pbs.four_step_kernel(dsk, x)
            assert torch.equal(got, fwd), f"K4 forward four-step != ntt_fwd_four_step at {params.name}"
            got = ts_pbs.four_step_kernel(dsk, fwd, inverse=True)
            assert torch.equal(got, x), f"K4 inverse four-step != ntt_inv_four_step at {params.name}"
            notes.append(params.name)
        print(f"[k4] four-step transforms on the tensor cores == ntt.py at {', '.join(notes)}", flush=True)
        return self._check_kernel(
            "blind_rotate_ts", "K4", pbs.blind_rotate_transposed, ts_pbs.blind_rotate_ts,
            cases, ("gates_128_k3", 1024), detail=self._tile("blind_rotate_ts"),
        )

    def phase_k3(self):
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.ops import gm_pbs

        return self._check_kernel(
            "blind_rotate_gm", "K3", pbs.blind_rotate_ladder, gm_pbs.blind_rotate_gm,
            self._k1_cases(), ("gates_128_k3", 1024), detail=self._tile("blind_rotate_gm"),
        )

    def phase_k2(self):
        from helm_tpu_torch import params as P
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.ops import sb_pbs

        # TEST_PARAMS / TEST_PARAMS_LUT / the k=3 set take the 32-bit
        # accumulation path (PRIMES_512); GATES_TPU and GATES_PARAMS
        # (N=1024, PRIMES_1024) and LUT_PARAMS (N=2048, PRIMES) the 64-bit
        # one. LUT_PARAMS' 6 rows x 2048 words take 48 KB of shared memory a
        # gate, so its tiles hold 1-2 gates.
        # GATES_TPU at every width phase g1 gives K2: 1-4 slots (2-bit
        # adder, s27), 8-32 (c880-like), 64-256 (c880-like, 8 vectors),
        # 1024 (the AND batch); 37 is ragged. The LUT adder's levels are 2
        # slots wide. ARITH_PARAMS (N=2048, 6 rows): chi-squared's merged
        # rounds at grouping 1, narrow and wide
        k3_g1 = dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_g1", grouping=1)
        cases = (
            (P.TEST_PARAMS, 11, (5, 37), False, ()),
            (P.TEST_PARAMS_LUT, 12, (5,), True, ()),
            (k3_g1, 13, (5,), False, ()),
            (P.GATES_TPU, 2026, (1, 2, 4, 8, 16, 32, 37, 64, 128, 256, 1024), False, ()),
            (P.GATES_PARAMS, 2027, (37,), False, ()),
            (P.LUT_PARAMS, 2028, (2, 37), True, ()),
            (P.ARITH_PARAMS, 2033, (8, 1024), True, ()),
        )
        return self._check_kernel(
            "blind_rotate_sb", "K2", pbs.blind_rotate, sb_pbs.blind_rotate_sb,
            cases, ("gates_tpu_v32", 1024), detail=self._tile("blind_rotate_sb"),
        )

    def _and_batch(self, p, seed, G=1024, iters=5):
        import torch

        from helm_tpu_torch.fhe import lwe, pbs
        from helm_tpu_torch.fhe.ntt import to_host, words
        from helm_tpu_torch.ops import mb_pbs

        ck, _, dsk = self.keys_for(p, seed)
        lin, exp = _ands(ck, G, 0)
        x = words(lin, self.device)
        tv = words(pbs.gates_test_poly(p), self.device)
        out = mb_pbs.bootstrap(dsk, x, tv)
        got = lwe.decode_bool(lwe.decrypt_phase(ck, to_host(out)))
        assert (got == exp).all(), f"{p.name} G={G} AND batch decrypts wrong"
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = mb_pbs.bootstrap(dsk, x, tv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return f"{p.name} G={G} AND truth table ok; {G * iters / dt:.2f} bootstraps/s over {iters} batches"

    def phase_batch(self):
        from helm_tpu_torch import params as P

        return self._and_batch(P.GATES_128_K3, 2024)

    def _fused_vs_eager(self, fused, eager, wires, reps):
        """Evaluate `wires` with the eager engine (`reps` timed calls) and
        with the fused one (one warm-up call, which runs eagerly and
        captures, then `reps` timed graph replays); the replayed words must
        equal the eager ones on every wire but the plan's trash wire
        (tolerance 0), and each replay must add the graph's launches to the
        route's wrapper. Returns (fused words, eager s, fused s, first fused
        call s), the first two times the medians of the calls."""
        import numpy as np
        import torch

        from helm_tpu_torch.ops import mb_pbs

        assert fused.fused and not eager.fused, (fused.fused, eager.fused)

        def timed(eng):
            times = []
            for _ in range(reps):
                _sync()
                t0 = time.perf_counter()
                out = eng.evaluate(wires)
                _sync()
                times.append(time.perf_counter() - t0)
            return out, float(np.median(times))

        ref, t_eager = timed(eager)
        _sync()
        t0 = time.perf_counter()
        fused.evaluate(wires)  # the eager run and the capture
        _sync()
        t_first = time.perf_counter() - t0
        rotation = mb_pbs.blind_rotation(fused.params)
        n0, r0 = rotation.launches, fused.replays
        got, t_fused = timed(fused)
        pbs_levels = sum(1 for lp in fused.plan.levels if lp.num_slots)
        assert fused.replays == r0 + reps, "the fused engine did not replay its graph"
        assert rotation.launches - n0 == reps * pbs_levels, (
            f"{rotation.__name__}: {rotation.launches - n0} launches counted over {reps} replays "
            f"of {pbs_levels} PBS levels"
        )
        real = fused.plan.num_wires - 1  # the trash wire is the last
        if not torch.equal(got[..., :real, :], ref[..., :real, :]):
            bad = (got[..., :real, :] != ref[..., :real, :]).nonzero()[0].tolist()
            raise AssertionError(f"graph replay != eager at {bad}")
        return got, t_eager, t_fused, t_first

    def _c880(self, p, seed):
        import numpy as np

        from helm_tpu_torch import BooleanEngine

        ck, sk, _ = self.keys_for(p, seed)
        nl = _netlist("c880-like.v")
        fused = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device)
        eager = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=False)
        fused.compile(nl)
        eager.compile(nl)
        assert fused.fused, f"{p.name}: the auto-rule did not fuse c880-like"
        inputs = _golden("c880-like.inputs.csv")
        wires, te, tf, t1 = self._fused_vs_eager(fused, eager, fused.encrypt_inputs(inputs), 3)
        got = fused.decrypt_outputs(wires)
        assert got == _golden("c880-like.outputs.csv"), f"{p.name}: c880-like differs from the golden CSV"
        assert got == _oracle(nl, inputs), f"{p.name}: c880-like differs from the oracle"
        rng = np.random.default_rng(8)
        vecs = [{w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)} for _ in range(8)]
        wires, tbe, tbf, tb1 = self._fused_vs_eager(fused, eager, fused.encrypt_inputs(vecs), 2)
        for i, (m, o) in enumerate(zip(vecs, fused.decrypt_outputs(wires))):
            assert o == _oracle(nl, m), f"{p.name}: c880-like batch vector {i} differs from the oracle"
        return (
            f"{p.name} c880-like golden CSV + oracle ok, graph replay == eager (tolerance 0): "
            f"fused {tf:.6f} s/vector, eager {te:.6f} s/vector (medians of 3; the first fused call, "
            f"eager run + capture, {t1:.6f} s); batch of 8 ok, fused {tbf / 8:.6f} s/vector, eager "
            f"{tbe / 8:.6f} s/vector (medians of 2; first fused call {tb1:.6f} s)"
        )

    def phase_c880(self):
        from helm_tpu_torch import params as P

        return self._c880(P.GATES_128_K3, 2024)

    def phase_g1(self):
        import torch

        from helm_tpu_torch import BooleanEngine
        from helm_tpu_torch import params as P
        from helm_tpu_torch.ops import sb_pbs

        p = P.GATES_TPU
        ck, sk, _ = self.keys_for(p, 2026)
        notes = []
        nl = _netlist("2-bit-adder.v")
        eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device)
        eng.compile(nl)
        inputs = _golden("2-bit-adder.inputs.csv")
        _sync()
        t0 = time.perf_counter()
        got = eng.decrypt_outputs(eng.evaluate(eng.encrypt_inputs(inputs)))
        dt = time.perf_counter() - t0
        assert got == _golden("2-bit-adder.outputs.csv"), f"2-bit-adder at {p.name} differs from its golden CSV"
        assert got == _oracle(nl, inputs), "2-bit-adder differs from the oracle"
        notes.append(f"2-bit-adder x1 golden CSV + oracle ok ({dt:.6f} s)")

        # s27 x 3: all cycles in one graph (evaluate_cycles), against three
        # eager evaluate calls on the same wires
        nl = _netlist("s27.v")
        fused = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=True)
        eager = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=False)
        fused.compile(nl)
        eager.compile(nl)
        inputs = _golden("s27.inputs.csv")
        w0 = fused.encrypt_inputs(inputs)
        _sync()
        t0 = time.perf_counter()
        ref = w0
        for _ in range(3):
            ref = eager.evaluate(ref)
        _sync()
        te = time.perf_counter() - t0
        fused.evaluate_cycles(w0, 3)  # the eager run and the capture
        n0, r0 = sb_pbs.blind_rotate_sb.launches, fused.replays
        _sync()
        t0 = time.perf_counter()
        got = fused.evaluate_cycles(w0, 3)
        _sync()
        tf = time.perf_counter() - t0
        pbs_levels = sum(1 for lp in fused.plan.levels if lp.num_slots)
        assert fused.replays == r0 + 1, "s27 x3: evaluate_cycles did not replay its graph"
        assert sb_pbs.blind_rotate_sb.launches - n0 == 3 * pbs_levels, "s27 x3: K2 launches per replay"
        real = fused.plan.num_wires - 1
        assert torch.equal(got[:real], ref[:real]), "s27 x3: graph replay != three eager evaluate calls"
        out = fused.decrypt_outputs(got)
        assert out == _golden("s27_3cycles.outputs.csv"), f"s27 x3 at {p.name} differs from s27_3cycles.outputs.csv"
        assert out == _oracle(nl, inputs, 3), "s27 x3 differs from the oracle"
        notes.append(
            f"s27 x3 golden CSV + oracle ok, one graph replay of 3 x {len(fused.plan.levels)} levels == "
            f"3 eager evaluate calls (tolerance 0): fused {tf / 3:.6f} s/cycle, eager {te / 3:.6f} s/cycle"
        )
        notes.append(self._c880(p, 2026))
        notes.append(self._and_batch(p, 2026))
        return "; ".join(notes)

    def phase_lut(self):
        from helm_tpu_torch import BooleanEngine
        from helm_tpu_torch import params as P

        nl = _netlist("8-bit-adder-lut-3-1.v")
        inputs = _golden("8-bit-adder.inputs.csv")
        golden = _golden("8-bit-adder-lut-3-1.outputs.csv")
        exp = _oracle(nl, inputs)
        notes = []
        for p, seed in ((P.LUT_PARAMS, 2028), (P.LUT_128_K2, 2025)):
            ck, sk, _ = self.keys_for(p, seed)
            fused = BooleanEngine(mode="lut", params=p, keys=(ck, sk), device=self.device)
            eager = BooleanEngine(mode="lut", params=p, keys=(ck, sk), device=self.device, fuse_levels=False)
            fused.compile(nl)
            eager.compile(nl)
            assert fused.fused, f"{p.name}: the auto-rule did not fuse the LUT adder"
            wires, te, tf, t1 = self._fused_vs_eager(fused, eager, fused.encrypt_inputs(inputs), 3)
            got = fused.decrypt_outputs(wires)
            assert _same(got, golden), f"LUT adder at {p.name} differs from the golden CSV: {got}"
            assert _same(got, exp), f"LUT adder at {p.name} differs from the oracle"
            notes.append(
                f"{p.name} (grouping {p.grouping}) golden CSV + oracle ok, graph replay == eager "
                f"(tolerance 0): fused {tf:.6f} s/vector, eager {te:.6f} s/vector (medians of 3; "
                f"first fused call {t1:.6f} s)"
            )
        return "8-bit-adder-lut-3-1: " + "; ".join(notes)

    def phase_arith(self):
        import numpy as np

        from helm_tpu_torch import ArithEngine
        from helm_tpu_torch import params as P
        from helm_tpu_torch.engines import radix
        from helm_tpu_torch.ops import sb_pbs

        p = P.ARITH_128_MB2
        ck, sk, _ = self.keys_for(p, 2030)
        nl = _netlist("chi_squared_arith.v", arith=True)
        eng = ArithEngine("u32", params=p, keys=(ck, sk), device=self.device)
        eng.compile(nl)
        sets = [
            (_golden(f"chi_squared_arith_{i}.inputs.csv", "u32"),
             _golden(f"chi_squared_arith_{i}.outputs.csv", "u32"))
            for i in range(1, 5)
        ]

        def run(inputs):
            wires = eng.encrypt_inputs(inputs)
            l0, s0 = radix.LAUNCHES[0], radix.SLOTS[0]
            _sync()
            t0 = time.perf_counter()
            out = eng.evaluate(wires)
            _sync()
            dt = time.perf_counter() - t0
            return eng.decrypt_outputs(out), dt, radix.LAUNCHES[0] - l0, radix.SLOTS[0] - s0

        notes = []
        times = []
        for i, (inputs, golden) in enumerate(sets, 1):
            got, dt, rounds, slots = run(inputs)
            assert got == golden, f"chi-squared u32 set {i} {got} != golden {golden}"
            assert got == _oracle_arith(nl, inputs, 32), f"chi-squared u32 set {i} differs from the oracle"
            times.append(dt)
            notes.append(f"set {i}: {dt:.6f} s, {rounds} merged rounds, {slots} slots")
        got, dt, rounds, slots = run([inputs for inputs, _ in sets])
        for i, (g, (_, golden)) in enumerate(zip(got, sets), 1):
            assert g == golden, f"chi-squared u32 batch vector {i} {g} != golden {golden}"
        msg = (
            f"{p.name} chi_squared u32, golden CSVs + oracle ok: {float(np.mean(times)):.6f} s/vector "
            f"one at a time ({'; '.join(notes)}); batch of 4 ok, {dt / 4:.6f} s/vector, "
            f"{rounds} merged rounds, {slots} slots"
        )
        # grouping 1 (K2): the reference's tfhe-rs-mirroring arith set
        p = P.ARITH_PARAMS
        ck, sk, _ = self.keys_for(p, 2033)
        eng = ArithEngine("u32", params=p, keys=(ck, sk), device=self.device)
        eng.compile(nl)
        inputs, golden = sets[0]
        n0 = sb_pbs.blind_rotate_sb.launches
        got, dt, rounds, slots = run(inputs)
        assert got == golden, f"chi-squared u32 set 1 at {p.name} {got} != golden {golden}"
        assert got == _oracle_arith(nl, inputs, 32), f"chi-squared u32 set 1 at {p.name} differs from the oracle"
        assert sb_pbs.blind_rotate_sb.launches - n0 == rounds, f"{p.name}: K2 launches != merged rounds"
        return msg + (f"; {p.name} (grouping 1, K2) set 1 golden CSV + oracle ok: {dt:.6f} s/vector, "
                      f"{rounds} merged rounds, {slots} slots")

    def phase_baseline(self):
        """helm_tpu_torch.tools.verify_baseline.main([]) in process (so the
        launch counters see it), with the keys made so far: the five
        BASELINE configs on the card at GATES_128_K3, LUT_128_MB2 and
        ARITH_128_MB2 must print ALL BIT-EXACT and return 0."""
        import io
        import re

        from helm_tpu_torch.tools import verify_baseline

        # the keys of phases k1 and arith where a set repeats (the tool draws
        # the others from its own seed)
        keys = {name: (ck, sk) for name, (ck, sk, _) in self.keys.items()}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = verify_baseline.main([], keys)
        out = buf.getvalue()
        print(out, end="", flush=True)
        assert rc == 0, f"verify_baseline exited {rc}"
        assert out.strip().splitlines()[-1] == "ALL BIT-EXACT", "verify_baseline did not print ALL BIT-EXACT"
        secs = re.findall(r"^    \((\w+), \w+, ([0-9.]+)s\)$", out, re.M)
        names = ("2-bit-adder", "s27 x3", "8-bit-adder-lut-3-1", "c880-like", "chi_squared u32 x4")
        assert len(secs) == len(names), secs
        return "verify_baseline ALL BIT-EXACT; seconds per config (keygen included where a set is new): " + ", ".join(
            f"{n} {t} s ({ps})" for n, (ps, t) in zip(names, secs)
        )

    def phase_ps(self):
        from helm_tpu_torch import params as P
        from helm_tpu_torch.ops import mb_pbs, ps_pbs

        notes = []
        with _mb_kernel("ps"):
            assert mb_pbs.mb_kernel() == "ps"
            notes.append(self._and_batch(P.GATES_128_K3, 2024))
            notes.append(self._c880(P.GATES_128_K3, 2024))
        k6 = ps_pbs.blind_rotate_ps.launches
        assert k6 > 0, "HELM_TPU_MB_KERNEL=ps never launched K6"
        assert mb_pbs.blind_rotate_mb.launches == 0, "HELM_TPU_MB_KERNEL=ps launched K1"
        notes.append(f"K6 launches {k6}, K1 launches 0")
        with _mb_kernel("hb2"):
            notes.append("hb2: " + self._and_batch(P.GATES_128_K3, 2024, G=37, iters=1))
        assert mb_pbs.blind_rotate_mb.launches > 0, "HELM_TPU_MB_KERNEL=hb2 never launched K1"
        assert ps_pbs.blind_rotate_ps.launches == k6, "HELM_TPU_MB_KERNEL=hb2 launched K6"
        return "HELM_TPU_MB_KERNEL=ps: " + "; ".join(notes)

    def phase_serve(self):
        """The daemon in process under HELM_TPU_MB_KERNEL=ts (K4): c880-like
        at GATES_128_K3 (the golden vector and 7 from a numpy seed, two
        batches of 4) and chi-squared u32 at ARITH_128_MB2 (the four
        recorded vectors, one batch of 4); every output against its golden
        CSV or the oracle, every input moved to done/."""
        import io
        import re
        import shutil

        from helm_tpu_torch import serve
        from helm_tpu_torch.io import csv_io
        from helm_tpu_torch.ops import mb_pbs

        def run(argv, watch):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(argv)
            out = buf.getvalue()
            print(out, end="", flush=True)
            assert rc == 0, f"serve exited {rc}"
            assert not [f for f in os.listdir(watch) if f.endswith(".csv")], "inputs left in the watch dir"
            assert not os.path.exists(os.path.join(watch, "failed")), "serve quarantined an input"
            return re.findall(r"\(([0-9.]+)s/vector(, graph replay)?\)", out)

        notes = []
        with _mb_kernel("ts"), tempfile.TemporaryDirectory() as td:
            import numpy as np

            nl = _netlist("c880-like.v")
            watch, outd = os.path.join(td, "c880"), os.path.join(td, "c880_out")
            os.makedirs(watch)
            golden_in = os.path.join(ROOT, "benchmarks/test-cases/c880-like.inputs.csv")
            shutil.copy(golden_in, os.path.join(watch, "v0.csv"))
            rng = np.random.default_rng(8)
            vecs = {"v0": _golden("c880-like.inputs.csv")}
            for i in range(1, 8):
                vecs[f"v{i}"] = {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}
                with open(os.path.join(watch, f"v{i}.csv"), "w") as f:
                    f.write("wire,value\n" + "".join(f"{w},{int(v)}\n" for w, v in vecs[f"v{i}"].items()))
            per = run(["-v", os.path.join(ROOT, "benchmarks/netlists/c880-like.v"), "--watch", watch,
                       "--outdir", outd, "--params", "gates_128_k3", "--seed", "2024", "--batch", "4",
                       "--max-batches", "2", "--fuse-levels", "--device", self.device], watch)
            # the first batch runs eagerly and captures; the second is a replay
            assert [bool(r) for _, r in per] == [False, True], f"serve --fuse-levels batches: {per}"
            for name, vec in vecs.items():
                got = csv_io.read_input_wires(os.path.join(outd, f"{name}.out.csv"), "bool")
                assert got == _oracle(nl, vec), f"serve c880-like {name} differs from the oracle"
            got = csv_io.read_input_wires(os.path.join(outd, "v0.out.csv"), "bool")
            assert got == _golden("c880-like.outputs.csv"), "serve c880-like differs from the golden CSV"
            notes.append(f"gates_128_k3 c880-like --fuse-levels, 8 requests in 2 batches of 4 (the "
                         f"second one graph replay), golden CSV + oracle ok: s/vector per batch "
                         f"{[float(t) for t, _ in per]}")

            anl = _netlist("chi_squared_arith.v", arith=True)
            watch, outd = os.path.join(td, "chi"), os.path.join(td, "chi_out")
            os.makedirs(watch)
            for i in range(1, 5):
                shutil.copy(os.path.join(ROOT, f"benchmarks/test-cases/chi_squared_arith_{i}.inputs.csv"),
                            os.path.join(watch, f"chi{i}.csv"))
            per = run(["-v", os.path.join(ROOT, "benchmarks/netlists/chi_squared_arith.v"), "-a", "u32",
                       "--watch", watch, "--outdir", outd, "--params", "arith_128_mb2", "--seed", "2030",
                       "--batch", "4", "--max-batches", "1", "--device", self.device], watch)
            for i in range(1, 5):
                got = csv_io.read_input_wires(os.path.join(outd, f"chi{i}.out.csv"), "u32")
                inputs = _golden(f"chi_squared_arith_{i}.inputs.csv", "u32")
                assert got == _golden(f"chi_squared_arith_{i}.outputs.csv", "u32"), f"serve chi-squared {i} != golden"
                assert got == _oracle_arith(anl, inputs, 32), f"serve chi-squared {i} differs from the oracle"
            notes.append(f"arith_128_mb2 chi-squared u32, the 4 recorded vectors in 1 batch, golden CSVs + "
                         f"oracle ok: s/vector per batch {[float(t) for t, _ in per]}")
        from helm_tpu_torch.ops import ts_pbs

        assert ts_pbs.blind_rotate_ts.launches > 0, "serve under HELM_TPU_MB_KERNEL=ts never launched K4"
        assert mb_pbs.blind_rotate_mb.launches == 0, "serve under HELM_TPU_MB_KERNEL=ts launched K1"
        return "python -m helm_tpu_torch.serve under HELM_TPU_MB_KERNEL=ts: " + "; ".join(notes) + (
            "; " + self._serve_auto())

    def _serve_auto(self):
        """--batch auto under the default kernel (K1): first the cost model
        beside the fused engine's measured s/vector, then the daemon on two
        batches' worth of c880-like requests, which must pick the model's
        batch."""
        import io
        import re

        from helm_tpu_torch import serve
        from helm_tpu_torch.io import csv_io
        from helm_tpu_torch.ops import mb_pbs

        best = self._batch_table()
        with tempfile.TemporaryDirectory() as td:
            watch, outd = os.path.join(td, "in"), os.path.join(td, "out")
            os.makedirs(watch)
            vecs = self._c880_requests(2 * best)
            for i, vec in enumerate(vecs):
                with open(os.path.join(watch, f"r{i:02d}.csv"), "w") as f:
                    f.write("wire,value\n" + "".join(f"{w},{int(v)}\n" for w, v in vec.items()))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(["-v", os.path.join(ROOT, "benchmarks/netlists/c880-like.v"), "--watch", watch,
                                 "--outdir", outd, "--params", "gates_128_k3", "--seed", "2024",
                                 "--batch", "auto", "--max-batch", "16",
                                 "--max-batches", "2", "--device", self.device])
            out = buf.getvalue()
            print(out, end="", flush=True)
            assert rc == 0, f"serve --batch auto exited {rc}"
            chosen = re.findall(r"--batch auto -> (\d+) \(([0-9]+)% fill", out)
            assert chosen and int(chosen[0][0]) == best, f"serve --batch auto chose {chosen}, the model {best}"
            assert not [f for f in os.listdir(watch) if f.endswith(".csv")], "inputs left in the watch dir"
            nl = _netlist("c880-like.v")
            for i, vec in enumerate(vecs):
                got = csv_io.read_input_wires(os.path.join(outd, f"r{i:02d}.out.csv"), "bool")
                assert got == _oracle(nl, vec), f"serve --batch auto request {i} differs from the oracle"
            got = csv_io.read_input_wires(os.path.join(outd, "r00.out.csv"), "bool")
            assert got == _golden("c880-like.outputs.csv"), "serve --batch auto differs from the golden CSV"
            per = re.findall(r"\(([0-9.]+)s/vector(, graph replay)?\)", out)
            assert [bool(r) for _, r in per] == [False, True], f"serve --batch auto batches: {per}"
        assert mb_pbs.blind_rotate_mb.launches > 0, "serve --batch auto never launched K1"
        return (f"--batch auto --max-batch 16 on {len(vecs)} c880-like requests: batch {best} ({chosen[0][1]}% "
                f"fill), the second batch one graph replay, golden CSV + oracle ok, s/vector per batch "
                f"{[float(t) for t, _ in per]}")

    def _c880_requests(self, n):
        """c880-like's golden input vector and n - 1 from a numpy seed (the
        first 16 are those of the calibration table)."""
        import numpy as np

        nl = _netlist("c880-like.v")
        rng = np.random.default_rng(16)
        return [_golden("c880-like.inputs.csv")] + [
            {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)} for _ in range(n - 1)
        ]

    def _batch_table(self):
        """The fused c880-like engine at GATES_128_K3 (K1) at B = 1, 2, 4,
        7, 8, 12, 16 and the model's choice (7: the model puts it below 8):
        the measured s/vector (the median
        of 3 graph replays after the capturing call; every output against the
        oracle) beside the cost model's, the model's constants fitted to the
        measurement, and the model's choice (returned) beside the measured
        best."""
        import numpy as np

        from helm_tpu_torch import BooleanEngine, batching
        from helm_tpu_torch import params as P

        p = P.GATES_128_K3
        ck, sk, _ = self.keys_for(p, 2024)
        nl = _netlist("c880-like.v")
        eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device)
        eng.compile(nl)
        assert eng.fused, "the auto-rule did not fuse c880-like"
        vecs = self._c880_requests(16)
        best, table = batching.suggest_batch(eng, 16)
        measured, launches = {}, {}
        for B in sorted({1, 2, 4, 7, 8, 12, 16, best}):
            wires = eng.encrypt_inputs(vecs[:B])
            eng.evaluate(wires)  # the eager run and the capture
            times = []
            for _ in range(3):
                _sync()
                t0 = time.perf_counter()
                out = eng.evaluate(wires)
                _sync()
                times.append(time.perf_counter() - t0)
            for i, o in enumerate(eng.decrypt_outputs(out)):
                assert o == _oracle(nl, vecs[i]), f"c880-like at batch {B}, vector {i}, differs from the oracle"
            measured[B] = float(np.median(times)) / B
            launches[B] = batching.engine_launches(eng, B)
        gate_s, ks, level = batching.calibrate(launches, measured)
        lines = ["| B | measured s/vector | model gate-times/vector | model s/vector | fill | refit s/vector |",
                 "|---|---|---|---|---|---|"]
        for B, m in measured.items():
            cost, fill = batching.plan_cost(launches[B], B)
            refit, _ = batching.plan_cost(launches[B], B, ks, level)
            lines.append(f"| {B} | {m:.6f} | {cost:.4f} | {cost * batching.GATE_S:.6f} | {fill:.3f} | "
                         f"{refit * gate_s:.6f} |")
        print("\n".join(lines), flush=True)
        fastest = min(measured, key=measured.get)
        ratio = measured[best] / measured[fastest]
        print(f"[serve] cost model: KS_GATE_TIMES {batching.KS_GATE_TIMES}, LEVEL_GATE_TIMES "
              f"{batching.LEVEL_GATE_TIMES}, GATE_S {batching.GATE_S}; fitted to this table: gate-time "
              f"{gate_s:.6e} s, KS_GATE_TIMES {ks:.6f}, LEVEL_GATE_TIMES {level:.6f}; clusters a wave "
              f"{sorted({x.slots for xs in launches.values() for x in xs})}; the model picks batch {best} "
              f"(of 1..16: {[(t['batch'], t['cost_per_vector']) for t in table]}), the measured best of the "
              f"table is {fastest} (the pick's s/vector {ratio:.3f}x the best's)", flush=True)
        return best

    def phase_sweep(self):
        """helm_tpu_torch.tools.mb_sweep at GATES_128_K3 for the four
        multi-bit kernels (LAYOUT fs: K1, ps: K6, ts: K4, gm: K3)."""
        from helm_tpu_torch import params as P
        from helm_tpu_torch.tools import mb_sweep

        ck, _, dsk = self.keys_for(P.GATES_128_K3, 2024)
        widths = (8, 64, 1024)
        table = {}
        for layout in ("fs", "ps", "ts", "gm"):
            table[layout] = [mb_sweep.sweep(dsk, ck, layout, G, [32])[0] for G in widths]
        lines = ["| LAYOUT (kernel) | " + " | ".join(f"G={G} rot/s" for G in widths) + " |",
                 "|---|" + "---|" * len(widths)]
        names = {"fs": "fs (K1)", "ps": "ps (K6)", "ts": "ts (K4)", "gm": "gm (K3)"}
        for layout, rates in table.items():
            lines.append(f"| {names[layout]} | " + " | ".join(f"{r:.1f}" for r in rates) + " |")
        print("\n".join(lines), flush=True)
        return "gates_128_k3 mb_sweep table printed above (rot/s, 6 timed rotations each)"

    def phase_profile(self):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from helm_tpu_torch import BooleanEngine
        from helm_tpu_torch import params as P
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.fhe.ntt import words
        from helm_tpu_torch.ops import mb_pbs

        pbs_levels = {}

        def c880_vector(p, seed, fuse=False):
            ck, sk, _ = self.keys_for(p, seed)
            eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=fuse)
            eng.compile(_netlist("c880-like.v"))
            vec = eng.encrypt_inputs(_golden("c880-like.inputs.csv"))
            fn = lambda: eng.evaluate(vec)  # noqa: E731
            if fuse:  # the untimed call before the window captures; the window replays
                pbs_levels[fn] = sum(1 for lp in eng.plan.levels if lp.num_slots)
            return fn

        def under_ps(fn):
            def run():
                with _mb_kernel("ps"):
                    return fn()

            return run

        def under_ts(fn):
            def run():
                with _mb_kernel("ts"):
                    return fn()

            return run

        def chi_squared_vector(p, seed):
            from helm_tpu_torch import ArithEngine

            ck, sk, _ = self.keys_for(p, seed)
            eng = ArithEngine("u32", params=p, keys=(ck, sk), device=self.device)
            eng.compile(_netlist("chi_squared_arith.v", arith=True))
            vec = eng.encrypt_inputs(_golden("chi_squared_arith_1.inputs.csv", "u32"))
            return lambda: eng.evaluate(vec)

        p = P.GATES_128_K3
        ck, _, dsk = self.keys_for(p, 2024)
        lin, _ = _ands(ck, 1024, 0)
        x = words(lin, self.device)
        tv = words(pbs.gates_test_poly(p), self.device)
        runs = {
            "gates_128_k3 batch1024": lambda: mb_pbs.bootstrap(dsk, x, tv),
            "gates_128_k3 c880_vector": c880_vector(p, 2024),
            "gates_128_k3 c880_vector fused": c880_vector(p, 2024, True),
            "gates_128_k3 c880_vector under ps": under_ps(c880_vector(p, 2024)),
            "gates_128_k3 batch1024 under ts": under_ts(lambda: mb_pbs.bootstrap(dsk, x, tv)),
            "gates_tpu_v32 c880_vector": c880_vector(P.GATES_TPU, 2026),
            "gates_tpu_v32 c880_vector fused": c880_vector(P.GATES_TPU, 2026, True),
            "arith_128_mb2 chi_squared_u32_vector": chi_squared_vector(P.ARITH_128_MB2, 2030),
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
            if name.endswith("under ts"):  # K4: one launch of the tile body per rotation
                names = [k for _, k, _ in rows]
                assert not [k for k in names if "rotate_group_ts" in k or "crt_accumulate" in k], names
                assert [c for _, k, c in rows if "rotate_tiles" in k] == [1], rows
            if fn in pbs_levels:  # a graph replay: its kernels are in the trace, one rotation a level
                assert [c for _, k, c in rows if "rotate_tiles" in k] == [pbs_levels[fn]], rows
        return f"{len(notes)} windows profiled"

    def phase_bench(self):
        """python -m helm_tpu_torch.bench in a subprocess, at its defaults
        but BENCH_MEDIAN_N=3 and no key cache (writing the compressed key
        files takes longer than the keygen): its two JSON lines, the
        circuit's first and the bootstrap rate last."""
        res = subprocess.run(
            [sys.executable, "-m", "helm_tpu_torch.bench"],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
            env={**os.environ, "BENCH_MEDIAN_N": "3", "BENCH_KEY_CACHE": ""},
        )
        if res.returncode != 0:
            raise AssertionError(f"bench failed ({res.returncode}):\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        print(res.stderr.strip(), flush=True)
        lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
        assert [x["metric"] for x in lines] == [
            "c880-like_wall_clock_per_vector", "gate_bootstraps_per_sec_per_chip"
        ], lines
        assert res.stdout.strip().splitlines()[-1].startswith('{"metric": "gate_bootstraps_per_sec_per_chip"')
        for x in lines:
            print(f"[bench] {json.dumps(x)}", flush=True)
        circuit, rate = lines
        return (f"c880-like {circuit['value']} s/vector (levels fused: {circuit['levels_fused']}), "
                f"{rate['value']} bootstraps/s, on {rate['capture']}")

    def _mesh_cli(self, argv, nprocs, tag, outdir):
        """`nprocs` CLI processes under --multihost (--mesh nprocs), started
        now, each writing -o to outdir/<tag>.<pid>.csv; returns (tag, pid,
        Popen) per process."""
        coordinator = f"127.0.0.1:{_free_port()}"
        return [
            (tag, pid, subprocess.Popen(
                [sys.executable, "-m", "helm_tpu_torch.cli", *argv, "--device", self.device,
                 "--multihost", f"{coordinator},{nprocs},{pid}", "--mesh", str(nprocs),
                 "-o", os.path.join(outdir, f"{tag}.{pid}.csv")],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for pid in range(nprocs)
        ]

    def phase_mesh(self):
        """Gate sharding (helm_tpu_torch/parallel/mesh.py) on the card:
        four shards of cuda:0 against the unsharded engines (tolerance 0,
        real wires); the dryrun; a process group at world size 1 on NCCL
        (the CLI, and a fused engine whose replayed graph holds its
        all-gathers) and two processes on gloo over the one card; across
        cards when the machine has several."""
        import io
        import re
        import shutil

        import numpy as np
        import torch

        from helm_tpu_torch import ArithEngine, BooleanEngine
        from helm_tpu_torch import params as P
        from helm_tpu_torch.fhe.ntt import words
        from helm_tpu_torch.fhe import pbs
        from helm_tpu_torch.io import csv_io
        from helm_tpu_torch.ops import mb_pbs
        from helm_tpu_torch.parallel import distributed, dryrun
        from helm_tpu_torch.parallel import mesh as M

        dev0 = torch.device(self.device, 0)
        notes = []
        td = tempfile.mkdtemp(prefix="mesh-")
        # the subprocesses first, so that their keygen overlaps the rest
        c880_argv = ["-v", "benchmarks/netlists/c880-like.v", "-i", "benchmarks/test-cases/c880-like.inputs.csv",
                     "--fuse-levels", "-p"]
        adder_argv = ["-v", "benchmarks/netlists/2-bit-adder.v", "-i", "benchmarks/test-cases/2-bit-adder.inputs.csv"]
        procs = self._mesh_cli(c880_argv, 1, "nccl1-c880", td)
        procs += self._mesh_cli(adder_argv, 2, "gloo2-adder", td)
        try:
            def shard(eng, mesh):
                eng.set_sharding(M.batch_sharding(mesh), M.replicated(mesh))
                return mesh

            def four():
                return M.GateMesh([dev0] * 4)

            def timed(eng, wires, reps):
                times = []
                for _ in range(reps):
                    _sync()
                    t0 = time.perf_counter()
                    out = eng.evaluate(wires)
                    _sync()
                    times.append(time.perf_counter() - t0)
                return out, float(np.median(times))

            def same(got, ref, n_wires, what):
                real = n_wires - 1  # the trash wire is the last
                if not torch.equal(got[..., :real, :], ref[..., :real, :]):
                    bad = (got[..., :real, :] != ref[..., :real, :]).nonzero()[0].tolist()
                    raise AssertionError(f"{what}: sharded != unsharded at {bad}")

            # c880-like at GATES_128_K3 (K1): four shards, eager and fused
            p = P.GATES_128_K3
            ck, sk, _ = self.keys_for(p, 2024)
            nl = _netlist("c880-like.v")
            inputs = _golden("c880-like.inputs.csv")
            engines = {}
            for name, fuse, mesh in (("unsharded eager", False, None), ("unsharded fused", True, None),
                                     ("4 shards eager", False, four()), ("4 shards fused", True, four())):
                eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=fuse)
                if mesh is not None:
                    shard(eng, mesh)
                eng.compile(nl)
                engines[name] = eng
            c880_wires = engines["unsharded eager"].encrypt_inputs(inputs)
            words_of, secs = {}, {}
            for name, eng in engines.items():
                if eng.fused:
                    eng.evaluate(c880_wires)  # the eager run and the capture
                words_of[name], secs[name] = timed(eng, c880_wires, 3)
            ref = words_of["unsharded eager"]
            for name, got in words_of.items():
                same(got, ref, engines[name].plan.num_wires, f"c880-like {name}")
            out = engines["4 shards fused"].decrypt_outputs(words_of["4 shards fused"])
            assert out == _golden("c880-like.outputs.csv"), "sharded c880-like differs from the golden CSV"
            assert engines["4 shards fused"].replays == 3
            per_shard = engines["4 shards fused"].mesh.launches
            assert all(c > 0 for c in per_shard), f"a shard never launched K1: {per_shard}"
            notes.append(
                "c880-like GATES_128_K3 on 4 shards of cuda:0 == unsharded (tolerance 0), golden CSV ok: "
                + ", ".join(f"{k} {v:.6f} s/vector" for k, v in secs.items())
                + f" (medians of 3); K1 launches per shard (fused: capture run + 3 replays) {per_shard}"
            )

            # the G=1024 AND batch under fs (K1), ps (K6) and ts (K4), and at
            # GATES_TPU (K2): one sharded batch against one launch
            for params, seed, kernels in ((p, 2024, ("fs", "ps", "ts")), (P.GATES_TPU, 2026, ("fs",))):
                ck2, _, dsk = self.keys_for(params, seed)
                lin, _ = _ands(ck2, 1024, 0)
                x = words(lin, self.device)
                tv = words(pbs.gates_test_poly(params), self.device)
                for kn in kernels:
                    with _mb_kernel(kn):
                        mesh = four()
                        one_ms, one = _time_ms(lambda: mb_pbs.bootstrap(dsk, x, tv))
                        m_ms, got = _time_ms(lambda: M.bootstrap_sharded(mesh, dsk, x, tv))
                    assert torch.equal(got, one), f"{params.name} {kn}: 4 shards != one launch"
                    route = mb_pbs.blind_rotation(params).__name__ if kn == "fs" else kn
                    notes.append(f"{params.name} G=1024 AND batch, {route}: 4 shards == one launch (tolerance 0), "
                                 f"{m_ms:.3f} ms sharded, {one_ms:.3f} ms one launch; launches per shard "
                                 f"{mesh.launches}")

            # the LUT adder at LUT_128_K2 (K1), fused, per-slot test polynomials
            p = P.LUT_128_K2
            ck, sk, _ = self.keys_for(p, 2025)
            nl = _netlist("8-bit-adder-lut-3-1.v")
            base = BooleanEngine(mode="lut", params=p, keys=(ck, sk), device=self.device)
            sharded = BooleanEngine(mode="lut", params=p, keys=(ck, sk), device=self.device)
            mesh = shard(sharded, four())
            base.compile(nl)
            sharded.compile(nl)
            wires = base.encrypt_inputs(_golden("8-bit-adder.inputs.csv"))
            base.evaluate(wires)
            sharded.evaluate(wires)
            ref, t_one = timed(base, wires, 3)
            got, t_four = timed(sharded, wires, 3)
            same(got, ref, sharded.plan.num_wires, "LUT adder")
            assert _same(sharded.decrypt_outputs(got), _golden("8-bit-adder-lut-3-1.outputs.csv"))
            notes.append(f"LUT adder LUT_128_K2 fused on 4 shards == unsharded, golden CSV ok: {t_four:.6f} s/vector "
                         f"sharded, {t_one:.6f} unsharded; launches per shard {mesh.launches}")

            # chi-squared u32 at ARITH_128_MB2 (K1), one vector
            p = P.ARITH_128_MB2
            ck, sk, _ = self.keys_for(p, 2030)
            nl = _netlist("chi_squared_arith.v", arith=True)
            inputs = _golden("chi_squared_arith_1.inputs.csv", "u32")
            eng = ArithEngine("u32", params=p, keys=(ck, sk), device=self.device)
            eng.compile(nl)
            wires = eng.encrypt_inputs(inputs)
            _sync()
            t0 = time.perf_counter()
            ref = eng.evaluate(wires)
            _sync()
            t_one = time.perf_counter() - t0
            mesh = shard(eng, four())
            _sync()
            t0 = time.perf_counter()
            got = eng.evaluate(wires)
            _sync()
            t_four = time.perf_counter() - t0
            assert torch.equal(got, ref), "chi-squared u32: 4 shards != unsharded"
            assert eng.decrypt_outputs(got) == _golden("chi_squared_arith_1.outputs.csv", "u32")
            notes.append(f"chi-squared u32 ARITH_128_MB2 on 4 shards == unsharded, golden CSV ok: {t_four:.6f} s/vector "
                         f"sharded, {t_one:.6f} unsharded; launches per shard {mesh.launches}")

            # the dryrun's four checks on four shards of the card
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                dryrun.dryrun_multichip(4, self.device, devices=[dev0] * 4)
            lines = buf.getvalue().strip().splitlines()
            print("\n".join(lines), flush=True)
            assert len(lines) == 4, lines
            notes.append("dryrun_multichip(4) on 4 shards of cuda:0: 4 checks OK")

            # a process group of one on NCCL: a fused engine whose captured
            # graph holds the all-gathers, replayed
            dist = torch.distributed
            distributed.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, self.device)
            try:
                assert dist.get_backend() == "nccl", dist.get_backend()
                p = P.GATES_128_K3
                ck, sk, _ = self.keys_for(p, 2024)
                nl = _netlist("c880-like.v")
                eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=True)
                mesh = M.shard_engine(eng, 1)
                eng.compile(nl)
                eng.evaluate(c880_wires)  # the eager run (its all-gathers counted) and the capture
                pbs_levels = sum(1 for lp in eng.plan.levels if lp.num_slots)
                assert mesh.gathers == pbs_levels, (mesh.gathers, pbs_levels)
                got, t_nccl = timed(eng, c880_wires, 3)
                # each replay adds the all-gathers its capture recorded
                assert eng.replays == 3 and mesh.gathers == 4 * pbs_levels, (eng.replays, mesh.gathers)
                same(got, words_of["unsharded eager"], eng.plan.num_wires, "c880-like under NCCL world 1")
                notes.append(f"NCCL world 1: c880-like fused, its graph holds {pbs_levels} all-gathers, 3 replays == "
                             f"unsharded (tolerance 0), {t_nccl:.6f} s/vector")
            finally:
                dist.destroy_process_group()

            count = torch.cuda.device_count()
            if count >= 2:
                mesh_n = M.make_gate_mesh(count, self.device)
                p = P.GATES_128_K3
                ck, sk, _ = self.keys_for(p, 2024)
                eng = BooleanEngine(mode="gates", params=p, keys=(ck, sk), device=self.device, fuse_levels=False)
                shard(eng, mesh_n)
                eng.compile(_netlist("c880-like.v"))
                got, t_n = timed(eng, c880_wires, 3)
                same(got, words_of["unsharded eager"], eng.plan.num_wires, f"c880-like on {count} cards")
                notes.append(f"c880-like eager on {mesh_n} == unsharded: {t_n:.6f} s/vector; launches per shard "
                             f"{mesh_n.launches}")
                procs += self._mesh_cli(adder_argv, count, f"nccl{count}-adder", td)
            else:
                notes.append("1 card: the exchange across cards (make_gate_mesh(n > 1), NCCL between cards) "
                             "is not measured")

            # the CLI processes
            res = {}
            for tag, pid, proc in procs:
                stdout = proc.communicate(timeout=600)[0]
                if proc.returncode != 0:
                    raise AssertionError(f"CLI {tag} process {pid} failed ({proc.returncode}):\n{stdout[-3000:]}")
                res[(tag, pid)] = stdout
            for tag in sorted({t for t, _, _ in procs}):
                pids = sorted(pid for t, pid in res if t == tag)
                golden = "c880-like.outputs.csv" if "c880" in tag else "2-bit-adder.outputs.csv"
                got = csv_io.read_input_wires(os.path.join(td, f"{tag}.0.csv"), "bool")
                assert got == _golden(golden), f"CLI {tag}: {got} != {golden}"
                assert not any(os.path.exists(os.path.join(td, f"{tag}.{pid}.csv")) for pid in pids[1:]), (
                    f"CLI {tag}: a rank other than 0 wrote -o")
                printed = {res[(tag, pid)].split("Encrypted Evaluation:", 1)[1].split("Decrypt", 1)[0] for pid in pids}
                assert len(printed) == 1, f"CLI {tag}: the processes printed different outputs"
                if tag.startswith("nccl1"):
                    assert "(with its" in res[(tag, 0)] and "all-gathers)" in res[(tag, 0)], (
                        "the NCCL world-1 CLI did not capture its all-gathers")
                backend = re.search(r"Process 0 of \d+ \((\w+),", res[(tag, 0)]).group(1)
                notes.append(f"CLI {tag}: {len(pids)} process(es) on {backend}, rank 0 wrote {golden}, "
                             "every process printed the same outputs")
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(td, ignore_errors=True)
        return "; ".join(notes)

    def phase_probes(self):
        """K7-K10 against their plain versions on the card, tolerance 0:
        every variant and build at a few steps, the timed shape of each at
        the reference's steps (its kernel, plain and library times and its
        bound into the kernels line); then, with the four probes' counts
        set to 0 again, the four probe tools at the reference's
        defaults, whose launches are this phase's."""
        import numpy as np
        import torch

        from helm_tpu_torch.ops import probes
        from helm_tpu_torch.tools import expand8_probe, liveset_harness, ptw_probe, splat_repro
        from helm_tpu_torch.tools.probe_timing import bound_s, graph_ms

        dev = torch.device(self.device)
        notes = []

        def equal(what, got, ref):
            if not torch.equal(got, ref):
                diff = (got.double() - ref.double()).abs().max().item()
                raise AssertionError(f"{what}: kernel != plain (max |diff| {diff})")
            return 0.0

        def record(name, ms, plain_ms, ops, nbytes, library_ms=None, bf16=0.0):
            b, by = bound_s(ops, bf16, nbytes)
            self.kernel[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b * 1e3, bound_by=by,
                                     library_ms=library_ms, max_abs_err=0.0)
            notes.append(f"{name} {ms:.6f} ms (plain {plain_ms:.6f}, bound {b * 1e3:.6f} {by}"
                         + (f", library {library_ms:.6f}" if library_ms is not None else "") + ")")

        # K7 at the reference's shape; library: one repeat of x. Both are a
        # few microseconds: the kernels line takes their device times (a
        # graph of 30 calls, replayed; K7, repeat, repeat, K7), the eager
        # times are printed beside them
        x, e8 = expand8_probe.inputs()
        xd = torch.from_numpy(x.astype(np.int32)).to(dev)
        ed = torch.from_numpy(np.ascontiguousarray(e8[:, : expand8_probe.L])).to(dev)
        eager_ms, got = _time_ms(lambda: probes.expand8(xd, ed), reps=30)
        plain_ms, ref = _time_ms(lambda: probes.expand8_plain(xd, ed), reps=3)
        equal("K7", got, ref)
        assert np.array_equal(got.cpu().numpy().astype(np.uint32), np.tile(x, (1, 16))), "K7 != np.tile(x, (1, 16))"
        lib_eager_ms, _ = _time_ms(lambda: xd.repeat(1, 16), reps=30)
        k7 = [graph_ms(lambda: probes.expand8(xd, ed), 30, 20)]
        lib = [graph_ms(lambda: xd.repeat(1, 16), 30, 20) for _ in range(2)]
        k7.append(graph_ms(lambda: probes.expand8(xd, ed), 30, 20))
        ms, lib_ms = sum(k7) / 2, sum(lib) / 2
        record("expand8", ms, plain_ms, *expand8_probe.work(), library_ms=lib_ms)
        notes.append(f"K7 graph replays {k7[0]:.6f} / {k7[1]:.6f} ms, x.repeat(1, 16) {lib[0]:.6f} / "
                     f"{lib[1]:.6f} ms; eager {eager_ms:.6f} and {lib_eager_ms:.6f} ms")

        # K8 and K9: every variant and build at step counts around the column
        # ring's stage and its depth (0, 1, 4, a stage - 1, + 0, + 1, the
        # ring - 1, + 1) and at a G that is not a multiple of the block;
        # timed: K8 splat at the reference's 512 steps, K9 the fs nest, R=8
        # A=12, at 256
        stage, ring = probes.SPLAT_STAGE, probes.SPLAT_RING
        counts = (0, 1, 4, stage - 1, stage, stage + 1, ring - 1, ring + 1)
        cols8, rows8 = (torch.from_numpy(a).to(dev) for a in splat_repro.inputs(8))
        cols, rows = (torch.from_numpy(a).to(dev) for a in splat_repro.inputs(512))
        rows200 = torch.from_numpy(np.random.default_rng(200).integers(-128, 129, (16, 64, 200))
                                   .astype(np.float32)).to(dev)
        for v in probes.SPLAT_VARIANTS:
            c = cols8.to(torch.int16) if v == "i16" else cols8
            equal(f"K8 {v} (8 steps)", probes.splat(c, rows8, v), probes.splat_plain(c, rows8, v))
            c = cols.to(torch.int16) if v == "i16" else cols
            for k in counts:
                equal(f"K8 {v} ({k} steps)", probes.splat(c[:k], rows, v), probes.splat_plain(c[:k], rows, v))
            k = stage + 1
            equal(f"K8 {v} ({k} steps, G=200)", probes.splat(c[:k], rows200[:2], v),
                  probes.splat_plain(c[:k], rows200[:2], v))
        eager_ms, got = _time_ms(lambda: probes.splat(cols, rows, "splat"), reps=30)
        plain_ms, ref = _time_ms(lambda: probes.splat_plain(cols, rows, "splat"), warm=False)
        equal("K8 splat (512 steps)", got, ref)
        k8 = [graph_ms(lambda: probes.splat(cols, rows, "splat"), 10, 10) for _ in range(2)]
        record("splat", sum(k8) / 2, plain_ms, *splat_repro.work(512, "splat"))
        notes.append(f"K8 splat graph replays {k8[0]:.6f} / {k8[1]:.6f} ms, eager {eager_ms:.6f}")

        rng = np.random.default_rng(7)
        for R in probes.LIVESET_RS:
            rowsR = torch.from_numpy(rng.integers(-128, 129, (2 * R, 64, 512)).astype(np.float32)).to(dev)
            for A in probes.LIVESET_AS:
                for v in probes.LIVESET_VARIANTS:
                    for k in counts:
                        equal(f"K9 R={R} A={A} {v} ({k} steps)", probes.liveset(cols[:k], rowsR, A, v),
                              probes.liveset_plain(cols[:k], rowsR, A, v))
                    k = stage + 1
                    equal(f"K9 R={R} A={A} {v} ({k} steps, G=200)", probes.liveset(cols[:k], rows200[: 2 * R], A, v),
                          probes.liveset_plain(cols[:k], rows200[: 2 * R], A, v))
        cols256 = cols[:256].contiguous()
        eager_ms, got = _time_ms(lambda: probes.liveset(cols256, rowsR, 12, "splat"), reps=10)
        plain_ms, ref = _time_ms(lambda: probes.liveset_plain(cols256, rowsR, 12, "splat"), warm=False)
        equal("K9 R=8 A=12 splat (256 steps)", got, ref)
        k9 = [graph_ms(lambda: probes.liveset(cols256, rowsR, 12, "splat"), 10, 10) for _ in range(2)]
        record("liveset", sum(k9) / 2, plain_ms, *splat_repro.work(256, "splat", 8))
        notes.append(f"K9 R=8 A=12 splat graph replays {k9[0]:.6f} / {k9[1]:.6f} ms, eager {eager_ms:.6f}")
        spills = {f"K8 {v}": probes.splat_resources(1, 1, v) for v in probes.SPLAT_VARIANTS}
        spills.update({f"K9 R={R} A={A} {v}": probes.splat_resources(R, A, v) for R in probes.LIVESET_RS
                       for A in probes.LIVESET_AS for v in probes.LIVESET_VARIANTS})

        # K10: every pattern at 3 steps; timed: C at the reference's 64 steps.
        # Library: the six bf16 products of one (unit, group) are the three
        # limb matrices [3 x 64, 512] by the two feedback limbs [512, 2 x
        # 512]; a step's units x groups of them share the feedback, so a
        # step is one torch.matmul of the stacked limb matrices [units x
        # groups x 3 x 64, 512] by [512, 2 x 512], and the run 64 of them,
        # timed as device time (a graph of the 64 calls, replayed) and
        # eager, around C (library, C, C, library)
        data = {k: [torch.from_numpy(a).to(dev) for a in v] for k, v in ptw_probe.inputs(probes.PTW_PATTERNS).items()}
        for pat in probes.PTW_PATTERNS:
            equal(f"K10 {pat} (3 steps)", probes.ptw(pat, data[pat], 3), probes.ptw_plain(pat, data[pat], 3))
            if pat != "C":  # C at 64 steps below, with its timing
                equal(f"K10 {pat} (64 steps)", probes.ptw(pat, data[pat], 64), probes.ptw_plain(pat, data[pat], 64))
            spills[f"K10 {pat}"] = probes.ptw_resources(pat)
        _, scratch, _ = probes.ptw_c(data["C"], 0)
        image = probes.ptw_c_limb_image(probes.ptw_c_limbs(*data["C"]))
        assert torch.equal(scratch[: probes.PTW_C_LIMB_BYTES].cpu(), image), "K10 C: limb buffer != the host's layout"
        a = torch.randint(-128, 129, (2 * probes.NVC * 3 * 64, 512), device=dev).to(torch.bfloat16)
        b = torch.randint(-128, 129, (512, 2 * 512), device=dev).to(torch.bfloat16)
        lib = [graph_ms(lambda: torch.matmul(a, b), 64, 10) * 64]
        c_ms = [_time_ms(lambda: probes.ptw("C", data["C"], 64), reps=10) for _ in range(2)]
        lib.append(graph_ms(lambda: torch.matmul(a, b), 64, 10) * 64)
        lib_eager_ms, _ = _time_ms(lambda: torch.matmul(a, b), reps=64)
        ms, got = sum(m for m, _ in c_ms) / 2, c_ms[-1][1]
        plain_ms, ref = _time_ms(lambda: probes.ptw_plain("C", data["C"], 64), warm=False)
        equal("K10 C (64 steps)", got, ref)
        fp32, bf16, nbytes = ptw_probe.work("C", 64, 2)
        record("ptw", ms, plain_ms, fp32, nbytes, library_ms=sum(lib) / 2, bf16=bf16)
        phases = probes.ptw_c_phases(data["C"], 64)
        regs, spill = probes.ptw_resources("C")
        notes.append(
            f"K10 C {c_ms[0][0]:.6f} / {c_ms[1][0]:.6f} ms, library graph replays {lib[0]:.6f} / {lib[1]:.6f} ms "
            f"(eager {lib_eager_ms * 64:.6f}); C's clocks a block a step: "
            + ", ".join(f"{k} {v:.0f} ({phases['shares'][k]:.1%})" for k, v in phases["clocks"].items())
            + f" of a {phases['step']:.0f}-clock step over {phases['blocks']} blocks (build concurrent); "
            f"regs {regs}, spill {spill} B; limb buffer == the host's layout")
        spilled = {k: v for k, v in spills.items() if v[1]}
        assert not spilled, f"builds that spill (registers, bytes): {spilled}"
        regs = sorted(r for r, _ in spills.values())
        checks = (f"K7; K8 x 4 variants and K9 x 60 builds at {', '.join(map(str, counts))} steps and G=200; "
                  "K10 x 5 patterns: kernel == plain (tolerance 0); "
                  f"{len(spills)} K8-K10 builds, {regs[0]}-{regs[-1]} registers, 0 spill bytes")

        # the probe tools, as a user runs them: this phase's launches
        for w in (probes.expand8, probes.splat, probes.liveset, probes.ptw):
            w.launches = 0
        assert expand8_probe.run(dev, 30)["match"]
        splat_repro.run(dev, 512, 30, probes.SPLAT_VARIANTS)
        liveset_harness.run(dev, 256, 10, 512, probes.LIVESET_RS, probes.LIVESET_AS, probes.LIVESET_VARIANTS)
        ptw_probe.run(dev, probes.PTW_PATTERNS, 64, 20)
        return f"{checks}; " + "; ".join(notes) + "; the four probe tools' lines printed above"

    def phase_tools(self):
        """The reference's measurement tools through their ports, with the
        keys of the earlier phases: family_bench at GATES_128_K3 (c1908,
        c6288, c880 x 8, s386 x 4 cycles fused) and in LUT mode at
        LUT_128_K2 (both LUT adders), aes_bench at GATES_128_K3 fused at
        BATCH 0 and 4, chi2_bench (chi-squared u32 at ARITH_PARAMS: K2;
        chi-squared u32, euclidean u32 and box blur u16 at ARITH_128_MB2:
        K1), noise_validate at GATES_128_K3 over 2^18 samples and
        noise_decompose over 8192: every output right, 0 decision
        failures; g1_fs_test's A/B (`_g1_ab`), param_search with --measure
        3 and its held-out sets (`_param_search`), and collect_results over
        the phase's own output, which must find every RESULT, sweep and AES
        line the phase printed."""
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            msg = self._tools()
            msg += "; " + self._g1_ab() + "; " + self._param_search()
        from helm_tpu_torch.tools import collect_results

        text = out.text()
        with tempfile.TemporaryDirectory() as td:
            log = os.path.join(td, "tools.log")
            with open(log, "w") as fh:
                fh.write(text)
            got = collect_results.collect([log])
        lines = text.splitlines()
        want = {"results": sum(ln.startswith("RESULT {") for ln in lines),
                "sweeps": sum("rot/s (first call" in ln for ln in lines),
                "aes": sum(ln.startswith("AES-128 steady-state:") for ln in lines)}
        for key, n in want.items():
            assert len(got[key]) == n and n > 0, f"collect_results found {len(got[key])} {key}, the phase printed {n}"
        return msg + "; collect_results over the phase's output: " + ", ".join(
            f"{len(got[k])} {k}" for k in want) + ", every one printed"

    def _tools(self):
        import torch

        from helm_tpu_torch import params as P
        from helm_tpu_torch.tools import aes_bench, chi2_bench, family_bench, noise_decompose, noise_validate

        dev = torch.device(self.device)
        keys = {}
        for p, seed in ((P.GATES_128_K3, 2024), (P.LUT_128_K2, 2025), (P.ARITH_128_MB2, 2030),
                        (P.ARITH_PARAMS, 2033)):
            ck, sk, _ = self.keys_for(p, seed)
            keys[p.name] = (ck, sk)
        notes = []

        def timed(what, fn):
            t0 = time.perf_counter()
            out = fn()
            notes.append(f"{what} {time.perf_counter() - t0:.2f} s")
            return out

        nets = "benchmarks/netlists/"
        for env in (
            {"PSET": "GATES_128_K3", "CYCFUSE": "1", "NETLISTS": f"{nets}c1908-like.v {nets}c6288-like.v "
             f"{nets}c880-like.v:8 {nets}s386-like.v:0:4"},
            {"MODE": "lut", "PSET": "LUT_128_K2",
             "NETLISTS": f"{nets}8-bit-adder-lut-2-1.v {nets}8-bit-adder-lut-3-1.v"},
        ):
            for r in timed(f"family_bench {env.get('MODE', 'gates')}", lambda: family_bench.run(env, dev, keys)):
                assert r["correct"], f"family_bench {r['family']}: correct false"
        for B in (0, 4):
            r = timed(f"aes_bench BATCH={B}", lambda: aes_bench.run(
                {"PSET": "GATES_128_K3", "FUSE": "1", "BATCH": str(B)}, dev, keys))
            assert r["fused"], "aes_bench: the engine did not fuse"
            assert r["correct"], f"aes_bench BATCH={B}: a ciphertext is wrong"
            assert r["ciphertexts"][0] == aes_bench.C1, f"aes_bench: C.1 gave {r['ciphertexts'][0]}"
            print("RESULT " + json.dumps({k: v for k, v in r.items() if k != "ciphertexts"}), flush=True)
        for env in ({"NETLIST": f"{nets}chi_squared_arith.v", "WIDTH": "u32"},
                    {"PARAMS": "ARITH_128_MB2", "NETLISTS": f"{nets}chi_squared_arith.v:u32 "
                     f"{nets}euclidean_arith.v:u32 {nets}box_blur_arith.v:u16"}):
            for r in timed(f"chi2_bench {env.get('PARAMS', 'ARITH_PARAMS')}", lambda: chi2_bench.run(env, dev, keys)):
                assert r["correct"], f"chi2_bench {r['family']} {r['width']}: correct false"
        r = timed("noise_validate 2^18", lambda: noise_validate.run(
            {"PSET": "GATES_128_K3", "SAMPLES": str(1 << 18)}, dev, keys))
        assert r["decision_failures"] == 0, f"noise_validate: {r['decision_failures']} decision failures"
        timed("noise_decompose 8192", lambda: noise_decompose.run({"PSET": "GATES_128_K3", "SAMPLES": "8192"},
                                                                   dev, keys))
        return ("every family correct, AES C.1 = " + aes_bench.C1 + " and every block right, every arith "
                "output = its oracle, 0 noise decision failures (RESULT lines above); " + "; ".join(notes))

    def _g1_ab(self):
        """The reference's g1_fs_test A/B at GATES_128_K3, G=1024 AND gates:
        K1 at g = 2 (the set's own key; mb_sweep's line), K1 at g = 1 (the
        tool, on its gen_bsk_multibit key) and K2 at g = 1 on the same key
        (the production route of a grouping-1 set): each decrypt-checked,
        its ms by CUDA events (6 calls after one), rot/s and bound, as a
        RESULT line."""
        from helm_tpu_torch import params as P
        from helm_tpu_torch.ops import mb_pbs, sb_pbs
        from helm_tpu_torch.tools import g1_fs_test, mb_sweep

        G = 1024
        p2, p1 = P.GATES_128_K3, g1_fs_test.g1_params(False)
        ck2, _, dsk2 = self.keys_for(p2, 2024)
        ck1, _, dsk1 = self.keys_for(p1, 7, multibit=True)
        notes = []
        for label, fn, p, ck, dsk in (("K1 g=2", mb_pbs.blind_rotate_mb, p2, ck2, dsk2),
                                      ("K1 g=1", mb_pbs.blind_rotate_mb, p1, ck1, dsk1),
                                      ("K2 g=1", sb_pbs.blind_rotate_sb, p1, ck1, dsk1)):
            x, tv = mb_sweep.inputs(ck, G, self.device)
            g1_fs_test.check_ands(ck, fn(dsk, x, tv), f"{label} {p.name}")
            ms, _ = _time_ms(lambda: fn(dsk, x, tv), reps=6)
            b_ms, b_by = bound_ms(p, G, 1, fn.__name__)
            res = {"tool": "g1_ab", "rotation": label, "kernel": fn.__name__, "set": p.name, "G": G, "ms": ms,
                   "rot_s": G * 1e3 / ms, "bound_ms": b_ms, "bound_by": b_by, "card": self.card}
            print("RESULT " + json.dumps(res), flush=True)
            notes.append(f"{label} {ms:.3f} ms, {G * 1e3 / ms:.1f} rot/s (bound {b_ms:.3f} ms, {b_by})")
        # the tools' own lines: g1_fs_test's run and mb_sweep's fs line at g = 2
        g1_fs_test.run(ck1, dsk1, G, 512)
        mb_sweep.sweep(dsk2, ck2, "fs", G, [32])
        return "g1_fs_test A/B at G=1024, decrypt-checked: " + "; ".join(notes)

    def _param_search(self):
        """param_search's table with --measure 3 (K1 on the first three rows
        with a build, keys made there), then the model's held-out sets
        LUT_128_MB2 and GATES_TPU_MB4 with the keys of phases k1 and k4:
        predicted against measured rot/s (RESULT lines; a miss over 20% is
        printed, not a failure: the model is an estimate)."""
        from helm_tpu_torch import params as P
        from helm_tpu_torch.tools import param_search

        t0 = time.perf_counter()
        param_search.main(["--measure", "3"])
        errs = {}
        for p, seed in ((P.LUT_128_MB2, 2032), (P.GATES_TPU_MB4, 2031)):
            ck, _, dsk = self.keys_for(p, seed)
            errs[p.name] = param_search.compare(p, ck, dsk)["err"]
        far = [name for name, e in errs.items() if abs(e) > 0.2]
        return (f"param_search --measure 3 and held-out sets ({time.perf_counter() - t0:.2f} s): measured against "
                f"predicted {', '.join(f'{n} {100 * e:+.1f}%' for n, e in errs.items())}"
                + (f"; over 20%: {', '.join(far)}" if far else ""))

    def phase_cli(self):
        """The CLI in four subprocesses, started together (each pays its own
        keygen on the host): the 2-bit adder with --profile DIR, the LUT
        adder, chi-squared u32 with -i and with -I (the four recorded
        vectors); every output against its golden CSV."""
        from helm_tpu_torch.io import csv_io

        runs = {
            "2-bit-adder": ("2-bit-adder", "2-bit-adder.inputs.csv", "2-bit-adder.outputs.csv", "bool"),
            "8-bit-adder-lut-3-1": ("8-bit-adder-lut-3-1", "8-bit-adder.inputs.csv",
                                    "8-bit-adder-lut-3-1.outputs.csv", "bool"),
            "chi_squared_arith": ("chi_squared_arith", "chi_squared_arith_1.inputs.csv",
                                  "chi_squared_arith_1.outputs.csv", "u32"),
        }
        files = [f"benchmarks/test-cases/chi_squared_arith_{i}.inputs.csv" for i in range(1, 5)]
        notes = []
        with tempfile.TemporaryDirectory() as td:
            prof = os.path.join(td, "prof")
            argvs = {
                name: ["-v", f"benchmarks/netlists/{net}.v", "-i", f"benchmarks/test-cases/{inputs}",
                       "-o", os.path.join(td, f"{name}.csv"), *(["-a", kind] if kind != "bool" else []),
                       *(["--profile", prof] if name == "2-bit-adder" else [])]
                for name, (net, inputs, _, kind) in runs.items()
            }
            argvs["-I"] = ["-v", "benchmarks/netlists/chi_squared_arith.v", "-a", "u32", "-I", *files,
                           "-o", os.path.join(td, "batch.csv")]
            procs = {
                name: subprocess.Popen(
                    [sys.executable, "-m", "helm_tpu_torch.cli", *argv, "--device", self.device],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                for name, argv in argvs.items()
            }
            res = {}
            try:
                for name, proc in procs.items():
                    stdout, stderr = proc.communicate(timeout=600)
                    res[name] = stdout
                    if proc.returncode != 0:
                        raise AssertionError(
                            f"CLI failed on {name} ({proc.returncode}):\n{stdout[-3000:]}\n{stderr[-3000:]}"
                        )
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            assert f"[✓] profiler trace written to {prof}" in res["2-bit-adder"], "CLI --profile printed no trace line"
            with open(os.path.join(prof, "evaluation.pt.trace.json")) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel" and "rotate_tiles" in e.get("name", "")]
            assert kernels, "the --profile trace names no rotate_tiles kernel"
            notes.append(f"2-bit-adder --profile DIR: its trace holds {len(events)} events, {len(kernels)} "
                         f"rotate_tiles kernels")
            for name, (net, _, golden, kind) in runs.items():
                got = csv_io.read_input_wires(os.path.join(td, f"{name}.csv"), kind)
                exp = _golden(golden, kind)
                assert got == exp, f"CLI outputs on {net} {got} != golden {exp}"
                notes.append(f"{net}{'' if kind == 'bool' else ' -a ' + kind} --device cuda reproduces {golden}")
            for i in range(4):
                assert f" [vector {i}: {files[i]}]" in res["-I"], f"CLI -I printed no vector {i}"
                got = csv_io.read_input_wires(os.path.join(td, f"batch.csv.{i}"), "u32")
                exp = _golden(f"chi_squared_arith_{i + 1}.outputs.csv", "u32")
                assert got == exp, f"CLI -I vector {i} {got} != golden {exp}"
        notes.append("chi_squared_arith -a u32 --device cuda -I (the 4 recorded vectors, one batch) "
                     "reproduces the 4 golden CSVs")
        return "; ".join(notes)

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
    from helm_tpu_torch.ops import gm_pbs, mb_pbs, probes, ps_pbs, sb_pbs, ts_pbs

    wrappers = {
        "blind_rotate_mb": mb_pbs.blind_rotate_mb,
        "blind_rotate_sb": sb_pbs.blind_rotate_sb,
        "blind_rotate_ps": ps_pbs.blind_rotate_ps,
        "blind_rotate_ts": ts_pbs.blind_rotate_ts,
        "blind_rotate_gm": gm_pbs.blind_rotate_gm,
        "expand8": probes.expand8,
        "splat": probes.splat,
        "liveset": probes.liveset,
        "ptw": probes.ptw,
    }
    #: the kernels each main-path phase must launch
    expect = {"batch": ("blind_rotate_mb",), "c880": ("blind_rotate_mb",),
              "g1": ("blind_rotate_sb",), "lut": ("blind_rotate_mb", "blind_rotate_sb"),
              "arith": ("blind_rotate_mb", "blind_rotate_sb"), "baseline": ("blind_rotate_mb",),
              "ps": ("blind_rotate_ps", "blind_rotate_mb"),
              "serve": ("blind_rotate_ts", "blind_rotate_mb"),
              "sweep": ("blind_rotate_mb", "blind_rotate_ps", "blind_rotate_ts", "blind_rotate_gm"),
              "mesh": ("blind_rotate_mb", "blind_rotate_sb"),
              "probes": ("expand8", "splat", "liveset", "ptw"),
              "tools": ("blind_rotate_mb", "blind_rotate_sb")}
    for name in PHASES:
        if name not in only:
            continue
        if name in MAIN_PATH:
            for w in wrappers.values():
                w.launches = 0  # this main-path phase's run starts here
            mb_pbs.blind_rotate_mb.g1_launches = 0
        t0 = time.perf_counter()
        msg = getattr(smoke, f"phase_{name}")()
        if name in MAIN_PATH:
            counts = {k: w.launches for k, w in wrappers.items()}
            for k in expect[name]:
                assert counts[k] > 0, f"main-path phase {name} never launched {k}"
            for k, c in counts.items():
                smoke.kernel[k]["launches"] += c
            g1 = mb_pbs.blind_rotate_mb.g1_launches
            assert name != "tools" or g1 > 0, "main-path phase tools never launched K1 at grouping 1"
            smoke.kernel["blind_rotate_mb"]["g1"]["launches"] += g1
            msg += f"; launches {counts}, K1 at grouping 1 {g1}"
        print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)
    print(json.dumps({"kernels": list(smoke.kernel.values())}))
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
