"""helm-tpu-torch CLI — the reference flags, gates, LUT and arith modes,
on a torch device.

Counterpart of `helm_tpu/cli.py` (`main`, `_run_boolean`, `_run_arith`):
the same netlist / input / output / cycles / arithmetic flags and
parameter-set selection, plus `--device` (default `cuda`). `-a TYPE` runs
arith mode (default set DEFAULT_ARITH, `--test-params`
TEST_PARAMS_ARITH); otherwise a netlist with `lut` cells runs in LUT mode
(DEFAULT_LUT, TEST_PARAMS_LUT), any other in gates mode (DEFAULT_GATES,
TEST_PARAMS). A missing device is an error, never a quiet switch to the
CPU. `-I/--batch-input-files` evaluates several input CSVs in one batched
pass (every bootstrap launch that many times wider); each vector's outputs
print under `[vector i: file]` and go to `<-o>.<i>`. `--fuse-levels` /
`--no-fuse-levels` force fused level evaluation (on the card, one CUDA
graph replay an evaluation after a first, eager call that captures it) on
or off; by default narrow, deep circuits fuse. `--fuse-cycles` runs all
`-c` cycles as one call of `BooleanEngine.evaluate_cycles` and prints the
amortized time a cycle. Under `-I` a batch that underfills the card's
cluster slots prints `batching.check_batch`'s warning. `--profile DIR`
records the evaluation with `torch.profiler` (the card's kernels on CUDA,
host activity only on the CPU) and writes a Chrome trace into DIR.
`--mesh N` shards every PBS batch across N devices (`parallel/mesh.py`:
N cards, or N virtual shards with --device cpu); `--multihost
COORD:PORT,NPROCS,PID` first joins a `torch.distributed` process group of
NPROCS processes, one per card (`parallel/distributed.py`), and `--mesh`
must then be NPROCS. Every process makes the same keys (without --seed,
process 0 draws one and sends it to the others) and encrypts the same
inputs; every process prints its outputs; only rank 0 writes `-o`.

    python -m helm_tpu_torch.cli -v benchmarks/netlists/2-bit-adder.v \\
        -i benchmarks/test-cases/2-bit-adder.inputs.csv -o out.csv --device cuda
    python -m helm_tpu_torch.cli -v benchmarks/netlists/8-bit-adder-lut-3-1.v \\
        -i benchmarks/test-cases/8-bit-adder.inputs.csv --device cuda
    python -m helm_tpu_torch.cli -v benchmarks/netlists/chi_squared_arith.v -a u32 \\
        -i benchmarks/test-cases/chi_squared_arith_1.inputs.csv --device cuda
    python -m helm_tpu_torch.cli -v benchmarks/netlists/chi_squared_arith.v -a u32 \\
        -I benchmarks/test-cases/chi_squared_arith_{1,2,3,4}.inputs.csv -o out.csv
    python -m helm_tpu_torch.cli -v benchmarks/netlists/2-bit-adder.v \\
        -i benchmarks/test-cases/2-bit-adder.inputs.csv --profile prof/
    python -m helm_tpu_torch.cli -v benchmarks/netlists/c880-like.v \\
        -i benchmarks/test-cases/c880-like.inputs.csv --mesh 2 --device cpu --test-params
    # one process each, PID 0 and 1:
    python -m helm_tpu_torch.cli -v benchmarks/netlists/2-bit-adder.v \\
        -i benchmarks/test-cases/2-bit-adder.inputs.csv --test-params --device cpu \\
        --multihost 127.0.0.1:29500,2,PID --mesh 2
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from . import ascii_art
from .circuit.verilog import read_verilog_file
from .io import csv_io


def get_input_wire_map(args, ptxt_type: str) -> dict:
    """Reference src/lib.rs:113-179; ptxt_type is "bool" or an arith type."""
    if args.input_wires_file:
        print("[✓] Input wires were provided.")
        return csv_io.read_input_wires(args.input_wires_file, ptxt_type)
    if args.input_wires:
        print("[✓] Input wires were provided.")
        out = {}
        for parts in args.input_wires:
            if len(parts) == 2:
                out[parts[0]] = csv_io.parse_input_wire(parts[1], ptxt_type)
            elif len(parts) == 3 and ptxt_type == "bool":
                width = int(parts[2])
                bits = csv_io.hex_to_bitstring(parts[1].strip())[::-1]
                for idx in range(width):
                    out[f"{parts[0]}[{idx}]"] = idx < len(bits) and bits[idx] == "1"
            else:
                raise SystemExit("-w input should contain either two or three values")
        return out
    print("[!] No input wires specified, they will be initialized to false.")
    return {"dummy": False}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="helm-tpu-torch",
        description="HELM-TPU, PyTorch/CUDA port: encrypted circuit evaluation "
        "through gates and lookups, on NVIDIA GPUs",
    )
    ap.add_argument("-v", "--verilog", required=True, metavar="FILE")
    ap.add_argument(
        "-w", "--input-wires", nargs="+", action="append",
        metavar=("STRING", "VALUE"),
        help="Input wire values (-w wire1 value1 [width1] ...)",
    )
    ap.add_argument("-i", "--input-wires-file", metavar="FILE")
    ap.add_argument(
        "-I", "--batch-input-files", nargs="+", metavar="FILE",
        help="several input CSVs evaluated in one batched pass; outputs go to <-o>.<i>",
    )
    ap.add_argument("-o", "--output-wires-file", metavar="FILE")
    ap.add_argument(
        "-a", "--arithmetic", choices=["u8", "u16", "u32", "u64", "u128"],
        help="arithmetic mode: wires are encrypted radix integers of this width",
    )
    ap.add_argument("-c", "--cycles", type=int, default=1, metavar="NUMBER")
    ap.add_argument("-p", "--verbose", action="store_true")
    ap.add_argument(
        "--tpu", "--gpu", "-g", action="store_true",
        help="(accepted for parity with the reference's --gpu; the device is --device's)",
    )
    ap.add_argument(
        "--test-params", action="store_true",
        help="tiny noise-free parameters (test_tiny; test_tiny_lut for "
        "LUT netlists; test_tiny_arith with -a)",
    )
    ap.add_argument("--seed", type=int, default=None, help="key RNG seed")
    ap.add_argument(
        "--params", metavar="NAME",
        help="named parameter set (helm_tpu_torch.params.ALL_PARAMS), e.g. "
        "gates_tpu_v32 (single-bit), gates_128_k3 or arith_128_mb2 (multi-bit)",
    )
    ap.add_argument(
        "--profile", metavar="DIR",
        help="capture a torch.profiler trace of the evaluation into DIR (Chrome trace JSON)",
    )
    ap.add_argument(
        "--keys", metavar="DIR",
        help="load client/server keys for the parameter set from DIR when "
        "present, else generate and save them there",
    )
    ap.add_argument(
        "--fuse-levels", action="store_const", const=True, default=None,
        help="force all levels into one CUDA graph replay (latency mode; gates "
        "and LUT modes). Default: auto-enabled for narrow/deep circuits",
    )
    ap.add_argument(
        "--no-fuse-levels", dest="fuse_levels", action="store_const", const=False,
        help="force per-level launches",
    )
    ap.add_argument(
        "--fuse-cycles", action="store_true",
        help="evaluate all -c cycles in ONE CUDA graph replay (sequential "
        "circuits without the READY protocol; prints amortized per-cycle time)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the plain torch versions)",
    )
    ap.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="shard gate batches across N devices (0 = single device; with "
        "--device cpu, N virtual shards)",
    )
    ap.add_argument(
        "--multihost", metavar="COORD:PORT,NPROCS,PID",
        help="join a torch.distributed process group of NPROCS processes, one per "
        "card (combine with --mesh NPROCS); process PID 0 serves COORD:PORT",
    )
    return ap


def _input_maps(args, ptxt_type: str):
    """The input map, or with -I the list of one map per CSV
    (`helm_tpu/cli.py:204-214`)."""
    if args.batch_input_files:
        # parsed in C++ (io/native_loader.py), as the reference's -I
        from .io import native_loader

        maps = [native_loader.read_input_wires(f, ptxt_type) for f in args.batch_input_files]
        print(f"[✓] Batched input wires: {len(maps)} vectors.")
        return maps
    return get_input_wire_map(args, ptxt_type)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _report(args, outputs) -> None:
    """Print and write the outputs: one dict, or with -I one per vector
    under `[vector i: file]`, written to `<-o>.<i>`. Under --multihost every
    process prints and rank 0 alone writes."""
    write = _rank() == 0
    if isinstance(outputs, list):
        for bi, out in enumerate(outputs):
            print(f" [vector {bi}: {args.batch_input_files[bi]}]")
            _print_outputs(out, args.verbose)
            if args.output_wires_file and write:
                csv_io.write_output_wires(f"{args.output_wires_file}.{bi}", out)
    else:
        _print_outputs(outputs, args.verbose)
        if write:
            csv_io.write_output_wires(args.output_wires_file, outputs)


def _print_outputs(outputs: dict, verbose: bool) -> None:
    for i, w in enumerate(sorted(outputs)):
        if i > 10 and not verbose:
            print("[!] More than ten output_wires, pass `--verbose` to see output.")
            break
        print(f" {w}: {outputs[w]}")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(args, device):
    """torch.profiler over the block when --profile DIR is given
    (`helm_tpu/cli.py:261-292`, jax.profiler there): CUDA activity on the
    card, CPU activity only on the CPU; the Chrome trace goes to
    DIR/evaluation.pt.trace.json. A profiler that fails raises."""
    if not args.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile, "evaluation.pt.trace.json"))
    print(f"[✓] profiler trace written to {args.profile}")


def main(argv=None) -> int:
    ascii_art.print_art()
    args = build_argparser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to run the plain torch versions)"
        )
    if args.multihost:
        # before keygen, as the reference initialises jax.distributed first
        from .parallel.distributed import init_multihost, parse_multihost_flag

        try:
            coordinator, nprocs, pid = parse_multihost_flag(args.multihost)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        device = init_multihost(coordinator, nprocs, pid, device)
        print(
            f"[✓] Process {pid} of {nprocs} ({torch.distributed.get_backend()}, "
            f"coordinator {coordinator}) on {device}."
        )
        if args.seed is None:
            # every process must make the same keys and ciphertexts: process
            # 0 draws a 256-bit seed and sends it to the others
            box = [int.from_bytes(os.urandom(32), "little") if pid == 0 else None]
            torch.distributed.broadcast_object_list(box, src=0)
            args.seed = box[0]
    try:
        if args.arithmetic and args.cycles > 1:
            raise SystemExit(
                "Arithmetic does not currently support sequential. Set num_cycles to 1."
            )
        netlist = read_verilog_file(args.verilog, args.arithmetic is not None)
        is_sequential = len(netlist.dff_outputs) > 1  # quirk kept: helm.rs:49
        if args.cycles > 1 and not is_sequential:
            raise SystemExit("[!] Cannot run combinational circuit for more than one cycles.")
        if args.arithmetic:
            return _run_arith(args, netlist, device)
        return _run_boolean(args, netlist, device)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _params_and_keys(args, test_params, default, device):
    """The parameter set (--params, else --test-params' set, else the
    mode's default) and, with --keys DIR, its loaded or generated keys."""
    from . import params as P

    if args.params:
        if args.params not in P.ALL_PARAMS:
            raise SystemExit(
                f"unknown --params {args.params!r}; "
                f"known: {', '.join(sorted(P.ALL_PARAMS))}"
            )
        params = P.ALL_PARAMS[args.params]
    elif args.test_params:
        params = test_params
    else:
        params = default
    keys = None
    if args.keys:
        from .fhe.keys import load_or_generate

        keys = load_or_generate(args.keys, params, args.seed, device)
        print(f"[✓] Keys ({params.name}) from {args.keys}.")
    return params, keys


def _run_boolean(args, netlist, device) -> int:
    from . import params as P
    from .engines.boolean import BooleanEngine

    mode = "lut" if netlist.has_luts else "gates"
    print(f" -- {'LUTs' if mode == 'lut' else 'Gates'} mode --")
    input_wire_map = _input_maps(args, "bool")
    start = time.time()
    if mode == "gates":
        params, keys = _params_and_keys(args, P.TEST_PARAMS, P.DEFAULT_GATES, device)
    else:
        params, keys = _params_and_keys(args, P.TEST_PARAMS_LUT, P.DEFAULT_LUT, device)
    engine = BooleanEngine(
        mode=mode, params=params, seed=args.seed, keys=keys, device=device,
        fuse_levels=args.fuse_levels,
    )
    print(f"KeyGen done in {time.time() - start} seconds.")
    mesh = None
    if args.mesh:
        from .parallel.mesh import shard_engine

        mesh = shard_engine(engine, args.mesh)
        print(f"[✓] Gate batches sharded on {mesh}.")
    engine.compile(netlist)
    if args.batch_input_files:
        # the card's fill at this batch (helm_tpu/cli.py:245-252)
        from .batching import check_batch

        warn = check_batch(engine, len(args.batch_input_files))
        if warn:
            print(f"[!] {warn}")

    start = time.time()
    wires = engine.encrypt_inputs(input_wire_map)
    nbatch = len(input_wire_map) if isinstance(input_wire_map, list) else None
    valid = engine.init_ready(batch=nbatch) if engine.has_ready() else None
    print(f"Encryption done in {time.time() - start} seconds.")

    ready_flag = False
    with _profiled(args, device):
        if args.fuse_cycles and args.cycles > 1 and not engine.has_ready():
            # all cycles in one evaluate_cycles call (helm_tpu/cli.py:267-278):
            # the amortized time a cycle, since a single replay has no
            # per-cycle wall-clock
            start = time.time()
            wires = engine.evaluate_cycles(wires, args.cycles)
            _sync(device)
            dt = time.time() - start
            print(
                f"Cycles 0..{args.cycles - 1}) Evaluation done in {dt} seconds "
                f"(one fused call; {dt / args.cycles:.3f} s/cycle amortized).\n"
            )
        else:
            for cycle in range(args.cycles):
                start = time.time()
                wires = engine.evaluate(wires, verbose=args.verbose)
                if args.cycles > 1 and engine.has_ready():
                    ready_flag = True
                    valid = engine.evaluate_ready(wires, valid)
                _sync(device)
                print(f"Cycle {cycle}) Evaluation done in {time.time() - start} seconds.\n")

    if mesh is not None:
        print(f"[✓] Mesh: kernel launches per shard {mesh.launches}, {mesh.gathers} all-gathers.")
    start = time.time()
    print("Encrypted Evaluation:")
    if ready_flag:
        outputs = engine.decrypt_outputs(valid, from_valid=True)
    else:
        outputs = engine.decrypt_outputs(wires)
    _report(args, outputs)
    print(f"Decryption done in {time.time() - start} seconds.")
    return 0


def _run_arith(args, netlist, device) -> int:
    from . import params as P
    from .engines.arith import ArithEngine

    print(f" -- Arithmetic mode with {args.arithmetic} --")
    input_wire_map = _input_maps(args, args.arithmetic)
    start = time.time()
    params, keys = _params_and_keys(args, P.TEST_PARAMS_ARITH, P.DEFAULT_ARITH, device)
    engine = ArithEngine(
        args.arithmetic, params=params, seed=args.seed, keys=keys, device=device
    )
    print(f"KeyGen done in {time.time() - start} seconds.")
    if args.mesh:
        from .parallel.mesh import batch_sharding, make_gate_mesh, replicated

        mesh = make_gate_mesh(args.mesh, device.type)
        engine.set_sharding(batch_sharding(mesh), replicated(mesh))
        print(f"[✓] Radix bootstrap batches sharded on {mesh}.")
    engine.compile(netlist)

    start = time.time()
    wires = engine.encrypt_inputs(input_wire_map)
    print(f"Encryption done in {time.time() - start} seconds.")

    start = time.time()
    wires = engine.evaluate(wires, verbose=args.verbose)
    _sync(device)
    print(f"Evaluation done in {time.time() - start} seconds.\n")
    if args.mesh:
        print(f"[✓] Mesh: kernel launches per shard {mesh.launches}, {mesh.gathers} all-gathers.")

    start = time.time()
    print("Encrypted Evaluation:")
    outputs = engine.decrypt_outputs(wires)
    _report(args, outputs)
    print(f"Decryption done in {time.time() - start} seconds.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
