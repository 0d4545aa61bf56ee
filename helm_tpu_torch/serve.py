"""Batched serving daemon on a torch device: watch a directory, evaluate,
write outputs.

Counterpart of `helm_tpu/serve.py`. Many independent input vectors stream
through one compiled circuit, and every bootstrap launch is `batch`x
wider, which amortizes the per-launch blind-rotation latency:

    python -m helm_tpu_torch.serve --verilog circuit.v --watch in/ --outdir out/ \\
        [--arithmetic u32] [--params gates_128_k3] [--keys keysdir] \\
        [--batch 8] [--linger 0.5] [--max-batches N] [--device cuda]

Each `*.csv` file appearing in the watch directory is one input-wire
vector (the reference's input CSV format, parsed in C++ by
`io/native_loader.py`, as the reference's daemon does).
Vectors are collected into fixed-size batches (a partial batch after
`--linger` seconds of quiet, padded with repeats of its first vector),
evaluated, and each vector's decrypted outputs are written to
`<outdir>/<name>.out.csv`; processed inputs move to `<watch>/done/`, and a
malformed CSV to `<watch>/failed/` with a note of what was wrong.
`--max-batches` exits after N batches; `--supervise` restarts a worker
that dies. The flags are the reference's, less `--backend` (the kernels
follow the device and HELM_TPU_MB_KERNEL), plus `--device` (default
`cuda`; `cpu` runs the plain torch versions). `--fuse-levels` /
`--no-fuse-levels` force fused level evaluation on or off (default: the
engine's auto-rule): on the card the first batch runs eagerly and captures
one CUDA graph for the batch shape, and every later batch is one replay of
it (the batch line says "graph replay"). `--batch auto` picks the batch
in 1..`--max-batch` by the card's cost model (`batching.suggest_batch`:
the launches each level really makes at each batch) and prints it with its
fill; a fixed `--batch` that underfills the card's cluster slots prints
`batching.check_batch`'s warning. An arith engine takes min(8,
`--max-batch`) under `auto`, as the reference does.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

from .circuit.verilog import read_verilog_file
from .io import csv_io, native_loader


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "helm-serve-torch", description="helm_tpu_torch batched serving daemon"
    )
    ap.add_argument("-v", "--verilog", required=True)
    ap.add_argument("--watch", required=True, metavar="DIR")
    ap.add_argument("--outdir", required=True, metavar="DIR")
    ap.add_argument("-a", "--arithmetic", choices=["u8", "u16", "u32", "u64", "u128"])
    ap.add_argument("--params", metavar="NAME")
    ap.add_argument("--test-params", action="store_true")
    ap.add_argument("--keys", metavar="DIR", help="persist keys (fhe/keys.py)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument(
        "--batch", default="8",
        help="vectors per evaluation (a fixed shape), or 'auto': the batch in "
        "1..--max-batch of least predicted cost a vector (helm_tpu_torch/batching.py)",
    )
    ap.add_argument("--max-batch", type=int, default=16, help="upper bound for --batch auto")
    ap.add_argument(
        "--linger", type=float, default=0.5,
        help="seconds to wait for more inputs before evaluating a partial batch",
    )
    ap.add_argument("--poll", type=float, default=0.2, help="watch-directory poll interval")
    ap.add_argument(
        "--max-batches", type=int, default=0, help="exit after N batches (0 = run forever)"
    )
    ap.add_argument(
        "--supervise", action="store_true",
        help="run the serving loop in a child process and restart it when it "
        "dies; inputs are only moved to done/ after their outputs are written, "
        "so a restart resumes cleanly from the watch directory",
    )
    ap.add_argument(
        "--max-restarts", type=int, default=3,
        help="supervisor: give up after N consecutive crash restarts",
    )
    ap.add_argument("--crash-after", type=int, default=0, help=argparse.SUPPRESS)
    # test hook: hard-exit(17) after N batches (restart-path testing)
    ap.add_argument(
        "--fuse-levels", action="store_const", const=True, default=None,
        help="force level fusion: one CUDA graph replay a batch (default: auto "
        "for narrow/deep circuits)",
    )
    ap.add_argument("--no-fuse-levels", dest="fuse_levels", action="store_const", const=False)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the plain torch versions)",
    )
    return ap


def _make_engine(args, netlist, device):
    from . import params as P

    if args.params:
        if args.params not in P.ALL_PARAMS:
            raise SystemExit(
                f"unknown --params {args.params!r}; known: {', '.join(sorted(P.ALL_PARAMS))}"
            )
        params = P.ALL_PARAMS[args.params]
    elif args.test_params:
        if args.arithmetic:
            params = P.TEST_PARAMS_ARITH
        else:
            params = P.TEST_PARAMS_LUT if netlist.has_luts else P.TEST_PARAMS
    else:
        params = None

    keys = None
    if args.keys:
        from .fhe.keys import load_or_generate

        if params is None:
            if args.arithmetic:
                params = P.DEFAULT_ARITH
            else:
                params = P.DEFAULT_LUT if netlist.has_luts else P.DEFAULT_GATES
        keys = load_or_generate(args.keys, params, args.seed, device)

    if args.arithmetic:
        from .engines.arith import ArithEngine

        return ArithEngine(args.arithmetic, params=params, seed=args.seed, keys=keys, device=device)
    from .engines.boolean import BooleanEngine

    return BooleanEngine(
        mode="lut" if netlist.has_luts else "gates",
        params=params, seed=args.seed, keys=keys, device=device,
        fuse_levels=args.fuse_levels,
    )


def _choose_batch(engine, args) -> int:
    """The batch: --batch, or under 'auto' the cost model's choice
    (`helm_tpu/serve.py:273-283`); prints the choice with its fill, or a
    fixed batch's underfill warning."""
    from .batching import check_batch, suggest_batch

    boolean = hasattr(engine, "plan")  # the arith engine has no level plan
    if str(args.batch) == "auto":
        if not boolean:  # radix rounds vary in width from gate to gate
            batch = min(8, args.max_batch)
            print(f"[serve] --batch auto -> {batch} (arith mode)", flush=True)
            return batch
        batch, table = suggest_batch(engine, args.max_batch)
        fill = next(t["fill"] for t in table if t["batch"] == batch)
        print(
            f"[serve] --batch auto -> {batch} ({fill:.0%} fill; candidates "
            f"{[(t['batch'], t['fill'], t['cost_per_vector']) for t in table]})",
            flush=True,
        )
        return batch
    batch = int(args.batch)
    warn = check_batch(engine, batch, args.max_batch) if boolean else None
    if warn:
        print(f"[serve] WARNING: {warn}", flush=True)
    return batch


#: a file is read only after its (size, mtime) has been unchanged this
#: long. Producers writing slower than this must write-then-rename
#: (rename is atomic, so the file is complete on first sight and only
#: pays the stability wait, never a truncated read).
STABLE_S = 0.5


def _stable_inputs(watch: str, stat_cache: dict, stable_s: float = STABLE_S) -> list[str]:
    """CSV files in `watch` whose (size, mtime) has been unchanged for
    `stable_s`, so that a slowly written file is never read truncated (and
    then wrongly quarantined). Zero-byte files are held for 2 s before
    being passed through (to a clean "no input wires parsed" quarantine)
    in case the writer has not flushed yet."""
    now = time.time()
    eligible = []
    seen = set()
    for f in sorted(os.listdir(watch)):
        path = os.path.join(watch, f)
        if not f.endswith(".csv") or not os.path.isfile(path):
            continue
        seen.add(f)
        try:
            st = os.stat(path)
        except OSError:
            continue
        key = (st.st_size, st.st_mtime_ns)
        prev = stat_cache.get(f)
        if prev is not None and prev[0] == key:
            hold = stable_s if st.st_size > 0 else max(stable_s, 2.0)
            if now - prev[1] >= hold:
                eligible.append(f)
        else:
            stat_cache[f] = (key, now)
    for f in list(stat_cache):
        if f not in seen:
            del stat_cache[f]
    return eligible


def _collect(
    watch: str, batch: int, linger: float, poll: float, stat_cache: dict | None = None
) -> list[str]:
    """Block until at least one stable input file exists (see
    _stable_inputs); then keep collecting until `batch` files or `linger`
    seconds of quiet."""
    if stat_cache is None:
        stat_cache = {}
    deadline = None
    while True:
        files = _stable_inputs(watch, stat_cache)[:batch]
        if files:
            if len(files) >= batch:
                return files
            if deadline is None:
                deadline = time.time() + linger
            elif time.time() >= deadline:
                return files
        time.sleep(poll)


def _supervise(argv: list[str]) -> int:
    """Restart-on-crash wrapper: run the serving loop as a child process
    and restart it on abnormal exit. File-based batching makes restarts
    safe: an input moves to done/ only after its output CSV is written."""
    import subprocess

    args = build_argparser().parse_args(argv)
    child_argv = [a for a in argv if a != "--supervise"]
    restarts = 0
    while True:
        rc = subprocess.call([sys.executable, "-m", "helm_tpu_torch.serve", *child_argv])
        if rc == 0:
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            print(f"[serve] giving up after {args.max_restarts} restarts (last rc={rc})", flush=True)
            return rc
        # the crash-injection hook must not re-fire in the restarted child:
        # the point is proving recovery, not crash-looping
        if "--crash-after" in child_argv:
            i = child_argv.index("--crash-after")
            del child_argv[i : i + 2]
        print(f"[serve] worker died (rc={rc}); restart {restarts}/{args.max_restarts}", flush=True)
        time.sleep(min(2.0 * restarts, 10.0))


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--supervise" in argv:
        return _supervise(list(argv))
    args = build_argparser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to run the plain torch versions)"
        )
    ptxt = args.arithmetic or "bool"
    netlist = read_verilog_file(args.verilog, args.arithmetic is not None)
    os.makedirs(args.outdir, exist_ok=True)
    done_dir = os.path.join(args.watch, "done")
    os.makedirs(done_dir, exist_ok=True)

    t0 = time.time()
    engine = _make_engine(args, netlist, device)
    engine.compile(netlist)
    batch = _choose_batch(engine, args)
    fused = getattr(engine, "fused", False)  # the arith engine has no level fusion
    print(
        f"[serve] engine ready in {time.time() - t0:.1f}s "
        f"(batch={batch}, device {device}, levels fused: {fused}, watching {args.watch})",
        flush=True,
    )

    # the required input wires, to vet each vector on the host before it
    # joins a batch: a malformed or truncated CSV is quarantined alone and
    # never sinks the batch (or the daemon) with it
    if hasattr(engine, "circuit"):  # arith engine
        required = set(engine.circuit.input_wires) - set(engine.netlist.dff_outputs)
    else:
        required = set(engine.plan.input_wires) - set(engine.plan.dff_outputs)
    failed_dir = os.path.join(args.watch, "failed")

    def _quarantine(name: str, err) -> None:
        os.makedirs(failed_dir, exist_ok=True)
        shutil.move(os.path.join(args.watch, name), os.path.join(failed_dir, name))
        with open(os.path.join(failed_dir, name + ".error.txt"), "w") as f:
            f.write(f"{err}\n")
        print(f"[serve] WARNING: rejected {name}: {err}", flush=True)

    native_loader.load()  # a failed build raises here, not as a malformed request
    batches = 0
    stat_cache: dict = {}
    while True:
        names = _collect(args.watch, batch, args.linger, args.poll, stat_cache)
        vecs, ok_names = [], []
        for f in names:
            try:
                vec = native_loader.read_input_wires(os.path.join(args.watch, f), ptxt)
                if not vec:
                    # a serving input that parses to nothing is a malformed
                    # file, not a request for all-false inputs
                    raise ValueError("no input wires parsed")
                if "dummy" not in vec:
                    missing = required - vec.keys()
                    if missing:
                        raise KeyError(
                            f"missing input wires: {sorted(missing)[:5]}"
                            + ("..." if len(missing) > 5 else "")
                        )
            except Exception as e:
                _quarantine(f, e)
                continue
            vecs.append(vec)
            ok_names.append(f)
        if not vecs:
            continue
        # a fixed batch shape: pad with repeats of the first vector
        padded = vecs + [vecs[0]] * (batch - len(vecs))
        t0 = time.time()
        replays = getattr(engine, "replays", 0)
        try:
            outs = engine.decrypt_outputs(engine.evaluate(engine.encrypt_inputs(padded)))
        except Exception as e:
            # an evaluation failure in process: quarantine the batch so the
            # daemon cannot hot-loop on it (a dying process is the
            # --supervise restart loop's)
            print(f"[serve] ERROR: evaluation failed: {e}", flush=True)
            for f in ok_names:
                _quarantine(f, e)
            continue
        dt = time.time() - t0
        for name, out in zip(ok_names, outs):
            dst = os.path.join(args.outdir, os.path.splitext(name)[0] + ".out.csv")
            csv_io.write_output_wires(dst, out)
            shutil.move(os.path.join(args.watch, name), os.path.join(done_dir, name))
        replayed = ", graph replay" if getattr(engine, "replays", 0) > replays else ""
        print(
            f"[serve] batch {batches}: {len(ok_names)} vectors in {dt:.3f}s "
            f"({dt / len(ok_names):.3f}s/vector{replayed})",
            flush=True,
        )
        batches += 1
        if args.crash_after and batches >= args.crash_after:
            # test hook for the --supervise restart path: die the hard way
            print("[serve] crash-after hook firing", flush=True)
            os._exit(17)
        if args.max_batches and batches >= args.max_batches:
            return 0


if __name__ == "__main__":
    sys.exit(main())
