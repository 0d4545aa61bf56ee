"""The benchmark of helm_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 helmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. It makes the
keys and inputs from the seed, warms up the cell's own shape, measures
for `--seconds`, judges the window's outputs against the plain reference
(`helmbench/reference.py`), and prints one JSON line last: the cell's
end-to-end metrics (`--trace 0`) or its per-layer metrics from a
torch.profiler trace of the window (`--trace 1`). The numbers compared
with their limits are the last lines on standard error and the last key
of the line. It exits non-zero, with no line, without a card, or when JAX
or the JAX package is loaded in this process.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded: JAX and the JAX package
#: (compared whole: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "helm_tpu")
#: the program's switches of route and randomness; a run takes its defaults
PROGRAM_KNOBS = ("HELM_TPU_MB_KERNEL", "HELM_TPU_TS_KERNEL", "HELM_TPU_INSECURE_PRNG")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check_isolation(when: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"helmbench: {when}, this process has loaded {found}", file=sys.stderr)
        sys.exit(3)


def set_environment() -> None:
    """Build caches at fixed paths inside the checkout; the program's
    defaults for its route and randomness."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for knob in PROGRAM_KNOBS:
        os.environ.pop(knob, None)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))

    import torch

    from helmbench.harness import find_cell, load_json, run_cell

    spec = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"helmbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    check_isolation("after the window")
    print(f"helmbench: {card_line()}", file=sys.stderr)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    check_isolation("at exit")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
