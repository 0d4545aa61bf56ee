"""Replay the five BASELINE configs end to end through helm_tpu_torch,
against their recorded golden CSVs.

Counterpart of `tools/verify_baseline.py`, with the same five configs,
golden CSVs, `check`, `--fast`, `--only` and last line:

  1. 2-bit-adder          gates mode, recorded input + golden output CSV
  2. s27 x3 cycles        sequential gates, golden output CSV
  3. 8-bit-adder-lut-3-1  LUT mode, golden output CSV
  4. chi_squared u32      arith mode, 4 recorded input/output CSV sets
  5. c880-like            gates mode, recorded input + golden output CSV

Without `--fast` the configs run on the card at the production sets
GATES_128_K3, LUT_128_MB2 and ARITH_128_MB2 (the kernels K1 and, in arith
mode, K1 through the radix ops). `--fast` runs the tiny noise-free sets
TEST_PARAMS, TEST_PARAMS_LUT and TEST_PARAMS_ARITH on the CPU (the plain
torch versions). `--device` (default: cpu with `--fast`, else cuda) takes
the place of the reference's `--backend`; a missing card is an error,
never a quiet switch to the CPU. Every engine of one set shares one key
(the reference draws the same seed-5 key for each), so a set pays for its
keygen once; `main(argv, keys)` takes and fills a dict of (client key,
server key) by set name, so that a caller running other work at the same
sets (a test module, `chip_smoke.py`) pays for none.

    python -m helm_tpu_torch.tools.verify_baseline              # card, 128-bit sets
    python -m helm_tpu_torch.tools.verify_baseline --fast       # CPU, test sets
    python -m helm_tpu_torch.tools.verify_baseline --only c880  # one config

Exit code 0 iff every decrypted output matches its golden CSV bit-exactly.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from ..io import csv_io

ROOT = Path(__file__).resolve().parents[2]
SEED = 5  # the reference's key seed for every config


def check(name, got: dict, golden_csv: str, typ: str) -> bool:
    """True iff `got` equals the golden CSV on every output wire it lists
    (the reference's `check`)."""
    exp = csv_io.read_input_wires(golden_csv, typ)
    bad = {
        w: (got.get(w), v)
        for w, v in exp.items()
        if (bool(got.get(w)) if typ == "bool" else int(got.get(w, -1)))
        != (bool(v) if typ == "bool" else int(v))
    }
    if bad:
        print(f"[!] {name}: MISMATCH {bad}")
        return False
    print(f"[✓] {name}: {len(exp)} output wires bit-exact")
    return True


def main(argv=None, keys: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true", help="CPU + test params")
    ap.add_argument("--only", default="", help="substring filter")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default cpu with --fast, else cuda; cpu runs the plain torch versions)",
    )
    args = ap.parse_args(argv)

    import torch

    from .. import params as P
    from ..circuit.verilog import read_verilog_file
    from ..engines.arith import ArithEngine
    from ..engines.boolean import BooleanEngine
    from ..fhe import lwe
    from ..fhe.server_key import gen_server_key

    device = torch.device(args.device or ("cpu" if args.fast else "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"verify_baseline: --device {device}: no CUDA device is available "
            "(pass --fast, or --device cpu, to run the plain torch versions on the CPU)"
        )
    gates_p = P.TEST_PARAMS if args.fast else P.GATES_128_K3
    lut_p = P.TEST_PARAMS_LUT if args.fast else P.LUT_128_MB2
    arith_p = P.TEST_PARAMS_ARITH if args.fast else P.ARITH_128_MB2
    ok = True
    tc = ROOT / "benchmarks" / "test-cases"
    nlp = ROOT / "benchmarks" / "netlists"
    keys = {} if keys is None else keys

    def keys_for(params):
        if params.name not in keys:
            ck = lwe.keygen(params, SEED)
            keys[params.name] = (ck, gen_server_key(ck, device))
        return keys[params.name]

    def gates_cfg(name, netlist, inputs_csv, golden_csv, mode, params, cycles=1):
        nonlocal ok
        if args.only and args.only not in name:
            return
        t0 = time.time()
        nl = read_verilog_file(str(nlp / netlist))
        eng = BooleanEngine(mode=mode, params=params, keys=keys_for(params), device=device)
        eng.compile(nl)
        ins = csv_io.read_input_wires(str(tc / inputs_csv), "bool")
        wires = eng.encrypt_inputs(ins)
        for _ in range(cycles):
            wires = eng.evaluate(wires)
        out = eng.decrypt_outputs(wires)
        ok &= check(name, out, str(tc / golden_csv), "bool")
        print(f"    ({params.name}, {device.type}, {time.time() - t0:.3f}s)", flush=True)

    gates_cfg(
        "2-bit-adder (gates)", "2-bit-adder.v",
        "2-bit-adder.inputs.csv", "2-bit-adder.outputs.csv", "gates", gates_p,
    )
    gates_cfg(
        "s27 x3 (sequential gates)", "s27.v",
        "s27.inputs.csv", "s27_3cycles.outputs.csv", "gates", gates_p, cycles=3,
    )
    gates_cfg(
        "8-bit-adder-lut-3-1 (LUTs)", "8-bit-adder-lut-3-1.v",
        "8-bit-adder.inputs.csv", "8-bit-adder-lut-3-1.outputs.csv", "lut", lut_p,
    )
    gates_cfg(
        "c880-like (gates)", "c880-like.v",
        "c880-like.inputs.csv", "c880-like.outputs.csv", "gates", gates_p,
    )

    if not args.only or args.only in "chi_squared (arith u32)":
        t0 = time.time()
        nl = read_verilog_file(str(nlp / "chi_squared_arith.v"), True)
        eng = ArithEngine("u32", params=arith_p, keys=keys_for(arith_p), device=device)
        eng.compile(nl)
        for i in (1, 2, 3, 4):
            ins = csv_io.read_input_wires(str(tc / f"chi_squared_arith_{i}.inputs.csv"), "u32")
            out = eng.decrypt_outputs(eng.evaluate(eng.encrypt_inputs(ins)))
            ok &= check(
                f"chi_squared u32 set {i}", out,
                str(tc / f"chi_squared_arith_{i}.outputs.csv"), "u32",
            )
        print(f"    ({arith_p.name}, {device.type}, {time.time() - t0:.3f}s)", flush=True)

    print("ALL BIT-EXACT" if ok else "FAILURES — see above", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
