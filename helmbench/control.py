"""The check's control and its planted faults: runs of a cell whose
`correct` has to come out false. The benchmark's own runs never take
these paths.

- The control, `bsk_rounded`: the program computes with a bootstrapping
  key held at `bits` bits of precision (each 32-bit torus word of the
  coefficient-domain GGSW key rounded to a multiple of 2^(32 - bits)
  before the key goes into the NTT domain). The configuration states exact
  32-bit words and a noise level (its failure rate a bootstrap); its
  `control.bsk_bits` is the widest rounding that breaks that guarantee
  by the set's noise model and reads three times the sound runs' noise
  or more.
- The faults (`FAULTS`), planted in the timed path under the harness:
  `state_unchanged` (evaluate hands its input back), `half_batch` (only
  the first half of a batch is evaluated, its outputs stand in for the
  rest; cells with batches of one cannot have it) and `answer_altered`
  (one output ciphertext of each request moved to another message where
  it is produced). The exchange between chips has no fault: every cell
  runs on one.

On the card, the control at a cell's own size and window (`--bits`
overrides the configuration's):

    python3 helmbench/control.py --workload <cell> --seeds 11,12,13 --seconds 30
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def bsk_rounded(bits: int):
    """The program's keygen with every coefficient-domain BSK word rounded
    to the nearest multiple of 2^(32 - bits), ties to even, before its
    forward NTT. Ties to even keep the rounding error's mean at 0: rounding
    ties up adds half a unit to every word, an offset that the external
    product multiplies into far more noise than the rounding's spread."""
    from helm_tpu_torch.fhe import server_key

    fwd = server_key._fwd
    step = 1 << (32 - bits)

    def rounded(raw, device):
        words = np.asarray(raw, dtype=np.uint32).astype(np.uint64)
        q, r = words // step, words % step
        q += (r > step // 2) | ((r == step // 2) & (q % 2 == 1))
        return fwd(((q * step) % (1 << 32)).astype(np.uint32), device)

    server_key._fwd = rounded
    try:
        yield
    finally:
        server_key._fwd = fwd


def _batch_dim(wires) -> int:
    """The batch axis of a batched wire table: gates [B, W, n+1], arith
    [W, B, nb, n+1]."""
    return 0 if wires.dim() == 3 else 1


def state_unchanged(engine, layout):
    engine.evaluate = lambda wires, verbose=False: wires
    return engine


def half_batch(engine, layout):
    evaluate = engine.evaluate

    def half(wires, verbose=False):
        import torch

        d = _batch_dim(wires)
        B = wires.shape[d]
        out = evaluate(wires.narrow(d, 0, B // 2).contiguous())
        stand_in = torch.arange(B - B // 2, device=out.device) % (B // 2)
        return torch.cat([out, out.index_select(d, stand_in)], dim=d)

    engine.evaluate = half
    return engine


def answer_altered(engine, layout):
    evaluate = engine.evaluate
    n = engine.params.n
    shift = (1 << 32) >> 1 if engine.params.message_bits == 1 else engine.params.delta

    def altered(wires, verbose=False):
        out = evaluate(wires).clone()
        first = layout.outputs[0]
        if out.dim() == 2:  # gates, one vector
            out[first, n] = (out[first, n] + shift) % (1 << 32)
        elif out.dim() == 3:  # gates, a batch
            out[:, first, n] = (out[:, first, n] + shift) % (1 << 32)
        else:  # arith: the first block of the first output
            out[first, :, 0, n] = (out[first, :, 0, n] + shift) % (1 << 32)
        return out

    engine.evaluate = altered
    return engine


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "answer_altered": answer_altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--bits", type=int, default=None, help="the BSK's precision (default: the configuration's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from helmbench import run as runner

    runner.set_environment()
    import torch

    from helmbench.harness import find_cell, load_config, load_json, run_cell

    if not torch.cuda.is_available():
        print("helmbench control: no CUDA device", file=sys.stderr)
        return 2
    spec = load_json(ROOT / "BENCHMARK.json")
    bits = args.bits or load_config(find_cell(spec, args.workload)["config"])["control"]["bsk_bits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with bsk_rounded(bits):
            out = run_cell(spec, args.workload, seed, args.seconds, False, "cuda", t0)
        print(json.dumps({"control": f"bsk_rounded({bits})", "workload": args.workload, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "failed": out["failed"], "noise_rms": out["noise_rms"], "noise_max": out["noise_max"],
                          "checks": out["checks"]}), flush=True)
    print(f"helmbench control: {runner.card_line()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
