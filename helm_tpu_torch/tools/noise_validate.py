"""Measured PBS noise against the model, on a torch device: the port of
`tools/noise_validate.py`.

Measures the post-bootstrap phase error over SAMPLES gate bootstraps at
PSET (default GATES_128_K3) and holds it against the analytical model
behind every `pbs_failure_log2`:

  - measured phase-error std vs sqrt(var_pbs_out + var_ks)  (the model)
  - worst observed |error| vs the gates decision margin q/8
  - decision failures (expected 0 below ~2^25 samples at GATES_128_K3's
    modelled rate of 2^-37 a bootstrap)
  - a 12-bin histogram of |error| in model sigmas

The pipeline is the gate path of the port: fresh host encryption -> AND
linear combination -> `mb_pbs.bootstrap` (on the card: the blind rotation
by its kernel, K1 at the multi-bit sets, K2 at grouping 1; then sample
extract and keyswitch; on the CPU their plain versions) -> host
decrypt_phase. Keys come from the bench's key cache
(`helm_tpu_torch.bench._keys`, under build/bench_keys or
$BENCH_KEY_CACHE), generated there from SEED on first use.

    python -m helm_tpu_torch.tools.noise_validate                 # the card
    PSET=TEST_NOISY_GATES_MB SAMPLES=256 G=64 python -m helm_tpu_torch.tools.noise_validate --device cpu

Env: PSET, SAMPLES (default 2^20), G (a batch, default 2048), SEED
(default 7). Output: one RESULT JSON line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

from .. import params as P
from ..fhe import lwe, pbs
from ..fhe.ntt import to_host, words
from .family_bench import params_named
from .probe_timing import device_arg


def server_keys(p, device, seed: int, keys=None):
    """(client key, device server key) at p: `keys[p.name]` = (client
    key, server key) when given, else the bench's key cache."""
    if keys is not None and p.name in keys:
        ck, sk = keys[p.name]
    else:
        from ..bench import _keys

        ck, sk = _keys(p, device, seed)
    return ck, pbs.DeviceServerKey.from_host(sk, device)


def and_batch(ck, rng, G: int):
    """G AND-gate pre-images of random bit pairs (the reference's) and
    their expected phases."""
    p = ck.params
    b1 = rng.integers(0, 2, G).astype(bool)
    b2 = rng.integers(0, 2, G).astype(bool)
    lin = (lwe.encrypt(ck, lwe.encode_bool(b1)) + lwe.encrypt(ck, lwe.encode_bool(b2))).astype(np.uint32)
    lin[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
    exp = np.where(b1 & b2, 1 << 29, (-(1 << 29)) % (1 << 32)).astype(np.int64)
    return lin, exp


def phase_error(ph: np.ndarray, exp: np.ndarray) -> np.ndarray:
    """Signed error of the phases against the expected ones, mod 2^32."""
    return ((ph.astype(np.int64) - exp + (1 << 31)) % (1 << 32)) - (1 << 31)


def errors(ck, dsk, rng, G: int) -> np.ndarray:
    """One batch: the output phase errors of G AND bootstraps."""
    from ..ops import mb_pbs

    lin, exp = and_batch(ck, rng, G)
    tv = words(pbs.gates_test_poly(ck.params), dsk.device)
    out = to_host(mb_pbs.bootstrap(dsk, words(lin, dsk.device), tv))
    return phase_error(lwe.decrypt_phase(ck, out), exp)


def run(env, device, keys=None) -> dict:
    p = params_named(env.get("PSET", "GATES_128_K3"))
    samples = int(env.get("SAMPLES", str(1 << 20)))
    G = int(env.get("G", "2048"))
    seed = int(env.get("SEED", "7"))
    ck, dsk = server_keys(p, device, seed, keys)
    rng = np.random.default_rng(seed)
    model = math.sqrt(p.var_pbs_out() + p.var_ks())
    margin = float(P.Q) / 8.0  # gates decision margin (pbs_failure_log2)
    n_batches = (samples + G - 1) // G
    errs_sq, worst, fails, total = 0.0, 0, 0, 0
    hist = np.zeros(12, dtype=np.int64)  # |err| in [s, s+1) model sigmas
    t_start = time.time()
    for bi in range(n_batches):
        err = errors(ck, dsk, rng, G)
        errs_sq += float((err.astype(np.float64) ** 2).sum())
        worst = max(worst, int(np.abs(err).max()))
        fails += int((np.abs(err) >= margin).sum())
        hist += np.bincount(np.minimum((np.abs(err).astype(np.float64) / model).astype(np.int64), 11),
                            minlength=12)
        total += G
        if bi % 32 == 0 or bi == n_batches - 1:
            el = time.time() - t_start
            print(f"[{bi + 1}/{n_batches}] {total} samples, std_ratio={math.sqrt(errs_sq / total) / model:.4f}, "
                  f"worst={worst / model:.2f} sigma, fails={fails} ({total / el:.0f} bs/s incl host)", flush=True)
    measured = math.sqrt(errs_sq / total)
    res = {
        "params": p.name, "samples": total,
        "model_std": round(model, 1), "measured_std": round(measured, 1),
        "std_ratio": round(measured / model, 4),
        "worst_abs_err_sigma": round(worst / model, 2), "margin_sigma": round(margin / model, 2),
        "decision_failures": fails, "model_failure_log2": round(p.pbs_failure_log2(), 1),
        "hist_abs_err_sigma": hist.tolist(),
        "seconds": round(time.time() - t_start, 3),
    }
    print("RESULT " + json.dumps(res), flush=True)
    return res


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    return 0 if run(env, device)["decision_failures"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
