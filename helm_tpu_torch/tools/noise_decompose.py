"""The measured PBS output error split by stage, on a torch device: the
port of `tools/noise_decompose.py`.

`noise_validate` measures the end-to-end output-phase std against
sqrt(var_pbs_out + var_ks); this tool says which term is off. It decrypts
the big-LWE ciphertext between sample extract and keyswitch
(`lwe.decrypt_phase(big=True)`) and again after the keyswitch, giving

  - the empirical var(blind rotation + sample extract) vs params.var_pbs_out()
  - the empirical var(keyswitch contribution)          vs params.var_ks()
    (the post-keyswitch error minus the pre-keyswitch one: the exact
    additive keyswitch noise of each sample)

On the card the rotation is the kernel path (`mb_pbs.blind_rotation`: K1
at the multi-bit sets, K2 at grouping 1), then sample extract and the
keyswitch; the reference ran its jnp pipeline on the CPU because its
chip was busy. Keys: the bench's key cache, as `noise_validate`.

    python -m helm_tpu_torch.tools.noise_decompose                # the card
    PSET=TEST_NOISY_GATES_MB SAMPLES=128 G=64 python -m helm_tpu_torch.tools.noise_decompose --device cpu

Env: PSET (default GATES_128_K3), SAMPLES (default 8192), G (default
2048), SEED (default 7). Output: one RESULT JSON line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

from ..fhe import lwe, ops, pbs
from ..fhe.ntt import to_host, words
from .family_bench import params_named
from .noise_validate import and_batch, phase_error, server_keys
from .probe_timing import device_arg


def stage_errors(ck, dsk, rng, G: int) -> tuple[np.ndarray, np.ndarray]:
    """One batch: (the big-LWE phase errors after sample extract, the
    output phase errors after the keyswitch) of G AND bootstraps."""
    from ..ops import mb_pbs

    p = ck.params
    lin, exp = and_batch(ck, rng, G)
    tv = words(pbs.gates_test_poly(p), dsk.device)
    acc = mb_pbs.blind_rotation(p)(dsk, words(lin, dsk.device), tv)
    big = ops.sample_extract(acc, p.k, p.N)
    small = pbs.keyswitch(dsk, big)
    e_pbs = phase_error(lwe.decrypt_phase(ck, to_host(big), big=True), exp)
    e_out = phase_error(lwe.decrypt_phase(ck, to_host(small)), exp)
    return e_pbs, e_out


def run(env, device, keys=None) -> dict:
    p = params_named(env.get("PSET", "GATES_128_K3"))
    samples = int(env.get("SAMPLES", "8192"))
    G = int(env.get("G", "2048"))
    seed = int(env.get("SEED", "7"))
    ck, dsk = server_keys(p, device, seed, keys)
    rng = np.random.default_rng(seed)
    sq_pbs = sq_out = sq_ks = 0.0
    total = 0
    t0 = time.time()
    for _ in range((samples + G - 1) // G):
        e_pbs, e_out = stage_errors(ck, dsk, rng, G)
        e_ks = e_out - e_pbs  # the exact keyswitch noise of each sample
        sq_pbs += float((e_pbs.astype(np.float64) ** 2).sum())
        sq_out += float((e_out.astype(np.float64) ** 2).sum())
        sq_ks += float((e_ks.astype(np.float64) ** 2).sum())
        total += G
        print(
            f"[{total}/{samples}] pbs_std_ratio={math.sqrt(sq_pbs / total) / math.sqrt(p.var_pbs_out()):.4f} "
            f"ks_std_ratio={math.sqrt(sq_ks / total) / math.sqrt(p.var_ks()):.4f} "
            f"out_std_ratio={math.sqrt(sq_out / total) / math.sqrt(p.var_pbs_out() + p.var_ks()):.4f} "
            f"({time.time() - t0:.0f}s)",
            flush=True,
        )
    res = {
        "params": p.name, "samples": total,
        "pbs_std_model": round(math.sqrt(p.var_pbs_out()), 1),
        "pbs_std_measured": round(math.sqrt(sq_pbs / total), 1),
        "ks_std_model": round(math.sqrt(p.var_ks()), 1),
        "ks_std_measured": round(math.sqrt(sq_ks / total), 1),
        "out_std_model": round(math.sqrt(p.var_pbs_out() + p.var_ks()), 1),
        "out_std_measured": round(math.sqrt(sq_out / total), 1),
    }
    res["pbs_var_ratio"] = round((res["pbs_std_measured"] / res["pbs_std_model"]) ** 2, 4)
    res["ks_var_ratio"] = round((res["ks_std_measured"] / res["ks_std_model"]) ** 2, 4)
    print("RESULT " + json.dumps(res), flush=True)
    return res


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    run(env, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
