"""A/B of grouping 1 through the multi-bit kernel K1, on a torch device.

Counterpart of `tools/g1_fs_test.py`: GATES_128_K3 with grouping 1
(`gates_128_k3_g1`) on a key from `gen_bsk_multibit` ([n, 1, rows, k+1,
NP, N]: one subset polynomial a step, P_1 = X^a - 1), G AND gates through
`mb_pbs.blind_rotate_mb` (K1), one rotation decrypt-verified after sample
extract, then 6 timed rotations. The grouping-2 side of the A/B is the
set itself through the same kernel (`mb_sweep`, chip_smoke.py phase
`tools`, which also times K2 on the g = 1 set: the port's production route
for a grouping-1 set).

    python -m helm_tpu_torch.tools.g1_fs_test                # on cuda
    python -m helm_tpu_torch.tools.g1_fs_test --device cpu   # plain version

Environment knobs, the reference's: G (gates, default 1024; 8 with
`--device cpu`) and GT (the TPU kernel's gate tile: accepted, printed and
ignored, as `mb_sweep` ignores GTS; the Hopper kernel chooses its own).
`--device cpu` takes the reference's INTERP=1 branch: the tiny k=3 set
(`test_tiny_k3_g1`) through the plain version, decrypt-verified, no timing
(the CPU tests hold it word for word against the reference's
`pbs_jnp.blind_rotate_multibit`). Keys come from keygen at seed 7 and, on
the card, are cached in the reference's npz format under
`build/g1_fs_keys/` at the repository root (or `--keys DIR`). Prints the
reference's lines: `params: ...`, `keygen ...s`, `compile+first ...s`,
`decrypt-verified ok` and `g1 fs gt=...: X rot/s`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

from .. import params as P
from ..fhe import keys as K
from ..fhe import lwe, ops, pbs, server_key
from ..fhe.ntt import to_host
from ..ops import mb_pbs
from .mb_sweep import and_bits, inputs

KEYS_DIR = Path(__file__).resolve().parents[2] / "build" / "g1_fs_keys"
ITERS = 6  # timed rotations, as in the original


def g1_params(cpu: bool) -> P.TfheParams:
    """The reference's set: GATES_128_K3 (TEST_PARAMS_K3 on the CPU) at
    grouping 1, named with `_g1`."""
    base = P.TEST_PARAMS_K3 if cpu else P.GATES_128_K3
    return replace(base, name=base.name + "_g1", grouping=1)


def g1_keys(p: P.TfheParams, device, cache_dir=None):
    """(client, server) keys for p at grouping 1 with the multi-bit BSK
    layout (`gen_bsk_multibit`), keygen at seed 7; loaded from and saved to
    `cache_dir` when given."""
    if cache_dir is not None:
        ckp, skp = (os.path.join(cache_dir, f"{w}_{p.name}.npz") for w in ("ck", "sk"))
        if os.path.exists(skp):
            try:
                return K.load_client_key(ckp, p), K.load_server_key(skp, p)
            except ValueError as e:
                print(f"key cache invalid ({e})", flush=True)
    ck = lwe.keygen(p, seed=7)
    bsk_ntt, bsk_sh = server_key.gen_bsk_multibit(ck, device)  # g = 1 grouped layout
    sk = server_key.ServerKey(p, bsk_ntt, bsk_sh, server_key.gen_ksk(ck))
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        K.save_client_key(ckp, ck)
        K.save_server_key(skp, sk)
    return ck, sk


def check_ands(ck, acc: torch.Tensor, what: str) -> None:
    """Raise unless the rotation `acc` of `mb_sweep.inputs(ck, G)`
    decrypts (sample extract of coefficient 0, phase under the extracted
    key) to the AND of `and_bits(G)`."""
    p = ck.params
    big = ops.sample_extract(acc, p.k, p.N)
    got = lwe.decode_bool(lwe.decrypt_phase(ck, to_host(big), big=True))
    b1, b2 = and_bits(acc.shape[0])
    bad = int((got != (b1 & b2)).sum())
    assert bad == 0, f"{what} rotation WRONG ({bad}/{acc.shape[0]})"


def run(ck, dsk, G: int, gt: int, timed: bool = True) -> None:
    """One rotation of G AND pre-images through K1, decrypt-verified
    against the truth table (AssertionError otherwise), then ITERS timed
    ones when `timed`; prints the reference's lines from `compile+first`
    on."""
    x, tv = inputs(ck, G, dsk.device)

    def sync():
        if dsk.device.type == "cuda":
            torch.cuda.synchronize(dsk.device)

    t0 = time.time()
    acc = mb_pbs.blind_rotate_mb(dsk, x, tv)
    sync()
    first = time.time() - t0
    print(f"compile+first {first:.1f}s", flush=True)
    check_ands(ck, acc, "g=1 fs")
    print("decrypt-verified ok", flush=True)
    if timed:
        t0 = time.time()
        for _ in range(ITERS):
            mb_pbs.blind_rotate_mb(dsk, x, tv)
        sync()
        print(f"g1 fs gt={gt}: {G * ITERS / (time.time() - t0):.1f} rot/s", flush=True)


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu: the plain version)")
    ap.add_argument("--keys", default=str(KEYS_DIR), metavar="DIR", help="key cache directory (card only)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cpu = device.type == "cpu"
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    p = g1_params(cpu)
    print(f"params: {p.name} n={p.n} k={p.k} N={p.N} l={p.pbs_level} g=1", flush=True)
    t0 = time.time()
    ck, sk = g1_keys(p, device, None if cpu else args.keys)
    print(f"keygen {time.time() - t0:.1f}s", flush=True)
    dsk = pbs.DeviceServerKey.from_host(sk, device)
    G = int(env.get("G", "8" if cpu else "1024"))
    gt = int(env.get("GT", "8" if cpu else "512"))
    run(ck, dsk, G, gt, timed=not cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
