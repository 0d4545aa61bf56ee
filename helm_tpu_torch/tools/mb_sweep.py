"""Multi-bit blind-rotation sweep on a torch device: rotations per second
of one multi-bit kernel at one batch width.

Counterpart of `tools/mb_sweep.py`, with the same environment knobs:
PSET (a set of `helm_tpu_torch.params`, default GATES_TPU_MB2), G (gates
per rotation, default 1024), GTS (comma list, default 32), LAYOUT (the
kernel: fs, fs16, hb, hb2 -> K1 `mb_pbs.blind_rotate_mb`; ps -> K6; ts ->
K4; gm, the default -> K3 `gm_pbs.blind_rotate_gm`, the only path to
K3). The Hopper kernels choose their own gate tiles, so each GTS value is
accepted, printed and ignored. ABLATES names the TPU kernels' Mosaic
ablation probes; they do not exist here, and a non-empty value exits.

    PSET=GATES_128_K3 G=1024 LAYOUT=ts python -m helm_tpu_torch.tools.mb_sweep

Keys are cached in the reference's npz format (`fhe/keys.py`) under
`build/mb_sweep_keys/` at the repository root (or `--keys DIR`), so a
repeated sweep skips keygen. Prints one line per GTS value:
`{layout} gt={gt} (ignored: ...): X rot/s (first call Y s)`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import params as P
from ..fhe import lwe, pbs
from ..fhe.ntt import words

KEYS_DIR = Path(__file__).resolve().parents[2] / "build" / "mb_sweep_keys"
LAYOUTS = ("fs", "fs16", "ps", "ts", "hb", "hb2", "gm")
ITERS = 6  # timed rotations per GTS value, as in the original


def rotation(layout: str):
    """The blind rotation a LAYOUT value names (see the module docstring)."""
    if layout not in LAYOUTS:
        raise SystemExit(f"LAYOUT={layout!r}: one of {', '.join(LAYOUTS)}")
    if layout == "ps":
        from ..ops.ps_pbs import blind_rotate_ps

        return blind_rotate_ps
    if layout == "ts":
        from ..ops.ts_pbs import blind_rotate_ts

        return blind_rotate_ts
    if layout == "gm":
        from ..ops.gm_pbs import blind_rotate_gm

        return blind_rotate_gm
    from ..ops.mb_pbs import blind_rotate_mb

    return blind_rotate_mb


def and_bits(G: int):
    """The original's input bits: two rows of G from a numpy seed of 0."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2, G).astype(bool), rng.integers(0, 2, G).astype(bool)


def inputs(ck, G: int, device):
    """The original's rotation inputs: G AND-gate pre-images of
    `and_bits(G)`, and the gates test polynomial."""
    p = ck.params
    b1, b2 = and_bits(G)
    lin = (lwe.encrypt(ck, lwe.encode_bool(b1)) + lwe.encrypt(ck, lwe.encode_bool(b2))).astype(np.uint32)
    lin[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
    return words(lin, device), words(pbs.gates_test_poly(p), device)


def sweep(dsk, ck, layout: str, G: int, gts) -> list[float]:
    """Rotations per second of `layout` at G gates, once per GTS value,
    each after one untimed first call; prints the original's lines."""
    fn = rotation(layout)
    x, tv = inputs(ck, G, dsk.device)

    def sync():
        if dsk.device.type == "cuda":
            torch.cuda.synchronize(dsk.device)

    rates = []
    for gt in gts:
        t0 = time.time()
        fn(dsk, x, tv)
        sync()
        first = time.time() - t0
        t0 = time.time()
        for _ in range(ITERS):
            fn(dsk, x, tv)
        sync()
        rate = G * ITERS / (time.time() - t0)
        rates.append(rate)
        print(sweep_line(layout, gt, rate, first), flush=True)
    return rates


def sweep_line(layout: str, gt: int, rate: float, first: float) -> str:
    """The line a sweep prints per GTS value (tools/collect_results.py reads it)."""
    return (f"{layout} gt={gt} (ignored: the Hopper kernels choose their own tiles): "
            f"{rate:.1f} rot/s (first call {first:.1f}s)")


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--keys", default=str(KEYS_DIR), metavar="DIR", help="key cache directory")
    args = ap.parse_args(argv)
    if env.get("ABLATES", ""):
        raise SystemExit(
            f"ABLATES={env['ABLATES']!r}: the ablation probes are Mosaic knobs of the TPU "
            "kernels (ROADMAP.md, 'What the port leaves out'); leave ABLATES unset"
        )
    name = env.get("PSET", "GATES_TPU_MB2")
    params = getattr(P, name, None)
    if not isinstance(params, P.TfheParams):
        raise SystemExit(f"PSET={name!r} names no parameter set of helm_tpu_torch.params")
    layout = env.get("LAYOUT", "gm")
    rotation(layout)  # refuse an unknown layout before keygen
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    from ..fhe.keys import load_or_generate

    ck, sk = load_or_generate(args.keys, params, 7, device)
    dsk = pbs.DeviceServerKey.from_host(sk, device)
    G = int(env.get("G", "1024"))
    gts = [int(v) for v in env.get("GTS", "32").split(",")]
    sweep(dsk, ck, layout, G, gts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
