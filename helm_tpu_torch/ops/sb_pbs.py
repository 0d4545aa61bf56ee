"""Single-bit blind rotation on Hopper (K2).

Counterpart of the grouping-1 kernels of the JAX package:
`blind_rotate_sb` replaces both `helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu`
(K2a, :1652) and `helm_tpu/ops/pallas_pbs.py::blind_rotate_pallas` (K2b,
:339) with the hand-written CUDA kernel in `csrc/blind_rotate_sb.cu`: K1's
body (`csrc/rotate_tiles.cuh`: one launch per rotation, a cluster of NP
blocks per tile of gates, every step inside the launch) at grouping 1,
decomposing the rotated difference X^{a_i} acc - acc. It reads K1's key
layout (`mb_pbs.mb_server_key`: `bsk_k1` is the grouping-1 BSK
[n, rows, k+1, NP, N] chunked as K1's at g = 1) and tile plan
(`mb_pbs.plan_for`). Its plain version is `fhe/pbs.py::blind_rotate` (the
twin of `pbs_jnp.blind_rotate`).

Dispatch is by the device of the input tensor: on the CPU the plain
version runs; on a CUDA tensor the kernel is launched, or an error is
raised — there is no fallback.
"""

from __future__ import annotations

import torch

from ..fhe import pbs
from .mb_pbs import K2_BUILDS, check_build, check_inputs, rotate_tiles


def blind_rotate_sb(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Single-bit blind rotation [G, n+1] words -> [G, k+1, N] words.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    once per rotation (`blind_rotate_sb.launches` counts the launches)."""
    p = dsk.params
    if p.grouping != 1:
        raise ValueError(f"{p.name}: grouping {p.grouping}; the single-bit kernel takes 1")
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_sb: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_sb")
    check_build(p, K2_BUILDS, "K2")
    out = rotate_tiles("blind_rotate_sb", dsk, lwe_in, testv)
    blind_rotate_sb.launches += 1
    return out


blind_rotate_sb.launches = 0
