"""Prime-split multi-bit blind rotation on Hopper (K6).

Counterpart of `helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_ps` (:2425, body
`_make_kernel_fs_ps` :2127): `blind_rotate_ps` launches the hand-written
CUDA kernel in `csrc/blind_rotate_ps.cu`, K1's body (`csrc/rotate_tiles.cuh`:
one launch per rotation, a cluster of NP blocks per tile of gates) with
the primes folded by CRT partial sums through distributed shared memory in
place of Garner. It reads K1's key layout (`mb_pbs.mb_server_key`: the
chunked `bsk_k1`, the pass-ordered twiddles) and tile plan
(`mb_pbs.plan_for`); the TPU kernel's prime-outermost BSK copy
(`mxu_server_key_ps` :2014) has no counterpart. Its plain version is
`fhe/pbs.py::blind_rotate_prime_split`. K6 computes K1's function, so
`mb_pbs.bootstrap` runs it in K1's place when HELM_TPU_MB_KERNEL=ps.

The TPU kernel refuses sets whose gadget rows reach its float32 chunk
("chunk > rows": LUT_128_K2, ARITH_128_MB2); the limit is the TPU's f32
mantissa, not the function's, and K6 takes every multi-bit set.

Dispatch is by the device of the input tensor: on the CPU the plain
version runs; on a CUDA tensor the kernel is launched, or an error is
raised — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..fhe import pbs
from ..fhe.modring import NUM_PRIMES
from ..fhe.ntt import crt_constants
from .mb_pbs import K6_BUILDS, check_build, check_inputs, rotate_tiles


def crt_args(N: int) -> tuple:
    """The CRT fold's constants as K6's C entry takes them, after the
    Garner constants: (ctypes type, value) of W_i mod 2^32 (u32 [NP]) and
    of W_i / P (f64 [NP]) (`ntt.crt_constants`)."""
    c = crt_constants(N)
    return (
        (ctypes.POINTER(ctypes.c_uint32), (ctypes.c_uint32 * NUM_PRIMES)(*c.w_mod)),
        (ctypes.POINTER(ctypes.c_double), (ctypes.c_double * NUM_PRIMES)(*c.frac)),
    )


def blind_rotate_ps(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Prime-split multi-bit blind rotation [G, n+1] words -> [G, k+1, N]
    words, the same function as `mb_pbs.blind_rotate_mb`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    once per rotation (`blind_rotate_ps.launches` counts the launches)."""
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(
            f"{p.name}: grouping {p.grouping}; K6 has no grouping-1 build "
            "(grouping-1 sets take K2, ops/sb_pbs.py; K1 takes them too)"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_prime_split(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_ps: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_ps")
    check_build(p, K6_BUILDS, "K6")
    out = rotate_tiles("blind_rotate_ps", dsk, lwe_in, testv, crt_args(p.N))
    blind_rotate_ps.launches += 1
    return out


blind_rotate_ps.launches = 0
