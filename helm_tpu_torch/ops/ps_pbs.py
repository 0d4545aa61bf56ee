"""Prime-split multi-bit blind rotation on Hopper (K6).

Counterpart of `helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_ps` (:2425, body
`_make_kernel_fs_ps` :2127): `blind_rotate_ps` launches the hand-written
CUDA kernel in `csrc/blind_rotate_ps.cu` (one launch per CMux group, a
cluster of NP blocks per gate, the primes folded by CRT partial sums
through distributed shared memory), and `ps_server_key` replaces the BSK
layout `mxu_server_key_ps` (:2014), cached per key as `mb_server_key` is.
Its plain version is `fhe/pbs.py::blind_rotate_prime_split`. K6 computes
K1's function, so `mb_pbs.bootstrap` runs it in K1's place when
HELM_TPU_MB_KERNEL=ps.

The TPU kernel refuses sets whose gadget rows reach its float32 chunk
("chunk > rows": LUT_128_K2, ARITH_128_MB2); the limit is the TPU's f32
mantissa, not the function's, and K6 takes every multi-bit set.

Dispatch is by the device of the input tensor: on the CPU the plain
version runs; on a CUDA tensor the kernel is launched, or an error is
raised — there is no fallback.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import torch

from ..fhe import ops, pbs
from ..fhe.modring import NUM_PRIMES
from ..fhe.ntt import crt_constants, from_i32_bits, to_i32_bits
from . import build
from .mb_pbs import check_inputs, mb_server_key

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (
    [_P] * 9
    + [ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double)]
    + [_I] * 9
    + [_P]
)


@dataclass(frozen=True, eq=False)
class PsKernelKey:
    """K6's view of one server key: the BSK permuted prime-outermost,
    [n/g, NP, 2^g-1, rows, k+1, N] (as `mxu_server_key_ps` puts the prime
    right after the group), so that the block of (gate, prime) reads one
    contiguous slab per group; and the CRT fold's constants."""

    bsk: torch.Tensor  # i32 bit patterns
    crt_w: ctypes.Array  # u32 [NP]: W_i mod 2^32
    crt_frac: ctypes.Array  # f64 [NP]: W_i / P


_layouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def ps_server_key(dsk: pbs.DeviceServerKey) -> PsKernelKey:
    """K6's key layout of `dsk`, built on first use and cached per key."""
    got = _layouts.get(dsk)
    if got is not None:
        return got
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(f"{p.name}: grouping {p.grouping}; K6 takes multi-bit keys")
    nv1 = (1 << p.grouping) - 1
    bsk = dsk.bsk_ntt.reshape(p.n // p.grouping, nv1, p.gadget_rows, p.k + 1, NUM_PRIMES, p.N)
    c = crt_constants(p.N)
    key = PsKernelKey(
        bsk=bsk.permute(0, 4, 1, 2, 3, 5).contiguous(),
        crt_w=(ctypes.c_uint32 * NUM_PRIMES)(*c.w_mod),
        crt_frac=(ctypes.c_double * NUM_PRIMES)(*c.frac),
    )
    _layouts[dsk] = key
    return key


def blind_rotate_ps(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Prime-split multi-bit blind rotation [G, n+1] words -> [G, k+1, N]
    words, the same function as `mb_pbs.blind_rotate_mb`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`blind_rotate_ps.launches` counts the launches)."""
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(
            f"{p.name}: grouping {p.grouping}; K6 is a multi-bit kernel "
            "(grouping 1 is the single-bit kernel's, ops/sb_pbs.py)"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_prime_split(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_ps: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_ps")
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    key = mb_server_key(dsk)  # twiddles, monomial tables, constants
    pkey = ps_server_key(dsk)
    acc = to_i32_bits(pbs.initial_acc(p, lwe_in, testv)).contiguous()
    abar = ops.mod_switch(lwe_in[:, :n], N).to(torch.int32).contiguous()
    (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
    rc = build.entry("blind_rotate_ps", _ARGTYPES)(
        acc.data_ptr(), abar.data_ptr(), pkey.bsk.data_ptr(),
        key.psi.data_ptr(), key.psi_sh.data_ptr(),
        key.psi_inv.data_ptr(), key.psi_inv_sh.data_ptr(),
        key.pw.data_ptr(), key.ef.data_ptr(),
        key.consts, pkey.crt_w, pkey.crt_frac,
        G, n, N, k, p.grouping, mbl, mlv, bl, lv,
        torch.cuda.current_stream(lwe_in.device).cuda_stream,
    )
    build.check(rc, "helm_blind_rotate_ps")
    blind_rotate_ps.launches += 1
    return from_i32_bits(acc)


blind_rotate_ps.launches = 0
