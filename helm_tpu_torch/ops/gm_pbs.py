"""Gate-major multi-bit blind rotation on Hopper (K3).

Counterpart of `helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu_mb` (:1811, body
`_make_kernel_mb` :567): `blind_rotate_gm` launches the hand-written CUDA
kernel in `csrc/blind_rotate_gm.cu` (one launch per group, one block per
gate holding every CRT prime; NTT(X^a) by the bit ladder over
`pbs.monomial_tables`; Shoup products against the BSK and its companion),
and `gm_server_key` replaces `mxu_server_key` (:1629) with the companion and
the ladder tables, cached per key as `mb_server_key` is. Its plain version
is `fhe/pbs.py::blind_rotate_ladder`.

No engine routes to K3, as no engine of `helm_tpu` routes to its TPU
kernel: the multi-bit sweep (`helm_tpu_torch/tools/mb_sweep.py`, LAYOUT=gm)
is its path.

Dispatch is by the device of the input tensor: on the CPU the plain
version runs; on a CUDA tensor the kernel is launched, or an error is
raised — there is no fallback.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..fhe import ops, pbs
from ..fhe.ntt import from_i32_bits, to_i32_bits
from . import build
from .mb_pbs import check_inputs, mb_server_key

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 10 + [ctypes.POINTER(ctypes.c_uint32)] + [_I] * 9 + [_P]


@dataclass(frozen=True, eq=False)
class GmKernelKey:
    """K3's view of one server key beyond K1's: the BSK's Shoup companion
    in the BSK's natural order [n/g, 2^g-1, rows, k+1, NP, N] (K1's
    `mb_server_key` holds the BSK itself), and the bit ladder's tables
    T[b] = NTT(X^(2^b)) with their companions, [log2(2N), NP, N]."""

    bsk_sh: torch.Tensor  # i32 bit patterns
    mono: torch.Tensor
    mono_sh: torch.Tensor


_layouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def gm_server_key(dsk: pbs.DeviceServerKey) -> GmKernelKey:
    """K3's key layout of `dsk`, built on first use and cached per key."""
    got = _layouts.get(dsk)
    if got is not None:
        return got
    if dsk.params.grouping < 2:
        raise ValueError(f"{dsk.params.name}: grouping {dsk.params.grouping}; K3 takes multi-bit keys")
    mono, mono_sh = (
        torch.from_numpy(t.astype(np.int64)).to(torch.int32).to(dsk.device)
        for t in pbs.monomial_tables(dsk.params.N)
    )
    key = GmKernelKey(bsk_sh=dsk.bsk_ntt_sh.contiguous(), mono=mono, mono_sh=mono_sh)
    _layouts[dsk] = key
    return key


def blind_rotate_gm(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Gate-major multi-bit blind rotation [G, n+1] words -> [G, k+1, N]
    words, the same function as `mb_pbs.blind_rotate_mb`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`blind_rotate_gm.launches` counts the launches)."""
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(
            f"{p.name}: grouping {p.grouping}; K3 is a multi-bit kernel "
            "(grouping 1 is the single-bit kernel's, ops/sb_pbs.py)"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_ladder(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_gm: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_gm")
    n, N = p.n, p.N
    G = lwe_in.shape[0]
    key = mb_server_key(dsk)  # the BSK, twiddles, Garner constants
    gkey = gm_server_key(dsk)
    acc = to_i32_bits(pbs.initial_acc(p, lwe_in, testv)).contiguous()
    abar = ops.mod_switch(lwe_in[:, :n], N).to(torch.int32).contiguous()
    (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
    rc = build.entry("blind_rotate_gm", _ARGTYPES)(
        acc.data_ptr(), abar.data_ptr(), key.bsk.data_ptr(), gkey.bsk_sh.data_ptr(),
        gkey.mono.data_ptr(), gkey.mono_sh.data_ptr(),
        key.psi.data_ptr(), key.psi_sh.data_ptr(), key.psi_inv.data_ptr(), key.psi_inv_sh.data_ptr(),
        key.consts, G, n, N, p.k, p.grouping, mbl, mlv, bl, lv,
        torch.cuda.current_stream(lwe_in.device).cuda_stream,
    )
    build.check(rc, "helm_blind_rotate_gm")
    blind_rotate_gm.launches += 1
    return from_i32_bits(acc)


blind_rotate_gm.launches = 0
