"""Gate-major multi-bit blind rotation on Hopper (K3).

Counterpart of `helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu_mb` (:1811, body
`_make_kernel_mb` :567): `blind_rotate_gm` launches the hand-written CUDA
kernel in `csrc/blind_rotate_gm.cu`, the tile body of K1
(`csrc/rotate_tiles.cuh`, whose cluster holds every CRT prime of a tile
in one step: the TPU kernel's gate-major step) with NTT(X^a) built by the
bit ladder over `pbs.monomial_tables` in place of K1's power table. It
reads K1's chunked BSK (`mb_server_key(dsk).bsk_k1`); `gm_server_key`
replaces `mxu_server_key` (:1629) with the ladder's tables alone, cached
per key as `mb_server_key` is (the TPU kernel's Shoup companion of the
BSK is not carried over). Its plain version is
`fhe/pbs.py::blind_rotate_ladder`.

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

from ..fhe import pbs
from .mb_pbs import K3_BUILDS, check_build, check_inputs, rotate_tiles

_P = ctypes.c_void_p


@dataclass(frozen=True, eq=False)
class GmKernelKey:
    """K3's view of one server key beyond K1's (`mb_server_key`, whose
    chunked BSK it reads): the bit ladder's tables T[b] = NTT(X^(2^b))
    and their Shoup companions, [log2(2N), NP, N]."""

    mono: torch.Tensor  # i32 bit patterns
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
    key = GmKernelKey(mono=mono, mono_sh=mono_sh)
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
            f"{p.name}: grouping {p.grouping}; K3 has no grouping-1 build "
            "(grouping-1 sets take K2, ops/sb_pbs.py; K1 takes them too)"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_ladder(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_gm: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_gm")
    check_build(p, K3_BUILDS, "K3")
    gkey = gm_server_key(dsk)
    out = rotate_tiles("blind_rotate_gm", dsk, lwe_in, testv,
                       [(_P, gkey.mono.data_ptr()), (_P, gkey.mono_sh.data_ptr())])
    blind_rotate_gm.launches += 1
    return out


blind_rotate_gm.launches = 0
