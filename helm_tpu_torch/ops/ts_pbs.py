"""Transposed multi-bit blind rotation on Hopper (K4).

Counterpart of `helm_tpu/ops/ts_pbs.py::blind_rotate_ts_mb` (:643, body
`_make_kernel_ts_mb` :353): `blind_rotate_ts` launches the hand-written
CUDA kernel in `csrc/blind_rotate_ts.cu`, the tile body of K1
(`csrc/rotate_tiles.cuh`) with the four-step NTT in place of the register
passes: its N2-point stages run as int8 tensor-core products with the
gates' polynomials along the rows. `ts_server_key` replaces the BSK layout
`mxu_server_key_ts` (:299): the BSK chunked as K1's (`mb_pbs.tiled_bsk`)
in the four-step frequency order, cached per key as `mb_server_key` is,
and the transform's tables. Its plain version is
`fhe/pbs.py::blind_rotate_transposed`. K4 computes K1's function, so
`mb_pbs.bootstrap` runs it in K1's place when HELM_TPU_MB_KERNEL=ts.

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
from ..fhe.modring import NUM_PRIMES, get_tables
from ..fhe.ntt import N1, mxu_tables, window_tables
from . import build
from .mb_pbs import (K4_BUILDS, _narrow, check_build, check_inputs, chunk_freqs, mb_server_key, rotate_tiles,
                     tiled_bsk)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32P = ctypes.POINTER(ctypes.c_uint32)
_FOUR_STEP_ARGTYPES = [_P, _P, _I, _I, _I] + [_P] * 5 + [_U32P, _P, _P]


def b_fragments(w_limbs: np.ndarray) -> np.ndarray:
    """The N2 x N2 limb matrices [NP, L, K, N] int8 (K rows contracted)
    packed in the order the kernel's mma.m16n8k32 reads its B operand:
    [NP, L, Kp/32, N/8, 32 lanes, 8 bytes] with K zero-padded to Kp, a
    multiple of 32. Lane (g, t) = (lane >> 2, lane & 3) holds column
    nt*8 + g, rows kk*32 + 4t + (0..3) in bytes 0-3 and kk*32 + 16 + 4t +
    (0..3) in bytes 4-7 (the PTX ISA's fragment layout)."""
    nprime, nl, K, Nn = w_limbs.shape
    Kp = -(-K // 32) * 32
    w = np.zeros((nprime, nl, Kp, Nn), np.int8)
    w[:, :, :K] = w_limbs
    lane = np.arange(32)
    j = np.arange(8)
    krel = (lane & 3)[:, None] * 4 + (j & 3)[None, :] + 16 * (j >= 4)[None, :]  # [32, 8]
    k = np.arange(Kp // 32)[:, None, None, None] * 32 + krel[None, None]  # [KK, 1, 32, 8]
    n = np.arange(Nn // 8)[None, :, None, None] * 8 + (lane >> 2)[None, None, :, None]
    return np.ascontiguousarray(w[:, :, k, n])


@dataclass(frozen=True, eq=False)
class TsKernelKey:
    """K4's view of one server key beyond `mb_server_key`'s: the BSK chunked
    per step and prime as K1's (`mb_pbs.tiled_bsk`, i16 at PRIMES_512) in
    the four-step frequency order; the N2-point matrices as the kernel's
    B fragments of their two-limb window split (`ntt.window_tables`, each
    matrix of p = 65537 scaled by its `scale` c); the twists as (w, w_sh)
    pairs at index fA_s N2 + jB; the 8-point stages' twiddle pairs; ef4,
    2 bitrev(f) + 1 of the standard frequency at four-step position f; and
    `ts_consts`, per prime the data's limb count and the recombination
    constants 256^s c^-1 mod p of each direction (on the device: each
    block reads its prime's row)."""

    bsk: torch.Tensor  # [n/g, NP, N/cf, 2^g-1, rows, k+1, cf] i16 or i32
    bfwd: torch.Tensor  # i8 [NP, 2, Kp/32, N2/8, 32, 8]
    binv: torch.Tensor
    twf: torch.Tensor  # i32 [NP, N, 2]
    twi: torch.Tensor
    stw: torch.Tensor  # i32 [NP, 16, 2]: forward stages at 1..7, inverse at 9..15
    ef4: torch.Tensor  # i32 [N]
    scale: tuple  # (c of the forward matrix, c of the inverse) per prime
    ts_consts: torch.Tensor  # i32 [NP, 9]: limbs, forward then inverse constants


_layouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def transform_tables(N: int, device) -> dict:
    """The four-step transform's tables as the kernel takes them: the B
    fragments of the window limbs, the twist pairs, the 8-point stages'
    pairs (the standard transform's first three stages: psi_rev[1..7] and
    psi_inv_rev[1..7], `fhe/ntt.py` `mxu_tables` stage_tw in the register
    pass's order), the scales and `ts_consts`."""
    t, w, tab = mxu_tables(N), window_tables(N), get_tables(N)

    def i32(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(torch.int32).to(device)

    def pairs(x, x_sh):
        return i32(np.stack([x.reshape(NUM_PRIMES, N), x_sh.reshape(NUM_PRIMES, N)], axis=-1))

    stw = np.zeros((NUM_PRIMES, 16, 2), np.int64)
    stw[:, 1:N1] = np.stack([tab.psi_rev[:, 1:N1], tab.psi_rev_sh[:, 1:N1]], axis=-1)
    stw[:, N1 + 1:] = np.stack([tab.psi_inv_rev[:, 1:N1], tab.psi_inv_rev_sh[:, 1:N1]], axis=-1)
    consts = np.concatenate([t["limbs"][:, None], w["w2_rc"], w["w2i_rc"]], axis=1)
    return {
        "bfwd": torch.from_numpy(b_fragments(w["w2_win"])).to(device),
        "binv": torch.from_numpy(b_fragments(w["w2i_win"])).to(device),
        "twf": pairs(t["tw"], t["tw_sh"]),
        "twi": pairs(t["twi"], t["twi_sh"]),
        "stw": i32(stw),
        "scale": tuple(zip(w["w2_scale"].tolist(), w["w2i_scale"].tolist())),
        "ts_consts": i32(consts),
    }


def ts_server_key(dsk: pbs.DeviceServerKey) -> TsKernelKey:
    """K4's key layout of `dsk`, built on first use and cached per key."""
    got = _layouts.get(dsk)
    if got is not None:
        return got
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(f"{p.name}: grouping {p.grouping}; K4 takes multi-bit keys")
    perm = torch.from_numpy(mxu_tables(p.N)["perm_from_std"]).to(dsk.device)
    _, ef = pbs.power_tables(p.N, str(dsk.device))
    key = TsKernelKey(
        bsk=tiled_bsk(dsk.bsk_ntt[..., perm], p, chunk_freqs(p), _narrow(p)),
        ef4=ef[perm].to(torch.int32).contiguous(),
        **transform_tables(p.N, dsk.device),
    )
    _layouts[dsk] = key
    return key


def blind_rotate_ts(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Transposed multi-bit blind rotation [G, n+1] words -> [G, k+1, N]
    words, the same function as `mb_pbs.blind_rotate_mb`.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`blind_rotate_ts.launches` counts the launches)."""
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(
            f"{p.name}: grouping {p.grouping}; K4 has no grouping-1 build "
            "(grouping-1 sets take K2, ops/sb_pbs.py; K1 takes them too)"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_transposed(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_ts: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_ts")
    check_build(p, K4_BUILDS, "K4")
    tkey = ts_server_key(dsk)
    extra = [(_P, tkey.bfwd.data_ptr()), (_P, tkey.binv.data_ptr()), (_P, tkey.stw.data_ptr()),
             (_P, tkey.ef4.data_ptr()), (_P, tkey.ts_consts.data_ptr())]
    out = rotate_tiles("blind_rotate_ts", dsk, lwe_in, testv, extra, (tkey.bsk, tkey.twf, tkey.twi))
    blind_rotate_ts.launches += 1
    return out


blind_rotate_ts.launches = 0


def four_step_kernel(dsk: pbs.DeviceServerKey, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """K4's four-step transforms alone, on the card: residues [R, NP, N]
    -> `ntt.ntt_fwd_four_step(x)` (or, with `inverse`,
    `ntt.ntt_inv_four_step(x)`), by the device functions of the rotation
    (csrc/rotate_tiles.cuh FourStepTC). A check of the 8-point stages,
    twists, limb splits and tensor-core products apart from the
    rotation."""
    if x.device.type != "cuda":
        raise NotImplementedError(f"four_step_kernel: no kernel for {x.device}")
    N = dsk.params.N
    if x.dim() != 3 or tuple(x.shape[1:]) != (NUM_PRIMES, N):
        raise ValueError(f"four_step_kernel: x {tuple(x.shape)}, want [R, {NUM_PRIMES}, {N}]")
    tkey = ts_server_key(dsk)
    xin = x.to(torch.int32).contiguous()
    out = torch.empty_like(xin)
    with torch.cuda.device(x.device):  # the C entry launches on the current device
        rc = build.entry("blind_rotate_ts", _FOUR_STEP_ARGTYPES, "helm_ts_four_step")(
            xin.data_ptr(), out.data_ptr(), int(inverse), x.shape[0], N,
            tkey.bfwd.data_ptr(), tkey.binv.data_ptr(), tkey.twf.data_ptr(), tkey.twi.data_ptr(),
            tkey.stw.data_ptr(), mb_server_key(dsk).consts, tkey.ts_consts.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "helm_ts_four_step")
    return out.to(torch.int64)
