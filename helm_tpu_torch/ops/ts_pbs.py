"""Transposed multi-bit blind rotation on Hopper (K4).

Counterpart of `helm_tpu/ops/ts_pbs.py::blind_rotate_ts_mb` (:643, body
`_make_kernel_ts_mb` :353): `blind_rotate_ts` launches the hand-written
CUDA kernel in `csrc/blind_rotate_ts.cu`, whose four-step NTT runs its
N2-point stages as int8 tensor-core products with the gates' polynomials
along the rows, and `ts_server_key` replaces the BSK layout
`mxu_server_key_ts` (:299): the BSK in the four-step frequency order,
prime-outermost, cached per key as `mb_server_key` is. Its plain version
is `fhe/pbs.py::blind_rotate_transposed`. K4 computes K1's function, so
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

from ..fhe import ops, pbs
from ..fhe.modring import NUM_PRIMES
from ..fhe.ntt import MAX_LIMBS, from_i32_bits, mxu_tables, to_i32_bits
from . import build
from .mb_pbs import check_inputs, mb_server_key

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32P = ctypes.POINTER(ctypes.c_uint32)
_ARGTYPES = [_P] * 12 + [_U32P, _U32P] + [_I] * 9 + [_P]
_FOUR_STEP_ARGTYPES = [_P, _P, _I, _I, _I] + [_P] * 6 + [_U32P, _U32P, _P]


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
    """K4's view of one server key: the BSK in the four-step frequency
    order, prime-outermost, [n/g, NP, 2^g-1, rows, k+1, N], so that the
    block of (gate tile, prime) reads one contiguous slab per group; the
    transform's tables; and ef at the four-step positions."""

    bsk: torch.Tensor  # i32 bit patterns
    bfwd: torch.Tensor  # i8 [NP, 3, Kp/32, N2/8, 32, 8]
    binv: torch.Tensor
    tw: torch.Tensor  # i32 [NP, N1, N2] each
    tw_sh: torch.Tensor
    twi: torch.Tensor
    twi_sh: torch.Tensor
    ef4: torch.Tensor  # i32 [N]
    ts_consts: ctypes.Array  # u32: stage twiddles, limb counts, 256^s mod p


_layouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def transform_tables(N: int, device) -> dict:
    """The four-step transform's tables as the kernel takes them."""
    t = mxu_tables(N)
    i32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(torch.int32).to(device)  # noqa: E731
    consts = [np.asarray(t[k]).ravel() for k in ("stage_tw", "stage_tw_sh", "istage_tw", "istage_tw_sh")]
    consts.append(np.asarray(t["limbs"]))
    consts.append(np.array([[pow(256, s, p) for s in range(2 * MAX_LIMBS - 1)] for p in t["primes"]]).ravel())
    vals = [int(v) for v in np.concatenate(consts)]
    return {
        "bfwd": torch.from_numpy(b_fragments(t["w2_limbs"])).to(device),
        "binv": torch.from_numpy(b_fragments(t["w2i_limbs"])).to(device),
        **{k: i32(t[k]) for k in ("tw", "tw_sh", "twi", "twi_sh")},
        "ts_consts": (ctypes.c_uint32 * len(vals))(*vals),
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
        bsk=dsk.bsk_ntt[..., perm].permute(0, 4, 1, 2, 3, 5).contiguous(),
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
            f"{p.name}: grouping {p.grouping}; K4 is a multi-bit kernel "
            "(grouping 1 is the single-bit kernel's, ops/sb_pbs.py)"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_transposed(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_ts: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_ts")
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    key = mb_server_key(dsk)  # power table, Garner constants
    tkey = ts_server_key(dsk)
    acc = to_i32_bits(pbs.initial_acc(p, lwe_in, testv)).contiguous()
    abar = ops.mod_switch(lwe_in[:, :n], N).to(torch.int32).contiguous()
    res = torch.empty((G, k + 1, NUM_PRIMES, N), dtype=torch.int32, device=lwe_in.device)
    (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
    rc = build.entry("blind_rotate_ts", _ARGTYPES)(
        acc.data_ptr(), abar.data_ptr(), tkey.bsk.data_ptr(),
        tkey.bfwd.data_ptr(), tkey.binv.data_ptr(),
        tkey.tw.data_ptr(), tkey.tw_sh.data_ptr(), tkey.twi.data_ptr(), tkey.twi_sh.data_ptr(),
        key.pw.data_ptr(), tkey.ef4.data_ptr(), res.data_ptr(),
        key.consts, tkey.ts_consts,
        G, n, N, k, p.grouping, mbl, mlv, bl, lv,
        torch.cuda.current_stream(lwe_in.device).cuda_stream,
    )
    build.check(rc, "helm_blind_rotate_ts")
    blind_rotate_ts.launches += 1
    return from_i32_bits(acc)


blind_rotate_ts.launches = 0


def four_step_kernel(dsk: pbs.DeviceServerKey, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """K4's four-step transforms alone, on the card: residues [R, NP, N]
    -> `ntt.ntt_fwd_four_step(x)` (or, with `inverse`,
    `ntt.ntt_inv_four_step(x)`). A check of the kernel's transform stages
    and tensor-core products apart from the rotation."""
    if x.device.type != "cuda":
        raise NotImplementedError(f"four_step_kernel: no kernel for {x.device}")
    N = dsk.params.N
    if x.dim() != 3 or tuple(x.shape[1:]) != (NUM_PRIMES, N):
        raise ValueError(f"four_step_kernel: x {tuple(x.shape)}, want [R, {NUM_PRIMES}, {N}]")
    tkey = ts_server_key(dsk)
    xin = x.to(torch.int32).contiguous()
    out = torch.empty_like(xin)
    rc = build.entry("blind_rotate_ts", _FOUR_STEP_ARGTYPES, "helm_ts_four_step")(
        xin.data_ptr(), out.data_ptr(), int(inverse), x.shape[0], N,
        tkey.bfwd.data_ptr(), tkey.binv.data_ptr(),
        tkey.tw.data_ptr(), tkey.tw_sh.data_ptr(), tkey.twi.data_ptr(), tkey.twi_sh.data_ptr(),
        mb_server_key(dsk).consts, tkey.ts_consts,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "helm_ts_four_step")
    return out.to(torch.int64)
