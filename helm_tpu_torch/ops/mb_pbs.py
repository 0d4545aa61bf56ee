"""Multi-bit blind rotation on Hopper, and the bootstrap dispatcher.

Counterpart of `helm_tpu/ops/mxu_pbs.py`: `blind_rotate_mb` replaces the
Pallas kernel `blind_rotate_fs_mb` (:2706) with the hand-written CUDA
kernel in `csrc/blind_rotate_mb.cu`, `mb_server_key` replaces the BSK
layout `mxu_server_key_fs` (:1954, cached per key as `_layout_cache`
:1602 does), and `bootstrap` replaces `bootstrap_mxu` (:2839): grouping-1
sets go to the single-bit kernel K2 (`ops/sb_pbs.py`), the others to the
multi-bit kernel that `mb_kernel()` selects (HELM_TPU_MB_KERNEL, as
`helm_tpu/ops/ts_pbs.py:76`): K1, the prime-split K6 (`ops/ps_pbs.py`) or
the transposed K4 (`ops/ts_pbs.py`).

Dispatch is by the device of the input tensor: on the CPU the plain torch
version (`fhe/pbs.py`) runs; on a CUDA tensor the kernel is launched, or
an error is raised — there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import weakref
from dataclasses import dataclass

import torch

from ..fhe import ops, pbs
from ..fhe.modring import NUM_PRIMES
from ..fhe.ntt import from_i32_bits, to_i32_bits
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 11 + [ctypes.POINTER(ctypes.c_uint32)] + [_I] * 9 + [_P]


@dataclass(frozen=True, eq=False)
class MbKernelKey:
    """The kernels' view of one server key, derived once per key (K1 and
    K2 read the same layout; K2 leaves pw and ef unused).

    bsk is the NTT-domain BSK as u32 words in its natural
    [n/g, 2^g-1, rows, k+1, NP, N] order, which is already the kernel's
    layout: a thread per (prime, frequency) reads NP*N-strided words, so
    a warp reads 128 contiguous bytes. The Shoup companion is dropped (the
    kernel reduces with a Barrett constant per prime)."""

    bsk: torch.Tensor  # i32 bit patterns
    psi: torch.Tensor  # i32 [NP, N] each
    psi_sh: torch.Tensor
    psi_inv: torch.Tensor
    psi_inv_sh: torch.Tensor
    pw: torch.Tensor  # i32 [NP, 2N]
    ef: torch.Tensor  # i32 [N]
    consts: ctypes.Array  # u32 [26]


_layouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def mb_server_key(dsk: pbs.DeviceServerKey) -> MbKernelKey:
    """The kernel layout of `dsk`, built on first use and cached per key."""
    got = _layouts.get(dsk)
    if got is not None:
        return got
    tab = dsk.tab
    dev = dsk.device

    def i32(a):
        return torch.as_tensor(a.astype("int64")).to(torch.int32).to(dev)

    pw, ef = pbs.power_tables(tab.N, str(dev))
    g = tab.garner
    garner = [
        g.inv_p0_mod_p1, g.inv_p0_mod_p1_sh, g.p0_mod_p2, g.p0_mod_p2_sh,
        g.inv_p01_mod_p2, g.inv_p01_mod_p2_sh, g.p0_mod_p3, g.p0_mod_p3_sh,
        g.p01_mod_p3, g.p01_mod_p3_sh, g.inv_p012_mod_p3, g.inv_p012_mod_p3_sh,
        g.prod_mod_q, g.half_p3,
    ]
    vals = (
        [int(x) for x in tab.primes]
        + [int(x) for x in tab.n_inv]
        + [int(x) for x in tab.n_inv_sh]
        + [int(x) for x in garner]
    )
    key = MbKernelKey(
        bsk=dsk.bsk_ntt.contiguous(),
        psi=i32(tab.psi_rev),
        psi_sh=i32(tab.psi_rev_sh),
        psi_inv=i32(tab.psi_inv_rev),
        psi_inv_sh=i32(tab.psi_inv_rev_sh),
        pw=pw.to(torch.int32).contiguous(),
        ef=ef.to(torch.int32).contiguous(),
        consts=(ctypes.c_uint32 * len(vals))(*vals),
    )
    _layouts[dsk] = key
    return key


def check_inputs(dsk: pbs.DeviceServerKey, lwe_in, testv, what: str) -> None:
    """Raise unless a kernel can take these tensors: everything on one
    CUDA device, int64 words, lwe_in [G, n+1] and testv [1 or G, N]."""
    p = dsk.params
    G = lwe_in.shape[0] if lwe_in.dim() else 0
    if dsk.bsk_ntt.device != lwe_in.device or testv.device != lwe_in.device:
        raise ValueError(
            f"{what}: server key on {dsk.bsk_ntt.device}, inputs on "
            f"{lwe_in.device} / {testv.device}"
        )
    if lwe_in.dtype != torch.int64 or testv.dtype != torch.int64:
        raise ValueError(f"{what}: words are int64 tensors, got {lwe_in.dtype} / {testv.dtype}")
    if lwe_in.dim() != 2 or G == 0 or lwe_in.shape[1] != p.n + 1 or testv.dim() != 2 or (
        testv.shape[0] not in (1, G) or testv.shape[1] != p.N
    ):
        raise ValueError(
            f"{what}: lwe_in {tuple(lwe_in.shape)} / testv "
            f"{tuple(testv.shape)}, want [G, {p.n + 1}] / [1 or G, {p.N}]"
        )


def blind_rotate_mb(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Multi-bit blind rotation [G, n+1] words -> [G, k+1, N] words.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`blind_rotate_mb.launches` counts the launches)."""
    p = dsk.params
    if p.grouping < 2:
        raise ValueError(
            f"{p.name}: grouping 1 is the single-bit kernel's (ops/sb_pbs.py); "
            "K1 computes another function there"
        )
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_multibit(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_mb: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_mb")
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    key = mb_server_key(dsk)
    rows = p.gadget_rows
    dev = lwe_in.device
    acc = to_i32_bits(pbs.initial_acc(p, lwe_in, testv)).contiguous()
    abar = ops.mod_switch(lwe_in[:, :n], N).to(torch.int32).contiguous()
    fbuf = torch.empty((G, rows, NUM_PRIMES, N), dtype=torch.int32, device=dev)
    sbuf = torch.empty((G, k + 1, NUM_PRIMES, N), dtype=torch.int32, device=dev)
    (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
    rc = build.entry("blind_rotate_mb", _ARGTYPES)(
        acc.data_ptr(), abar.data_ptr(), key.bsk.data_ptr(),
        key.psi.data_ptr(), key.psi_sh.data_ptr(),
        key.psi_inv.data_ptr(), key.psi_inv_sh.data_ptr(),
        key.pw.data_ptr(), key.ef.data_ptr(),
        fbuf.data_ptr(), sbuf.data_ptr(), key.consts,
        G, n, N, k, p.grouping, mbl, mlv, bl, lv,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "helm_blind_rotate_mb")
    blind_rotate_mb.launches += 1
    return from_i32_bits(acc)


blind_rotate_mb.launches = 0


#: the multi-bit kernel when HELM_TPU_MB_KERNEL does not name one
#: (ts_pbs.py:73 DEFAULT_MB_KERNEL)
DEFAULT_MB_KERNEL = "fs"
MB_KERNELS = ("fs", "fs16", "ts", "hb", "hb2", "ps")


def mb_kernel() -> str:
    """The multi-bit kernel selection (`helm_tpu/ops/ts_pbs.py:76`
    `mb_kernel`): HELM_TPU_MB_KERNEL when it names a kernel, else "ts"
    under the legacy HELM_TPU_TS_KERNEL=1, else DEFAULT_MB_KERNEL. Read
    at every call, as the reference does."""
    env = os.environ.get("HELM_TPU_MB_KERNEL")
    if env in MB_KERNELS:
        return env
    if os.environ.get("HELM_TPU_TS_KERNEL", "0") == "1":
        return "ts"
    return DEFAULT_MB_KERNEL


def blind_rotation(params):
    """The blind-rotation wrapper `bootstrap` runs for `params`, routed as
    `helm_tpu/ops/mxu_pbs.py:2864-2936` `bootstrap_mxu` routes:
    grouping 1 -> K2 (`sb_pbs.blind_rotate_sb`) whatever the selection;
    otherwise by `mb_kernel()`: "ps" -> K6 (`ps_pbs.blind_rotate_ps`);
    "ts" (also the legacy HELM_TPU_TS_KERNEL=1) -> K4
    (`ts_pbs.blind_rotate_ts`); "fs", "fs16", "hb", "hb2" -> K1
    (`blind_rotate_mb`: their TPU bodies are K1's pallas_call with another
    BSK dtype or layout, the same function)."""
    if params.grouping == 1:
        from .sb_pbs import blind_rotate_sb

        return blind_rotate_sb
    kn = mb_kernel()
    if kn == "ps":
        from .ps_pbs import blind_rotate_ps

        return blind_rotate_ps
    if kn == "ts":
        from .ts_pbs import blind_rotate_ts

        return blind_rotate_ts
    return blind_rotate_mb


def kernel_layouts(dsk: pbs.DeviceServerKey) -> None:
    """Build the key layouts the selected kernels read (K1's and K2's
    `mb_server_key`; K6's `ps_server_key` too when "ps" is selected, K4's
    `ts_server_key` when "ts" is), so that an engine pays for them once,
    up front."""
    mb_server_key(dsk)
    if dsk.params.grouping > 1 and mb_kernel() == "ps":
        from .ps_pbs import ps_server_key

        ps_server_key(dsk)
    if dsk.params.grouping > 1 and mb_kernel() == "ts":
        from .ts_pbs import ts_server_key

        ts_server_key(dsk)


def bootstrap(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Full PBS [G, n+1] -> [G, n+1]: the blind rotation `blind_rotation`
    picks (its kernel on CUDA, its plain version on the CPU), sample
    extract, int8-limb keyswitch."""
    acc = blind_rotation(dsk.params)(dsk, lwe_in, testv)
    big = ops.sample_extract(acc, dsk.params.k, dsk.params.N)
    return pbs.keyswitch(dsk, big)
