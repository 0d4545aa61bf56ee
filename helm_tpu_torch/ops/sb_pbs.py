"""Single-bit blind rotation on Hopper.

Counterpart of the grouping-1 kernels of the JAX package:
`blind_rotate_sb` replaces both `helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu`
(K2a, :1652) and `helm_tpu/ops/pallas_pbs.py::blind_rotate_pallas` (K2b,
:339) with the hand-written CUDA kernel in `csrc/blind_rotate_sb.cu`. Its
plain version is `fhe/pbs.py::blind_rotate` (the twin of
`pbs_jnp.blind_rotate`). The kernel reads the same key layout as K1
(`mb_pbs.mb_server_key`: a grouping-1 BSK [n, rows, k+1, NP, N] is K1's
[n/g, 2^g-1, ...] layout at g = 1).

Dispatch is by the device of the input tensor: on the CPU the plain
version runs; on a CUDA tensor the kernel is launched, or an error is
raised — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..fhe import ops, pbs
from ..fhe.modring import NUM_PRIMES
from ..fhe.ntt import from_i32_bits, to_i32_bits
from . import build
from .mb_pbs import check_inputs, mb_server_key

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 9 + [ctypes.POINTER(ctypes.c_uint32)] + [_I] * 8 + [_P]


def blind_rotate_sb(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Single-bit blind rotation [G, n+1] words -> [G, k+1, N] words.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`blind_rotate_sb.launches` counts the launches)."""
    p = dsk.params
    if p.grouping != 1:
        raise ValueError(f"{p.name}: grouping {p.grouping}; the single-bit kernel takes 1")
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_sb: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_sb")
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    key = mb_server_key(dsk)
    dev = lwe_in.device
    acc = to_i32_bits(pbs.initial_acc(p, lwe_in, testv)).contiguous()
    abar = ops.mod_switch(lwe_in[:, :n], N).to(torch.int32).contiguous()
    fbuf = torch.empty((G, p.gadget_rows, NUM_PRIMES, N), dtype=torch.int32, device=dev)
    sbuf = torch.empty((G, k + 1, NUM_PRIMES, N), dtype=torch.int32, device=dev)
    (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
    rc = build.entry("blind_rotate_sb", _ARGTYPES)(
        acc.data_ptr(), abar.data_ptr(), key.bsk.data_ptr(),
        key.psi.data_ptr(), key.psi_sh.data_ptr(),
        key.psi_inv.data_ptr(), key.psi_inv_sh.data_ptr(),
        fbuf.data_ptr(), sbuf.data_ptr(), key.consts,
        G, n, N, k, mbl, mlv, bl, lv,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "helm_blind_rotate_sb")
    blind_rotate_sb.launches += 1
    return from_i32_bits(acc)


blind_rotate_sb.launches = 0
