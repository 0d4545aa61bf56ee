"""Server key generation with a torch NTT on an explicit device.

Counterpart of `helm_tpu/fhe/server_key.py`. The reference runs the
keygen-scale NTT batches through jitted JAX on the host CPU
(`_keygen_cpu_jit`); here they run as torch ops on `device` (the card
when there is one), which keeps JAX out of the port. The randomness is
drawn from `ck.rng` in exactly the reference's order (masks `a` first,
then the noise), and all NTT arithmetic is exact, so the keys come out
bit-identical to `helm_tpu.fhe.server_key.gen_server_key` for the same
seed.

The keyswitch key, the int8 limb recoding and the `ServerKey` dataclass
are pure numpy in the reference and are reused from it.
"""

from __future__ import annotations

import numpy as np
import torch

from helm_tpu.fhe.lwe import ClientKey, _noise
from helm_tpu.fhe.modring import get_tables
from helm_tpu.fhe.server_key import ServerKey, _check_conv_bound, gen_ksk
from helm_tpu.params import Q

from . import ntt

#: polynomials per keygen NTT batch: bounds the device working set
#: (each [CHUNK, NP, N] int64 intermediate is CHUNK * 16 KiB at N=512)
CHUNK = 8192


def _fwd(raw: np.ndarray, device) -> np.ndarray:
    """uint32 [..., N] -> NTT residues uint32 [..., NP, N], in chunks."""
    tab = get_tables(raw.shape[-1])
    flat = raw.reshape(-1, raw.shape[-1])
    out = np.empty((flat.shape[0],) + tab.psi_rev.shape, np.uint32)
    for i in range(0, flat.shape[0], CHUNK):
        x = ntt.words(flat[i : i + CHUNK], device)
        out[i : i + CHUNK] = ntt.to_host(ntt.ntt_fwd(ntt.to_residues(x, tab), tab))
    return out.reshape(raw.shape[:-1] + tab.psi_rev.shape)


def _body(a: np.ndarray, s_ntt: torch.Tensor, device) -> np.ndarray:
    """sum_c a_c * S_c for mask polys a [rows, k, N] (numpy) -> uint32 [rows, N]."""
    N = a.shape[-1]
    tab = get_tables(N)
    primes = ntt.device_tables(N, str(torch.device(device)))["primes_col"]
    k = a.shape[1]
    step = max(1, CHUNK // k)
    out = np.empty((a.shape[0], N), np.uint32)
    for i in range(0, a.shape[0], step):
        x = ntt.words(a[i : i + step], device)
        a_ntt = ntt.ntt_fwd(ntt.to_residues(x, tab), tab)
        prod = ntt._generic_modmul(a_ntt, s_ntt[None], primes)
        acc = prod[:, 0]
        for c in range(1, k):
            acc = ntt.add_mod(acc, prod[:, c], primes)
        out[i : i + step] = ntt.to_host(ntt.garner_to_u32(ntt.ntt_inv(acc, tab), tab))
    return out


def _glwe_enc_zero_batch(ck: ClientKey, rows: int, device) -> np.ndarray:
    """Batch of GLWE encryptions of zero: uint32 [rows, k+1, N]."""
    p = ck.params
    tab = get_tables(p.N)
    a = ck.rng.integers(0, Q, size=(rows, p.k, p.N), dtype=np.uint32)
    s_ntt = ntt.ntt_fwd(ntt.to_residues(ntt.words(ck.glwe_key, device), tab), tab)
    body = _body(a, s_ntt, device)
    body = body + _noise(ck.rng, p.glwe_noise_std, (rows, p.N))
    return np.concatenate([a, body[:, None, :]], axis=1)


def _with_shoup(bsk_ntt: np.ndarray, N: int) -> tuple[np.ndarray, np.ndarray]:
    primes = get_tables(N).primes.reshape(-1, 1).astype(np.uint64)
    sh = ((bsk_ntt.astype(np.uint64) << 16) // primes).astype(np.uint32)
    return bsk_ntt, sh


def gen_bsk(ck: ClientKey, device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """GGSW encryptions of each small-key bit, in NTT domain (+Shoup)."""
    _check_conv_bound(ck.params)
    p = ck.params
    kp1 = p.k + 1
    rows_per = p.gadget_rows
    raw = _glwe_enc_zero_batch(ck, p.n * rows_per, device).reshape(
        p.n, rows_per, kp1, p.N
    )
    r = 0
    for c in range(kp1):
        bl, lv = p.component_gadgets[c]
        for j in range(lv):
            raw[:, r, c, 0] += ck.lwe_key * np.uint32(1 << (32 - bl * (j + 1)))
            r += 1
    return _with_shoup(_fwd(raw, device), p.N)


def gen_bsk_multibit(ck: ClientKey, device="cpu") -> tuple[np.ndarray, np.ndarray]:
    """Grouped bootstrap key for multi-bit PBS, shape
    [n/g, 2^g-1, rows, k+1, NP, N] (empty subset not keyed; see the
    reference's gen_bsk_multibit)."""
    _check_conv_bound(ck.params)
    p = ck.params
    g = p.grouping
    assert g >= 1 and p.n % g == 0, (g, p.n)
    groups = p.n // g
    kp1 = p.k + 1
    rows_per = p.gadget_rows
    nv = 1 << g
    raw = _glwe_enc_zero_batch(ck, groups * (nv - 1) * rows_per, device).reshape(
        groups, nv - 1, rows_per, kp1, p.N
    )
    s = ck.lwe_key.reshape(groups, g)
    for v in range(1, nv):
        m = np.ones(groups, dtype=np.uint32)
        for i in range(g):
            if (v >> i) & 1:
                m = m * s[:, i]
        r = 0
        for c in range(kp1):
            bl, lv = p.component_gadgets[c]
            for j in range(lv):
                raw[:, v - 1, r, c, 0] += m * np.uint32(1 << (32 - bl * (j + 1)))
                r += 1
    return _with_shoup(_fwd(raw, device), p.N)


def gen_server_key(ck: ClientKey, device="cpu") -> ServerKey:
    """The reference's gen_server_key, with the NTT batches on `device`."""
    if ck.params.grouping > 1:
        bsk_ntt, bsk_sh = gen_bsk_multibit(ck, device)
    else:
        bsk_ntt, bsk_sh = gen_bsk(ck, device)
    return ServerKey(ck.params, bsk_ntt, bsk_sh, gen_ksk(ck))
