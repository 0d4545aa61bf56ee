"""Server key: the host ServerKey, its keyswitch key, and BSK generation
with a torch NTT on an explicit device.

Counterpart of `helm_tpu/fhe/server_key.py`. The reference runs the
keygen-scale NTT batches through jitted JAX on the host CPU
(`_keygen_cpu_jit`); here they run as torch ops on `device` (the card by
default). The randomness is drawn from `ck.rng` in exactly the
reference's order (masks `a` first, then the noise), and all NTT
arithmetic is exact, so the keys come out bit-identical to
`helm_tpu.fhe.server_key.gen_server_key` for the same seed.

The `ServerKey` dataclass, the keyswitch key with its int8 limb recoding
and the convolution-bound check are the reference's numpy code, copied
here so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Q, TfheParams, from_reference
from . import ntt
from .lwe import ClientKey, _noise
from .modring import get_tables


@dataclass
class ServerKey:
    """Host (numpy) server key; `fhe/pbs.DeviceServerKey.from_host` puts
    it on a device."""

    params: TfheParams
    bsk_ntt: np.ndarray  # uint32 [n, rows, k+1, NP, N] or [n/g, 2^g-1, rows, k+1, NP, N]
    bsk_ntt_sh: np.ndarray  # uint32, same shape
    ksk_limbs: np.ndarray  # int8 [4, k*N*ks_level, n+1]


def server_key_from_reference(sk) -> ServerKey:
    """The port's ServerKey for a `helm_tpu.fhe.server_key.ServerKey`
    (duck-typed: nothing of helm_tpu is imported). The arrays are copied."""
    return ServerKey(
        from_reference(sk.params),
        np.array(sk.bsk_ntt, dtype=np.uint32),
        np.array(sk.bsk_ntt_sh, dtype=np.uint32),
        np.array(sk.ksk_limbs, dtype=np.int8),
    )


def _check_conv_bound(p: TfheParams) -> None:
    import math

    prod = math.prod(int(q) for q in get_tables(p.N).primes)
    assert 2 * p.conv_bound() < prod, (
        f"{p.name}: external-product convolution bound 2^"
        f"{math.log2(p.conv_bound()):.2f} exceeds half the CRT prime "
        f"product 2^{math.log2(prod):.2f} for N={p.N} "
        "(modring.primes_for) — results would be wrong; use a smaller "
        "gadget base or a larger prime set"
    )


def _balanced_limbs(v: np.ndarray) -> np.ndarray:
    """uint32 [...] -> int8 [4, ...] with v === sum limb_i * 2^(8i) mod 2^32."""
    x = v.astype(np.int64)
    out = np.empty((4,) + v.shape, dtype=np.int8)
    for i in range(4):
        d = ((x + 128) & 255) - 128
        out[i] = d.astype(np.int8)
        x = (x - d) >> 8
    return out


def gen_ksk(ck: ClientKey) -> np.ndarray:
    """KSK rows enc_small(s_big_i * q/B^(j+1)), i major / level j minor,
    recoded to balanced int8 limbs [4, big_n*ks_level, n+1]."""
    p = ck.params
    s_big = ck.extracted_key  # [kN]
    rows = p.big_n * p.ks_level
    msgs = np.zeros((p.big_n, p.ks_level), dtype=np.uint32)
    for j in range(p.ks_level):
        w = np.uint32(1 << (32 - p.ks_base_log * (j + 1)))
        msgs[:, j] = s_big * w
    a = ck.rng.integers(0, Q, size=(rows, p.n), dtype=np.uint32)
    dot = (a.astype(np.uint64) * ck.lwe_key.astype(np.uint64)).sum(axis=-1)
    b = (
        dot.astype(np.uint32)
        + msgs.reshape(rows)
        + _noise(ck.rng, p.lwe_noise_std, (rows,))
    ).astype(np.uint32)
    ksk = np.concatenate([a, b[:, None]], axis=-1)  # [rows, n+1]
    return _balanced_limbs(ksk)


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


def gen_bsk(ck: ClientKey, device="cuda") -> tuple[np.ndarray, np.ndarray]:
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


def gen_bsk_multibit(ck: ClientKey, device="cuda") -> tuple[np.ndarray, np.ndarray]:
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


def gen_server_key(ck: ClientKey, device="cuda") -> ServerKey:
    """The reference's gen_server_key, with the NTT batches on `device`."""
    if ck.params.grouping > 1:
        bsk_ntt, bsk_sh = gen_bsk_multibit(ck, device)
    else:
        bsk_ntt, bsk_sh = gen_bsk(ck, device)
    return ServerKey(ck.params, bsk_ntt, bsk_sh, gen_ksk(ck))
