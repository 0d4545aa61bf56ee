"""Batched programmable bootstrapping as plain torch ops.

Counterpart of `helm_tpu/fhe/pbs_jnp.py`. These are the plain versions
of the port's kernels, and the CPU path of the dispatcher:
`blind_rotate_multibit` is the plain version of the multi-bit kernel K1
(`ops/mb_pbs.py`, `csrc/blind_rotate_mb.cu`), `blind_rotate_prime_split`
that of the prime-split kernel K6 (`ops/ps_pbs.py`,
`csrc/blind_rotate_ps.cu`), `blind_rotate_transposed` that of the
transposed kernel K4 (`ops/ts_pbs.py`, `csrc/blind_rotate_ts.cu`),
`blind_rotate_ladder` that of the gate-major kernel K3 (`ops/gm_pbs.py`,
`csrc/blind_rotate_gm.cu`), `blind_rotate` that of the
single-bit kernel K2 (`ops/sb_pbs.py`, `csrc/blind_rotate_sb.cu`). All
arithmetic is exact, so every function returns the same words as its
jnp twin. Words are int64 values in [0, 2^32) (`fhe/ntt.py`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..params import TfheParams
from . import ops
from .modring import (
    NUM_PRIMES,
    SHOUP_SHIFT,
    NttTables,
    _bit_reverse,
    get_tables,
    primes_for,
    root_of_unity,
)
from .ntt import (
    M32,
    _generic_modmul,
    add_mod,
    crt_fold,
    device_tables,
    digits_to_residues,
    garner_to_u32,
    mul_shoup,
    mxu_tables,
    ntt_fwd,
    ntt_fwd_four_step,
    ntt_inv,
    ntt_inv_four_step,
    reduce_small_sum,
    sub_mod,
)
from .server_key import ServerKey

#: torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_MM_MIN_ROWS = 32
_MM_ALIGN = 8


def decompose_glwe(p: TfheParams, x: torch.Tensor) -> torch.Tensor:
    """Signed-decompose a GLWE batch [G, k+1, N] into gadget rows
    [G, gadget_rows, N], c-major / level-minor (params.component_gadgets)."""
    parts = []
    for c, (bl, lv) in enumerate(p.component_gadgets):
        dg = ops.signed_decompose(x[:, c], bl, lv)  # [lv, G, N]
        parts.append(dg.permute(1, 0, 2))
    return torch.cat(parts, dim=1)


@dataclass(frozen=True, eq=False)
class DeviceServerKey:
    """Server key resident on a torch device + static metadata.

    bsk_ntt / bsk_ntt_sh hold residues (< 2^17) as int32. ksk_limbs is the
    reference's int8 limb KSK [4, rows, n+1] laid out for one GEMM: the
    limbs side by side as column blocks [rows, 4 * cols], each block
    padded with zero columns to a multiple of 8 (torch._int_mm on CUDA)."""

    params: TfheParams
    tab: NttTables
    device: torch.device
    bsk_ntt: torch.Tensor  # i32 [n/g, 2^g-1, rows, k+1, NP, N] or [n, rows, k+1, NP, N]
    bsk_ntt_sh: torch.Tensor
    ksk_limbs: torch.Tensor  # i8 [big_n*ks_level, 4 * pad8(n+1)]

    @staticmethod
    def from_host(sk: ServerKey, device) -> "DeviceServerKey":
        """Carry a numpy ServerKey (`server_key.ServerKey`) onto `device`."""
        device = torch.device(device)
        p = sk.params
        ksk = np.asarray(sk.ksk_limbs)
        cols = -(-ksk.shape[-1] // _MM_ALIGN) * _MM_ALIGN
        if cols != ksk.shape[-1]:
            ksk = np.concatenate(
                [ksk, np.zeros(ksk.shape[:-1] + (cols - ksk.shape[-1],), np.int8)],
                axis=-1,
            )
        ksk = np.ascontiguousarray(ksk.transpose(1, 0, 2).reshape(ksk.shape[1], -1))
        return DeviceServerKey(
            params=p,
            tab=get_tables(p.N),
            device=device,
            bsk_ntt=torch.from_numpy(sk.bsk_ntt.astype(np.int32)).to(device),
            bsk_ntt_sh=torch.from_numpy(sk.bsk_ntt_sh.astype(np.int32)).to(device),
            ksk_limbs=torch.from_numpy(ksk).to(device),
        )


@functools.lru_cache(maxsize=None)
def power_tables(N: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(pw, ef): pw[pi, t] = psi_pi^t for t in [0, 2N), and
    ef[f] = 2*bitrev(f) + 1, so NTT(X^a)[pi, f] = pw[pi, a*ef[f] mod 2N].

    Replaces the reference's bit ladder (`pbs_jnp.monomial_tables`) with
    one direct lookup; the values are the same."""
    bits = N.bit_length() - 1
    pw = np.zeros((NUM_PRIMES, 2 * N), np.int64)
    for pi, p in enumerate(primes_for(N)):
        psi = root_of_unity(p, 2 * N)
        acc = 1
        for t in range(2 * N):
            pw[pi, t] = acc
            acc = acc * psi % p
    ef = np.array([2 * _bit_reverse(f, bits) + 1 for f in range(N)], np.int64)
    return torch.from_numpy(pw).to(device), torch.from_numpy(ef).to(device)


def initial_acc(p: TfheParams, lwe_in: torch.Tensor, testv: torch.Tensor):
    """acc = X^{-bbar} * testv as a trivial GLWE: [G, k+1, N] words."""
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    bbar = ops.mod_switch(lwe_in[:, n], N)
    neg_b = (2 * N - bbar) & (2 * N - 1)
    body = ops.negacyclic_rotate(torch.broadcast_to(testv, (G, N)), neg_b, N)
    zeros = torch.zeros((G, k, N), dtype=torch.int64, device=lwe_in.device)
    return torch.cat([zeros, body[:, None, :]], dim=1)


def blind_rotate(dsk: DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor):
    """Single-bit (g=1) blind rotation (pbs_jnp.py:108), the plain version
    of K2: per mask element, acc += INTT(sum_r NTT(dec(X^a_i * acc - acc))_r
    (.) BSK_i[r]). [G, n+1] -> [G, k+1, N]."""
    p = dsk.params
    tab = dsk.tab
    n, N = p.n, p.N
    rows = p.gadget_rows
    primes_col = device_tables(N, str(lwe_in.device))["primes_col"]
    abar = ops.mod_switch(lwe_in[:, :n], N)
    acc = initial_acc(p, lwe_in, testv)
    # [n, rows, k+1, NP, N]; gen_bsk_multibit's [n, 1, rows, ...] holds the same
    shape = (n, rows, p.k + 1, -1, N)
    bsk, bsk_sh = dsk.bsk_ntt.reshape(shape), dsk.bsk_ntt_sh.reshape(shape)
    for i in range(n):
        bsk_i = bsk[i].to(torch.int64)
        bsk_sh_i = bsk_sh[i].to(torch.int64)
        rot = ops.negacyclic_rotate(acc, abar[:, i, None], N)
        diff = (rot - acc) & M32
        d = decompose_glwe(p, diff)
        f = ntt_fwd(digits_to_residues(d, primes_col), tab)  # [G, rows, NP, N]
        # all (row, component) products at once: [G, rows, k+1, NP, N]
        t = mul_shoup(f[:, :, None], bsk_i, bsk_sh_i, primes_col)
        prod = reduce_small_sum(t.sum(dim=1), primes_col, rows + 1)
        acc = (acc + garner_to_u32(ntt_inv(prod, tab), tab)) & M32
    return acc


def subset_polys(p: TfheParams, a_j: torch.Tensor) -> list:
    """NTT-domain subset polynomials P_v = prod_{i in v} (X^{a_i} - 1),
    v = 1 .. 2^g-1, for per-gate exponents a_j [G, g] -> [G, NP, N] each."""
    N = p.N
    pw, ef = power_tables(N, str(a_j.device))
    primes_col = device_tables(N, str(a_j.device))["primes_col"]
    d = []
    for i in range(p.grouping):
        e = (a_j[:, i, None] * ef[None, :]) & (2 * N - 1)  # [G, N]
        m = pw[:, e].permute(1, 0, 2)  # [G, NP, N]
        d.append(sub_mod(m, torch.ones_like(m), primes_col))
    pv = [None]
    for v in range(1, 1 << p.grouping):
        idxs = [i for i in range(p.grouping) if (v >> i) & 1]
        acc_p = d[idxs[0]]
        for i in idxs[1:]:
            acc_p = _generic_modmul(acc_p, d[i], primes_col)
        pv.append(acc_p)
    return pv


def blind_rotate_multibit(
    dsk: DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Multi-bit blind rotation (pbs_jnp.py:194), the plain version of the
    CUDA kernel K1: per group, acc += INTT(sum_r NTT(dec(acc))_r (.)
    sum_v P_v (.) BSK_v) — the additive-identity CMux, the residues
    recombined by Garner. [G, n+1] -> [G, k+1, N]."""
    return _blind_rotate_mb(dsk, lwe_in, testv, garner_to_u32)


def blind_rotate_prime_split(
    dsk: DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """The prime-split multi-bit blind rotation, the plain version of K6
    (`ops/ps_pbs.py`, `csrc/blind_rotate_ps.cu`; TPU kernel
    `helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_ps`): per group and per
    prime, the forward NTT of the digit residues, the pointwise sum over
    rows and subsets and the inverse NTT (the prime axis is a batch axis
    here: no prime sees another's residues), then the CRT partial-sum fold
    (`ntt.crt_fold`) in place of Garner. The same words as
    `blind_rotate_multibit`. [G, n+1] -> [G, k+1, N]."""
    return _blind_rotate_mb(dsk, lwe_in, testv, crt_fold)


def _blind_rotate_mb(dsk, lwe_in, testv, fold, fwd=None, inv=None, order=None):
    """The multi-bit rotation with the residues folded by `fold`, and the
    transforms `fwd` / `inv` (default the standard `ntt_fwd` / `ntt_inv`)
    whose frequency order `order` maps a standard-order array to."""
    p = dsk.params
    tab = dsk.tab
    g = p.grouping
    n, N = p.n, p.N
    groups = n // g
    G = lwe_in.shape[0]
    rows = p.gadget_rows
    fwd = fwd or (lambda x: ntt_fwd(x, tab))
    inv = inv or (lambda x: ntt_inv(x, tab))
    order = order or (lambda x: x)
    primes_col = device_tables(N, str(lwe_in.device))["primes_col"]
    abar = ops.mod_switch(lwe_in[:, :n], N)
    acc = initial_acc(p, lwe_in, testv)
    a_groups = abar.reshape(G, groups, g)
    # [n/g, 2^g-1, rows, k+1, NP, N]; a single-bit key [n, rows, k+1, NP,
    # N] (gen_bsk) is that at g = 1, the same GGSW(s_i)
    shape = (groups, (1 << g) - 1, rows, p.k + 1, -1, N)
    bsk, bsk_sh = dsk.bsk_ntt.reshape(shape), dsk.bsk_ntt_sh.reshape(shape)
    for j in range(groups):
        bsk_j = order(bsk[j]).to(torch.int64)
        bsk_sh_j = order(bsk_sh[j]).to(torch.int64)
        pv = [None] + [order(x) for x in subset_polys(p, a_groups[:, j])[1:]]
        # E[r, c] = sum_{v>=1} P_v (.) BSK_v[r, c] for every (row, component)
        # at once: [G, rows, k+1, NP, N]; the empty subset is never keyed
        e = None
        for v in range(1, 1 << g):
            t = mul_shoup(pv[v][:, None, None], bsk_j[v - 1], bsk_sh_j[v - 1], primes_col)
            e = t if e is None else e + t
        e = reduce_small_sum(e, primes_col, 1 << g)
        f = fwd(digits_to_residues(decompose_glwe(p, acc), primes_col))
        t = _generic_modmul(f[:, :, None], e, primes_col)
        prod = reduce_small_sum(t.sum(dim=1), primes_col, rows + 1)  # [G, k+1, NP, N]
        # acc += dec(acc) (.) (E - GGSW(1)): the identity is handled additively
        acc = (acc + fold(inv(prod), tab)) & M32
    return acc


def blind_rotate_transposed(
    dsk: DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """The transposed multi-bit blind rotation, the plain version of K4
    (`ops/ts_pbs.py`, `csrc/blind_rotate_ts.cu`; TPU kernel
    `helm_tpu/ops/ts_pbs.py::blind_rotate_ts_mb`): `blind_rotate_multibit`'s
    steps with both transforms four-step (`ntt.ntt_fwd_four_step`, whose
    N2-point stage is a product of 8-bit limbs) and the BSK and the subset
    polynomials in the four-step frequency order. The same words as
    `blind_rotate_multibit`. [G, n+1] -> [G, k+1, N]."""
    p = dsk.params
    N = p.N
    perm = torch.from_numpy(mxu_tables(N)["perm_from_std"]).to(lwe_in.device)
    return _blind_rotate_mb(
        dsk, lwe_in, testv, garner_to_u32,
        fwd=lambda x: ntt_fwd_four_step(x, N),
        inv=lambda x: ntt_inv_four_step(x, N),
        order=lambda x: x[..., perm],
    )


@functools.lru_cache(maxsize=None)
def monomial_tables(N: int) -> tuple[np.ndarray, np.ndarray]:
    """T[b, pi, f] = psi^(2^b * e_f) mod p_pi with e_f = 2*bitrev(f)+1: the
    NTT-domain image of X^(2^b), from which K3 builds NTT(X^a) by a bit
    ladder (`helm_tpu/fhe/pbs_jnp.py:164`). Returns (tables, shoup) as
    uint32 [log2(2N), NP, N]."""
    primes = primes_for(N)
    L2N = N.bit_length()
    bits = N.bit_length() - 1
    e = np.array([2 * _bit_reverse(f, bits) + 1 for f in range(N)], np.int64)
    t = np.zeros((L2N, len(primes), N), np.uint32)
    t_sh = np.zeros_like(t)
    for pi, p in enumerate(primes):
        psi = root_of_unity(p, 2 * N)
        pw = np.array([pow(psi, x, p) for x in range(2 * N)], np.int64)
        for b in range(L2N):
            w = pw[((1 << b) * e) % (2 * N)]
            t[b, pi] = w
            t_sh[b, pi] = (w << SHOUP_SHIFT) // p
    return t, t_sh


def monomial_ntt(a: torch.Tensor, N: int) -> torch.Tensor:
    """NTT(X^a) for exponents a [G] in [0, 2N) -> [G, NP, N], by the bit
    ladder: the Shoup product over the set bits b of a of T[b]."""
    mono, mono_sh = (torch.from_numpy(t.astype(np.int64)).to(a.device) for t in monomial_tables(N))
    primes_col = device_tables(N, str(a.device))["primes_col"]
    m = torch.ones((a.shape[0], NUM_PRIMES, N), dtype=torch.int64, device=a.device)
    for b in range(N.bit_length()):
        bit = ((a >> b) & 1).bool()[:, None, None]
        m = torch.where(bit, mul_shoup(m, mono[b], mono_sh[b], primes_col), m)
    return m


def blind_rotate_ladder(
    dsk: DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """The gate-major multi-bit blind rotation, the plain version of K3
    (`ops/gm_pbs.py`, `csrc/blind_rotate_gm.cu`; TPU kernel
    `helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu_mb`): per group, NTT(X^a_i)
    by the bit ladder (`monomial_ntt`), P_v = prod_{i in v} (NTT(X^a_i) -
    1), T_v[c] = sum_r F_r (.) BSK_v[r, c] by Shoup products against the BSK
    and its companion, acc += INTT(sum_v P_v (.) T_v) by Garner. The same
    words as `blind_rotate_multibit`. [G, n+1] -> [G, k+1, N]."""
    p = dsk.params
    tab = dsk.tab
    g, n, N = p.grouping, p.n, p.N
    G = lwe_in.shape[0]
    rows = p.gadget_rows
    primes_col = device_tables(N, str(lwe_in.device))["primes_col"]
    abar = ops.mod_switch(lwe_in[:, :n], N)
    acc = initial_acc(p, lwe_in, testv)
    a_groups = abar.reshape(G, n // g, g)
    for j in range(n // g):
        d = [sub_mod(monomial_ntt(a_groups[:, j, i], N), 1, primes_col) for i in range(g)]
        f = ntt_fwd(digits_to_residues(decompose_glwe(p, acc), primes_col), tab)  # [G, rows, NP, N]
        s = None
        for v in range(1, 1 << g):
            idxs = [i for i in range(g) if (v >> i) & 1]
            pv = d[idxs[0]]
            for i in idxs[1:]:
                pv = _generic_modmul(pv, d[i], primes_col)
            bsk = dsk.bsk_ntt[j, v - 1].to(torch.int64)  # [rows, k+1, NP, N]
            bsk_sh = dsk.bsk_ntt_sh[j, v - 1].to(torch.int64)
            t = mul_shoup(f[:, :, None], bsk, bsk_sh, primes_col).sum(dim=1)
            t = reduce_small_sum(t, primes_col, rows + 1)  # [G, k+1, NP, N]
            term = _generic_modmul(pv[:, None], t, primes_col)
            s = term if s is None else add_mod(s, term, primes_col)
        acc = (acc + garner_to_u32(ntt_inv(s, tab), tab)) & M32
    return acc


def keyswitch(dsk: DeviceServerKey, big_lwe: torch.Tensor) -> torch.Tensor:
    """Big-LWE [G, kN+1] -> small-LWE [G, n+1] via one int8 GEMM against
    the four KSK limbs side by side (torch._int_mm; int32 accumulation is
    exact: |digit| <= B/2, |limb| <= 128). Rows are padded to 32 and each
    limb's columns to a multiple of 8 for the CUDA GEMM; the padding is
    sliced off."""
    p = dsk.params
    kn = p.big_n
    G = big_lwe.shape[0]
    a, b = big_lwe[:, :kn], big_lwe[:, kn]
    digits = ops.signed_decompose(a, p.ks_base_log, p.ks_level)
    # [l, G, kN] -> [G, kN*l] with row order i*l + j (matches gen_ksk)
    d8 = digits.permute(1, 2, 0).reshape(G, kn * p.ks_level).to(torch.int8)
    if G <= 16:
        d8 = torch.cat([d8, d8.new_zeros((_MM_MIN_ROWS - G, d8.shape[1]))], dim=0)
    parts = torch._int_mm(d8, dsk.ksk_limbs)[:G].reshape(G, 4, -1)
    acc = None
    for limb in range(4):
        term = (parts[:, limb, : p.n + 1].to(torch.int64) << (8 * limb)) & M32
        acc = term if acc is None else (acc + term) & M32
    out = (0 - acc) & M32
    out[:, p.n] = (out[:, p.n] + b) & M32
    return out


# ----------------------------------------------------------------------
# Test polynomials: the reference's numpy functions (pbs_jnp.py:329-349),
# repeated here because pbs_jnp imports JAX
# ----------------------------------------------------------------------


def gates_test_poly(params: TfheParams) -> np.ndarray:
    """Constant q/8 poly: blind rotation yields +-q/8 (the sign bootstrap)."""
    return np.full((1, params.N), np.uint32(1 << 29), dtype=np.uint32)


def lut_test_poly(params: TfheParams, table: np.ndarray) -> np.ndarray:
    """Programmable test poly from f-values over the padded message space."""
    p = params
    half_space = p.msg_space // 2
    box = p.N // half_space
    vals = (np.asarray(table, dtype=np.uint64) % p.msg_space) * p.delta
    v = np.repeat(vals.astype(np.uint32), box, axis=-1)
    h = box // 2
    lead = v[..., h:]
    wrap = (0 - v[..., :h].astype(np.int64)) % (1 << 32)
    return np.concatenate([lead, wrap.astype(np.uint32)], axis=-1)
