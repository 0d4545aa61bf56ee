"""Exact negacyclic NTT over the 4-prime CRT ring, on torch tensors.

Counterpart of `helm_tpu/fhe/ntt.py` (same transforms, same Shoup
multiplies, same Garner recombination) and built from the same tables
(`modring.get_tables`, the port's copy of
`helm_tpu/fhe/modring.py`), so every function returns the same
words as its numpy / jnp twin.

Word representation (used everywhere in helm_tpu_torch): a uint32 word is
carried as a non-negative ``torch.int64`` value in [0, 2^32). torch's
``uint32`` has no add, shift or compare on the CPU, and int32 bit patterns
would need masked logical shifts and sign-flipped compares. In int64:

- right shifts of values in [0, 2^32) are logical;
- compares (``r >= p``, ``x >= 2^31``) are unsigned compares;
- wrapping add / sub / mul is the exact result ``& M32`` (``&`` on a
  negative int64 is two's complement, so ``(a - b) & M32`` wraps too);
- ``%`` is ``torch.remainder`` (floor-mod, as numpy), never ``torch.fmod``.

Data moves between the packages with `words` (numpy uint32 -> int64
tensor) and `to_host` (tensor -> numpy uint32). The CUDA kernels take
int32 bit patterns (`to_i32_bits` / `from_i32_bits`).

Shapes: data arrays are [..., NP, N] with the prime axis second-to-last.
Forward = merged-psi Cooley-Tukey (natural -> bit-reversed); inverse =
Gentleman-Sande (bit-reversed -> natural) with a final N^-1 scale.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .modring import (
    NUM_PRIMES,
    SHOUP_SHIFT,
    NttTables,
    _bit_reverse,
    get_tables,
    primes_for,
    root_of_unity,
    shoup,
)

M32 = 0xFFFFFFFF


def words(a, device=None) -> torch.Tensor:
    """numpy uint32 words -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64)).to(
        device
    )


def to_host(t: torch.Tensor) -> np.ndarray:
    """int64 word tensor -> numpy uint32 (wrapping)."""
    return (t.detach().cpu().numpy() & M32).astype(np.uint32)


def to_i32_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return (((t & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def from_i32_bits(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return t.to(torch.int64) & M32


@functools.lru_cache(maxsize=None)
def device_tables(N: int, device: str) -> dict:
    """`get_tables(N)` as int64 tensors on `device` (cached per device)."""
    tab = get_tables(N)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)  # noqa: E731
    return {
        "primes_col": t(tab.primes).reshape(NUM_PRIMES, 1),
        "primes_3": t(tab.primes).reshape(NUM_PRIMES, 1, 1),
        "psi_rev": t(tab.psi_rev),
        "psi_rev_sh": t(tab.psi_rev_sh),
        "psi_inv_rev": t(tab.psi_inv_rev),
        "psi_inv_rev_sh": t(tab.psi_inv_rev_sh),
        "n_inv": t(tab.n_inv).reshape(NUM_PRIMES, 1),
        "n_inv_sh": t(tab.n_inv_sh).reshape(NUM_PRIMES, 1),
        "q_mod_p": t([(1 << 32) % int(p) for p in tab.primes]).reshape(
            NUM_PRIMES, 1
        ),
    }


def _dt(tab: NttTables, x: torch.Tensor) -> dict:
    return device_tables(tab.N, str(x.device))


def mul_shoup(a, w, w_sh, p):
    """(a * w) mod p with precomputed w_sh = floor(w*2^16/p). Exact.

    Requires a <= 2^16. The u32 wraps of the reference are `& M32` here."""
    q = ((a * w_sh) & M32) >> SHOUP_SHIFT
    r = (a * w - q * p) & M32
    return torch.where(r >= p, r - p, r)


def add_mod(a, b, p):
    r = a + b
    return torch.where(r >= p, r - p, r)


def sub_mod(a, b, p):
    r = a - b
    return torch.where(a < b, r + p, r)


def reduce_small_sum(r, p, max_mult: int):
    """Reduce r < max_mult*p to [0, p) by conditional subtractions."""
    m = 1
    while m * 2 < max_mult:
        m *= 2
    while m >= 1:
        mp = p * m
        r = torch.where(r >= mp, r - mp, r)
        m //= 2
    return r


def ntt_fwd(x: torch.Tensor, tab: NttTables) -> torch.Tensor:
    """Forward negacyclic NTT. x: int64 [..., NP, N] reduced mod primes."""
    N = tab.N
    lead = x.shape[:-2]
    d = _dt(tab, x)
    psi, psi_sh, p3 = d["psi_rev"], d["psi_rev_sh"], d["primes_3"]
    m, t = 1, N
    while m < N:
        t //= 2
        v = x.reshape(lead + (NUM_PRIMES, m, 2, t))
        s = psi[:, m : 2 * m].reshape(NUM_PRIMES, m, 1)
        s_sh = psi_sh[:, m : 2 * m].reshape(NUM_PRIMES, m, 1)
        u = v[..., 0, :]
        w = mul_shoup(v[..., 1, :], s, s_sh, p3)
        x = torch.stack([add_mod(u, w, p3), sub_mod(u, w, p3)], dim=-2).reshape(
            lead + (NUM_PRIMES, N)
        )
        m *= 2
    return x


def ntt_inv(x: torch.Tensor, tab: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT (consumes bit-reversed order)."""
    N = tab.N
    lead = x.shape[:-2]
    d = _dt(tab, x)
    psi, psi_sh, p3 = d["psi_inv_rev"], d["psi_inv_rev_sh"], d["primes_3"]
    t, m = 1, N
    while m > 1:
        h = m // 2
        v = x.reshape(lead + (NUM_PRIMES, h, 2, t))
        s = psi[:, h : 2 * h].reshape(NUM_PRIMES, h, 1)
        s_sh = psi_sh[:, h : 2 * h].reshape(NUM_PRIMES, h, 1)
        u = v[..., 0, :]
        w = v[..., 1, :]
        x = torch.stack(
            [add_mod(u, w, p3), mul_shoup(sub_mod(u, w, p3), s, s_sh, p3)], dim=-2
        ).reshape(lead + (NUM_PRIMES, N))
        t *= 2
        m = h
    return mul_shoup(x, d["n_inv"], d["n_inv_sh"], d["primes_col"])


def to_residues(x: torch.Tensor, tab: NttTables) -> torch.Tensor:
    """Balanced-signed residues of words: [..., N] -> [..., NP, N].

    Values are interpreted as signed representatives in [-2^31, 2^31)."""
    d = _dt(tab, x)
    primes, q_mod_p = d["primes_col"], d["q_mod_p"]
    x = x[..., None, :]
    neg = x >= (1 << 31)
    r = torch.remainder(x, primes)
    r_neg = torch.where(r < q_mod_p, r + primes - q_mod_p, r - q_mod_p)
    return torch.where(neg, r_neg, r)


def digits_to_residues(d: torch.Tensor, primes_col: torch.Tensor) -> torch.Tensor:
    """Signed gadget digits [..., N] -> residues [..., NP, N] (floor-mod)."""
    return torch.remainder(d[..., None, :].to(torch.int64), primes_col)


def garner_to_u32(r: torch.Tensor, tab: NttTables) -> torch.Tensor:
    """Residues [..., NP, N] -> exact signed value mod 2^32 ([..., N] words)."""
    g = tab.garner
    p0, p1, p2, p3 = (int(p) for p in tab.primes)
    r0, r1, r2, r3 = (r[..., i, :] for i in range(NUM_PRIMES))
    ms = mul_shoup
    v0 = r0
    t1 = sub_mod(r1, v0 % p1, p1)
    v1 = ms(t1, g.inv_p0_mod_p1, g.inv_p0_mod_p1_sh, p1)
    m2 = add_mod(v0 % p2, ms(v1, g.p0_mod_p2, g.p0_mod_p2_sh, p2), p2)
    t2 = sub_mod(r2, m2, p2)
    v2 = ms(t2, g.inv_p01_mod_p2, g.inv_p01_mod_p2_sh, p2)
    m3 = add_mod(v0 % p3, ms(v1, g.p0_mod_p3, g.p0_mod_p3_sh, p3), p3)
    m3 = add_mod(m3, ms(v2, g.p01_mod_p3, g.p01_mod_p3_sh, p3), p3)
    t3 = sub_mod(r3, m3, p3)
    v3 = ms(t3, g.inv_p012_mod_p3, g.inv_p012_mod_p3_sh, p3)
    # Horner evaluation mod 2^32 (every partial product stays below 2^50)
    x = (v0 + p0 * ((v1 + p1 * ((v2 + p2 * v3) & M32)) & M32)) & M32
    # balanced lift: the true value is negative iff the top digit is large
    return torch.where(v3 > g.half_p3, (x - g.prod_mod_q) & M32, x)


@dataclass(frozen=True)
class CrtConstants:
    """The CRT partial-sum fold's constants for one prime set: with P the
    prime product and W_i = (P/p_i) * ((P/p_i)^-1 mod p_i), w_mod[i] is
    W_i mod 2^32, frac[i] is W_i / P = ((P/p_i)^-1 mod p_i) / p_i as a
    float64, prod_mod is P mod 2^32."""

    primes: tuple
    w_mod: tuple
    frac: tuple
    prod_mod: int


@functools.lru_cache(maxsize=None)
def crt_constants(N: int) -> CrtConstants:
    primes = tuple(int(p) for p in get_tables(N).primes)
    prod = 1
    for p in primes:
        prod *= p
    w_mod, frac = [], []
    for p in primes:
        inv = pow(prod // p, -1, p)
        w_mod.append((prod // p) * inv % (1 << 32))
        frac.append(inv / p)
    return CrtConstants(primes, tuple(w_mod), tuple(frac), prod % (1 << 32))


def crt_fold(r: torch.Tensor, tab: NttTables) -> torch.Tensor:
    """Residues [..., NP, N] -> the balanced value mod 2^32 ([..., N]
    words), by the CRT partial sums of the prime-split kernel
    (`helm_tpu/ops/mxu_pbs.py` `_crt_fast` :362 and the `crtacc` fold
    :2388-2413): x = sum_i r_i * W_i - k * P with k = round(sum_i r_i *
    W_i / P), taken mod 2^32.

    The quotient estimate is exact. The true value x satisfies
    sum_i r_i W_i = x + k P for an integer k, so S = sum_i r_i W_i / P =
    k + x / P, and |x| <= params.conv_bound() bounds |x| / P by 0.389 at
    most over every set of `params.ALL_PARAMS` (GATES_128_K3 with
    PRIMES_512: 2^54.00 against 2^55.36; 0.007 at ARITH_128_MB2, 0.006 at
    LUT_128_K2): S lies at least 0.11 from a half-integer. Here S is a float64 sum of four products r_i * frac_i
    with r_i < 2^17 and frac_i in (0, 1) rounded to 53 bits: its error is
    below 2^-32, so floor(S + 0.5) is k. (The TPU kernel sums in float32,
    error below 2^-6.) The result equals `garner_to_u32`'s whenever
    |x| <= conv_bound."""
    c = crt_constants(tab.N)
    total = None
    s = None
    for i in range(NUM_PRIMES):
        ri = r[..., i, :]
        t = ri * c.w_mod[i]  # < 2^49: the sum of four stays exact in int64
        f = ri.to(torch.float64) * c.frac[i]
        total = t if total is None else total + t
        s = f if s is None else s + f
    k = torch.floor(s + 0.5).to(torch.int64)
    return (total - k * c.prod_mod) & M32


# ----------------------------------------------------------------------
# The four-step transform (helm_tpu/ops/mxu_ntt.py): N = N1 * N2 with
# N1 = 8. Forward: x [N1 (jA), N2 (jB)] -> three negacyclic 8-point
# Cooley-Tukey stages over jA -> twist -> out = U @ W2, W2[jB, fB] =
# w^(8 jB fB). Stored index fA_s * N2 + fB holds frequency bitrev3(fA_s) +
# 8 fB of the evaluation set psi^(2f+1): the same set as `ntt_fwd`'s, so
# the two orders differ by the fixed permutation `perm_from_std`. The
# N2-point stage is an exact product of signed 8-bit limbs (the Hopper
# kernel K4 runs it on the int8 tensor cores), never a float product of
# whole residues.
# ----------------------------------------------------------------------

N1, LOG_N1 = 8, 3
#: the most 8-bit signed limbs a balanced residue needs (p = 65537)
MAX_LIMBS = 3


def limb_count(p: int) -> int:
    """Signed 8-bit limbs that hold every balanced residue of p, i.e.
    [-(p//2), p//2]. Two limbs hold [-32896, 32639]: every prime below
    65279. p = 65537 balances to +-32768 and takes three: two 8-bit limbs
    have 65536 values, one fewer than its residues, so no two-limb split
    holds them all."""
    return 2 if p // 2 <= 32639 else MAX_LIMBS


def split_limbs(b, nl: int) -> list:
    """Balanced integers -> nl signed 8-bit limbs l_i in [-128, 127] with
    b = sum_i l_i 256^i (exact whenever b is inside the nl-limb range)."""
    out = []
    for _ in range(nl):
        lo = ((b + 128) & 255) - 128
        out.append(lo)
        b = (b - lo) >> 8
    return out


def balanced(x, p):
    """Residues in [0, p) -> balanced representatives in [-(p//2), p//2]."""
    return torch.where(x > p // 2, x - p, x)


def _br3(x: int) -> int:
    return _bit_reverse(x, LOG_N1)


@functools.lru_cache(maxsize=None)
def mxu_tables(N: int) -> dict:
    """Host tables of the four-step transform at size N (numpy), the
    values of `helm_tpu/ops/mxu_ntt.py` `mxu_tables` (:47):
    perm_from_std [N]; stage_tw / istage_tw (+ _sh) [NP, 3, N1], the
    8-point stages' per-row twiddles; tw / twi (+ _sh) [NP, N1, N2], the
    twists (twi folds in 1/N1); w2 / w2i [NP, N2, N2], the N2-point
    matrices mod p (w2i folds in 1/N2), and w2_limbs / w2i_limbs
    [NP, MAX_LIMBS, N2, N2] int8, their balanced 8-bit limbs (the limbs
    past limb_count(p) are zero); limbs [NP]."""
    assert N % N1 == 0
    N2 = N // N1
    primes = primes_for(N)
    logN = N.bit_length() - 1
    t = {"N2": N2, "primes": primes}
    perm = np.zeros(N, dtype=np.int64)
    for fa_s in range(N1):
        for fb in range(N2):
            perm[fa_s * N2 + fb] = _bit_reverse(_br3(fa_s) + N1 * fb, logN)
    t["perm_from_std"] = perm
    u32 = lambda *s: np.zeros(s, np.uint32)  # noqa: E731
    names = ("stage_tw", "istage_tw", "tw", "twi")
    shapes = ((NUM_PRIMES, LOG_N1, N1),) * 2 + ((NUM_PRIMES, N1, N2),) * 2
    for name, shape in zip(names, shapes):
        t[name], t[name + "_sh"] = u32(*shape), u32(*shape)
    t["w2"] = np.zeros((NUM_PRIMES, N2, N2), np.int64)
    t["w2i"] = np.zeros_like(t["w2"])
    t["w2_limbs"] = np.zeros((NUM_PRIMES, MAX_LIMBS, N2, N2), np.int8)
    t["w2i_limbs"] = np.zeros_like(t["w2_limbs"])
    t["limbs"] = np.array([limb_count(p) for p in primes], np.int64)

    def put(name, idx, v, p):
        t[name][idx] = v
        t[name + "_sh"][idx] = shoup(v, p)

    jb = np.arange(N2)
    for pi, p in enumerate(primes):
        psi = root_of_unity(p, 2 * N)
        w = psi * psi % p
        psii, wi = pow(psi, -1, p), pow(w, -1, p)
        inv_n1 = pow(N1, -1, p)
        for fa_s in range(N1):
            fa = _br3(fa_s)
            for j in range(N2):
                put("tw", (pi, fa_s, j), pow(psi, j, p) * pow(w, j * fa % N, p) % p, p)
                put("twi", (pi, fa_s, j), pow(psii, j, p) * pow(wi, j * fa % N, p) * inv_n1 % p, p)
        w2n = pow(w, N1, p)
        w2ni, inv_n2 = pow(w2n, -1, p), pow(N2, -1, p)
        pw_f = np.array([pow(w2n, e, p) for e in range(N2)], np.int64)
        pw_i = np.array([pow(w2ni, e, p) * inv_n2 % p for e in range(N2)], np.int64)
        e = np.outer(jb, jb) % N2
        t["w2"][pi], t["w2i"][pi] = pw_f[e], pw_i[e]
        for name in ("w2", "w2i"):
            b = torch.from_numpy(t[name][pi])
            for li, limb in enumerate(split_limbs(balanced(b, p), limb_count(p))):
                t[name + "_limbs"][pi, li] = limb.numpy().astype(np.int8)
        # the 8-point stages are the merged-psi negacyclic transform at size
        # N1 with root psi8 = psi^N2: row r of stage s takes T8[m + block]
        psi8 = pow(psi, N // N1, p)
        psi8i = pow(psi8, -1, p)
        for s in range(LOG_N1):
            fwd_t, inv_t = N1 >> (s + 1), 1 << s
            for r in range(N1):
                put("stage_tw", (pi, s, r), pow(psi8, _br3((1 << s) + r // (2 * fwd_t)), p), p)
                put("istage_tw", (pi, s, r), pow(psi8i, _br3((N1 >> (s + 1)) + r // (2 * inv_t)), p), p)
    return t


@functools.lru_cache(maxsize=None)
def _four_step_device(N: int, device: str) -> dict:
    t = mxu_tables(N)
    d = {k: torch.from_numpy(np.asarray(t[k]).astype(np.int64)).to(device)
         for k in ("stage_tw", "stage_tw_sh", "istage_tw", "istage_tw_sh", "tw", "tw_sh",
                   "twi", "twi_sh")}
    for name in ("w2_limbs", "w2i_limbs"):  # operands of the float64 limb products
        d[name] = torch.from_numpy(t[name].astype(np.float64)).to(device)
    d["primes"] = torch.tensor(t["primes"], dtype=torch.int64, device=device).reshape(NUM_PRIMES, 1, 1)
    d["pow256"] = [[pow(256, s, p) for s in range(2 * MAX_LIMBS - 1)] for p in t["primes"]]
    return d


def _limb_product(v: torch.Tensor, w_limbs: torch.Tensor, N: int) -> torch.Tensor:
    """(v @ W) mod p per prime: v [..., NP, N1, N2] residues, W given by its
    limbs [NP, MAX_LIMBS, N2, N2]. Both operands are split into signed
    8-bit limbs, and each limb pair is one matrix product of those small
    integers: |limb x limb| <= 2^14, so every sum of N2 <= 256 terms is an
    integer below 2^22 in magnitude. The products run in float64, whose
    53-bit mantissa holds every such sum exactly, on the CPU and on the
    card alike (cuBLASLt refuses some int8 shapes of torch._int_mm); the
    limb shifts are recombined mod p in int64."""
    t = mxu_tables(N)
    d = _four_step_device(N, str(v.device))
    lead, N2 = v.shape[:-3], v.shape[-1]
    outs = []
    for pi, p in enumerate(t["primes"]):
        nl = limb_count(p)
        a = balanced(v[..., pi, :, :].reshape(-1, N2), p)
        a_limbs = [x.to(torch.float64) for x in split_limbs(a, nl)]
        shifts = [None] * (2 * nl - 1)
        for la, al in enumerate(a_limbs):
            for lw in range(nl):
                m = (al @ w_limbs[pi, lw]).to(torch.int64)
                s = la + lw
                shifts[s] = m if shifts[s] is None else shifts[s] + m
        acc = sum(shifts[s] * d["pow256"][pi][s] for s in range(len(shifts)))
        outs.append(torch.remainder(acc, p).reshape(lead + (N1, N2)))
    return torch.stack(outs, dim=-3)


def ntt_fwd_four_step(x: torch.Tensor, N: int) -> torch.Tensor:
    """Forward four-step NTT of residues [..., NP, N], out in the stored
    order (`mxu_ntt.fwd_ref` for every prime at once; equal to
    ntt_fwd(x)[..., perm_from_std])."""
    d = _four_step_device(N, str(x.device))
    p = d["primes"]
    lead = x.shape[:-2]
    N2 = N // N1
    for s in range(LOG_N1):
        t = N1 >> (s + 1)
        v = x.reshape(lead + (NUM_PRIMES, N1 // (2 * t), 2, t, N2))
        # the stage's twiddle sits on the pair's lower row
        tw = d["stage_tw"][:, s].reshape(NUM_PRIMES, N1 // (2 * t), 2, t, 1)[:, :, 0]
        tw_sh = d["stage_tw_sh"][:, s].reshape(NUM_PRIMES, N1 // (2 * t), 2, t, 1)[:, :, 0]
        pc = p.reshape(NUM_PRIMES, 1, 1, 1)
        u, w = v[..., 0, :, :], mul_shoup(v[..., 1, :, :], tw, tw_sh, pc)
        x = torch.stack([add_mod(u, w, pc), sub_mod(u, w, pc)], dim=-3)
    v = mul_shoup(x.reshape(lead + (NUM_PRIMES, N1, N2)), d["tw"], d["tw_sh"], p)
    return _limb_product(v, d["w2_limbs"], N).reshape(lead + (NUM_PRIMES, N))


def ntt_inv_four_step(y: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of `ntt_fwd_four_step`: stored order in, natural order out,
    scaled by N^-1 (`mxu_ntt.inv_ref`; equal to ntt_inv(y_std))."""
    d = _four_step_device(N, str(y.device))
    p = d["primes"]
    lead = y.shape[:-2]
    N2 = N // N1
    v = _limb_product(y.reshape(lead + (NUM_PRIMES, N1, N2)), d["w2i_limbs"], N)
    x = mul_shoup(v, d["twi"], d["twi_sh"], p)
    for s in range(LOG_N1):
        t = 1 << s
        v = x.reshape(lead + (NUM_PRIMES, N1 // (2 * t), 2, t, N2))
        tw = d["istage_tw"][:, s].reshape(NUM_PRIMES, N1 // (2 * t), 2, t, 1)[:, :, 0]
        tw_sh = d["istage_tw_sh"][:, s].reshape(NUM_PRIMES, N1 // (2 * t), 2, t, 1)[:, :, 0]
        pc = p.reshape(NUM_PRIMES, 1, 1, 1)
        u, w = v[..., 0, :, :], v[..., 1, :, :]
        x = torch.stack([add_mod(u, w, pc), mul_shoup(sub_mod(u, w, pc), tw, tw_sh, pc)], dim=-3)
    return x.reshape(lead + (NUM_PRIMES, N))


# ----------------------------------------------------------------------
# The matrix operand of the Hopper kernel's N2-point products. Two signed
# 8-bit limbs hold the integers [-32896, 32639] (`WINDOW`). A residue x mod
# p has a representative there, x itself up to 32639, else x - p, unless
# 32639 < x < p - 32896: no residue of a prime below 65536, and of 65537
# exactly one, 32640. The kernel scales each N2 x N2 matrix of 65537 by the
# least c that moves every entry off it, so that the matrix takes two limbs
# (the data operand keeps limb_count(p)), and folds c^-1 into the limb
# shifts' recombination constants: sum_s acc_s (256^s c^-1 mod p).
# ----------------------------------------------------------------------

#: the integers two signed 8-bit limbs hold
WINDOW = (-128 - 128 * 256, 127 + 127 * 256)


def window(x, p):
    """Residues in [0, p) -> their representatives in `WINDOW` (x, or x - p
    above 32639); asserts that every one has one."""
    r = np.where(np.asarray(x) > WINDOW[1], np.asarray(x) - p, np.asarray(x))
    assert (r >= WINDOW[0]).all(), f"a residue mod {p} has no two-limb representative"
    return r


def matrix_scale(w: np.ndarray, p: int) -> int:
    """The least c >= 1 such that every entry of c w mod p has a two-limb
    representative: 1 for every prime below 65536."""
    for c in range(1, p):
        v = (np.asarray(w, np.int64) * c) % p
        if not ((v > WINDOW[1]) & (v < p + WINDOW[0])).any():
            return c
    raise ValueError(f"no scale puts every entry mod {p} in two limbs")


@functools.lru_cache(maxsize=None)
def window_tables(N: int) -> dict:
    """The four-step matrices as the Hopper kernel multiplies them: per
    prime, the scale c of `matrix_scale` and the two limbs of c w2 mod p
    (and of c w2i) in `WINDOW`, w2_win / w2i_win [NP, 2, N2, N2] int8;
    their recombination constants 256^s c^-1 mod p, s < 2 MAX_LIMBS - 2
    (the data's limbs plus one), w2_rc / w2i_rc [NP, 4]; and the data's
    limb counts, limbs [NP]."""
    t = mxu_tables(N)
    out = {"limbs": t["limbs"]}
    for name in ("w2", "w2i"):
        scale, limbs, rc = [], [], []
        for pi, p in enumerate(t["primes"]):
            c = matrix_scale(t[name][pi], p)
            rep = window((t[name][pi] * c) % p, p)
            limbs.append(np.stack([x.astype(np.int8) for x in split_limbs(rep, 2)]))
            rc.append([pow(256, s, p) * pow(c, -1, p) % p for s in range(2 * MAX_LIMBS - 2)])
            scale.append(c)
        out[name + "_scale"] = np.array(scale, np.int64)
        out[name + "_win"] = np.stack(limbs)
        out[name + "_rc"] = np.array(rc, np.int64)
    return out


def _generic_modmul(a, b, p):
    """(a*b) mod p for a,b < p <= 2^16+1 without precomputation (the
    reference's 16-bit split, kept so intermediate values match)."""
    bh = b >> 8
    bl = b & 0xFF
    t = torch.remainder(a * bh, p)
    return torch.remainder(
        torch.remainder((t << 8) & M32, p) + torch.remainder(a * bl, p), p
    )
