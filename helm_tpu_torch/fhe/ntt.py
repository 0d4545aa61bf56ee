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

from .modring import NUM_PRIMES, SHOUP_SHIFT, NttTables, get_tables

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


def _generic_modmul(a, b, p):
    """(a*b) mod p for a,b < p <= 2^16+1 without precomputation (the
    reference's 16-bit split, kept so intermediate values match)."""
    bh = b >> 8
    bl = b & 0xFF
    t = torch.remainder(a * bh, p)
    return torch.remainder(
        torch.remainder((t << 8) & M32, p) + torch.remainder(a * bl, p), p
    )
