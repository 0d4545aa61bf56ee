"""CRT prime ring: host-side table construction for the exact negacyclic NTT.

Four NTT-friendly primes per polynomial size (primes_for), all == 1
(mod 2N), all <= 2^16 + 1, so every modular multiplication can be a Shoup
multiplication in pure wrapping-u32 arithmetic (see DESIGN.md section 2).
Smaller N rings use deliberately SMALLER primes: the fs kernel's f32
pointwise chains reduce every floor(2^24/((max_p/2+1)*128)) products, so
a small max_p buys longer exact accumulation runs (PRIMES_512 notes).

The external products computed over these primes are bounded by
params.TfheParams.conv_bound() — the multibit form
(3^g - 1) * sum_rows(B_r/2) * N * 2^31 — which keygen asserts is < P/2,
so CRT residues determine the true signed integer result exactly;
`GarnerConstants` recombines residues into the value mod 2^32 with a
balanced lift.

All tables are built with exact Python integers and exported as numpy arrays.

The port's own copy of `helm_tpu/fhe/modring.py`, trimmed to what the
port calls, so that helm_tpu_torch imports nothing of the JAX package;
the tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

#: Default prime set (supports negacyclic N <= 2048; all == 1 mod 4096).
PRIMES = (12289, 40961, 61441, 65537)  # ascending; product ~ 2^59.8
#: N <= 1024 set (all == 1 mod 2048 and <= 61441, so balanced residues fit
#: two int8 limbs — required by the MXU matmul NTT path).
PRIMES_1024 = (12289, 40961, 59393, 61441)  # product ~ 2^59.7
#: N <= 512 set (all == 1 mod 1024), chosen SMALL on purpose: the fs
#: kernel's f32 pointwise chains may accumulate floor(2^24/((p/2+1)*128))
#: products before an exactness-forced Barrett reduction, so max_p = 18433
#: gives chunk = 14 >= gadget_rows — ZERO mid-chain reductions — where the
#: previous 61441 forced one every 4. Product 2^55.36 still exceeds the
#: exact-convolution bound of every N<=512 set (asserted by
#: params.TfheParams.conv_bound_log2 at keygen and pinned in
#: tests/test_params_keys.py).
PRIMES_512 = (12289, 13313, 15361, 18433)  # product ~ 2^55.36
NUM_PRIMES = len(PRIMES)


def primes_for(N: int) -> tuple:
    if N <= 512:
        return PRIMES_512
    return PRIMES_1024 if N <= 1024 else PRIMES

SHOUP_SHIFT = 16  # beta = 2^16


def shoup(w: int, p: int) -> int:
    """Shoup precomputation floor(w * 2^16 / p); requires w < p <= 2^16+1."""
    return (w << SHOUP_SHIFT) // p


def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


@functools.lru_cache(maxsize=None)
def primitive_root(p: int) -> int:
    fs = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in fs):
            return g
    raise ValueError(f"no primitive root for {p}")


def root_of_unity(p: int, order: int) -> int:
    assert (p - 1) % order == 0, (p, order)
    w = pow(primitive_root(p), (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@dataclass(frozen=True, eq=False)  # identity hash: safe as jit static aux
class NttTables:
    """Per-N twiddle tables for all primes, plus Garner CRT constants.

    Array layout: prime axis first, shape [NUM_PRIMES, N]; uint32.
    `psi_rev[i][m + j] = psi_i^{bitrev(j)}` feeding the merged-psi CT/GS
    negacyclic transform pair (Longa–Naehrig formulation).
    """

    N: int
    primes: np.ndarray  # [NP] uint32
    psi_rev: np.ndarray  # [NP, N] uint32
    psi_rev_sh: np.ndarray
    psi_inv_rev: np.ndarray
    psi_inv_rev_sh: np.ndarray
    n_inv: np.ndarray  # [NP] uint32
    n_inv_sh: np.ndarray
    garner: "GarnerConstants"


@dataclass(frozen=True)
class GarnerConstants:
    """Mixed-radix (Garner) recombination of 4-prime residues to u32.

    With residues r_i mod p_i (p ascending), digits:
        v0 = r0
        v1 = (r1 - v0) * inv(p0)        mod p1
        v2 = (r2 - v0 - v1*p0) * inv(p0 p1)    mod p2
        v3 = (r3 - v0 - v1*p0 - v2*p0 p1) * inv(p0 p1 p2)  mod p3
        x  = v0 + p0*(v1 + p1*(v2 + p2*v3))    (wrapping u32 == mod 2^32)
    balanced lift: subtract (P mod 2^32) when v3 > p3/2.
    """

    inv_p0_mod_p1: int
    inv_p0_mod_p1_sh: int
    p0_mod_p2: int
    p0_mod_p2_sh: int
    inv_p01_mod_p2: int
    inv_p01_mod_p2_sh: int
    p0_mod_p3: int
    p0_mod_p3_sh: int
    p01_mod_p3: int
    p01_mod_p3_sh: int
    inv_p012_mod_p3: int
    inv_p012_mod_p3_sh: int
    prod_mod_q: int  # P mod 2^32
    half_p3: int


def _garner_constants(primes) -> GarnerConstants:
    p0, p1, p2, p3 = primes

    def inv(a, p):
        return pow(a, -1, p)

    vals = dict(
        inv_p0_mod_p1=inv(p0, p1),
        p0_mod_p2=p0 % p2,
        inv_p01_mod_p2=inv(p0 * p1, p2),
        p0_mod_p3=p0 % p3,
        p01_mod_p3=(p0 * p1) % p3,
        inv_p012_mod_p3=inv(p0 * p1 * p2, p3),
    )
    mods = dict(
        inv_p0_mod_p1=p1,
        p0_mod_p2=p2,
        inv_p01_mod_p2=p2,
        p0_mod_p3=p3,
        p01_mod_p3=p3,
        inv_p012_mod_p3=p3,
    )
    kwargs = {}
    for k, v in vals.items():
        kwargs[k] = v
        kwargs[k + "_sh"] = shoup(v, mods[k])
    prod = p0 * p1 * p2 * p3
    return GarnerConstants(
        prod_mod_q=prod % (1 << 32), half_p3=p3 // 2, **kwargs
    )


@functools.lru_cache(maxsize=None)
def get_tables(N: int) -> NttTables:
    assert N & (N - 1) == 0 and 4 <= N <= 2048, N
    primes = primes_for(N)
    bits = N.bit_length() - 1
    psi_rev = np.zeros((NUM_PRIMES, N), dtype=np.uint32)
    psi_rev_sh = np.zeros_like(psi_rev)
    psi_inv_rev = np.zeros_like(psi_rev)
    psi_inv_rev_sh = np.zeros_like(psi_rev)
    n_inv = np.zeros(NUM_PRIMES, dtype=np.uint32)
    n_inv_sh = np.zeros(NUM_PRIMES, dtype=np.uint32)
    for pi, p in enumerate(primes):
        psi = root_of_unity(p, 2 * N)
        psi_inv = pow(psi, -1, p)
        for j in range(N):
            br = _bit_reverse(j, bits)
            w = pow(psi, br, p)
            wi = pow(psi_inv, br, p)
            psi_rev[pi, j] = w
            psi_rev_sh[pi, j] = shoup(w, p)
            psi_inv_rev[pi, j] = wi
            psi_inv_rev_sh[pi, j] = shoup(wi, p)
        ninv = pow(N, -1, p)
        n_inv[pi] = ninv
        n_inv_sh[pi] = shoup(ninv, p)
    return NttTables(
        N=N,
        primes=np.array(primes, dtype=np.uint32),
        psi_rev=psi_rev,
        psi_rev_sh=psi_rev_sh,
        psi_inv_rev=psi_inv_rev,
        psi_inv_rev_sh=psi_inv_rev_sh,
        n_inv=n_inv,
        n_inv_sh=n_inv_sh,
        garner=_garner_constants(primes),
    )
