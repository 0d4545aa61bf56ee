"""helm_tpu_torch.fhe.{ops,ntt} against helm_tpu.fhe.{ops,ntt} on jnp.

Same inputs (numpy, fixed seed) through both; the port must return the
same words exactly (zero tolerance: all arithmetic is exact mod 2^32 and
mod the CRT primes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu.fhe import ntt as ref_ntt
from helm_tpu.fhe import ops as ref_ops
from helm_tpu.fhe.modring import NUM_PRIMES, get_tables
from helm_tpu_torch.fhe import ntt, ops
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

SEED = 20261016


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _eq(port, ref):
    np.testing.assert_array_equal(
        np.asarray(port), np.asarray(ref).astype(np.asarray(port).dtype)
    )


@pytest.mark.parametrize("base_log,levels", [(9, 2), (8, 2), (1, 14), (4, 4)])
def test_signed_decompose(base_log, levels):
    v = _u32(np.random.default_rng(SEED), (5, 64))
    ref = np.asarray(ref_ops.signed_decompose(jnp, jnp.asarray(v), base_log, levels))
    port = ops.signed_decompose(ntt.words(v), base_log, levels).numpy()
    _eq(port, ref.astype(np.int64))


@pytest.mark.parametrize("N", [64, 512])
def test_negacyclic_rotate_mod_switch_sample_extract(N):
    rng = np.random.default_rng(SEED + N)
    x = _u32(rng, (6, N))
    r = rng.integers(0, 2 * N, size=6).astype(np.uint32)
    ref = np.asarray(ref_ops.negacyclic_rotate(jnp, jnp.asarray(x), jnp.asarray(r), N))
    _eq(ntt.to_host(ops.negacyclic_rotate(ntt.words(x), ntt.words(r), N)), ref)
    ref = np.asarray(ref_ops.mod_switch(jnp, jnp.asarray(x), N))
    _eq(ntt.to_host(ops.mod_switch(ntt.words(x), N)), ref)
    acc = _u32(rng, (4, 3 + 1, N))
    ref = np.asarray(ref_ops.sample_extract(jnp, jnp.asarray(acc), 3, N))
    _eq(ntt.to_host(ops.sample_extract(ntt.words(acc), 3, N)), ref)


@pytest.mark.parametrize("N", [64, 512, 2048])
def test_ntt_roundtrip_and_garner(N):
    tab = get_tables(N)
    rng = np.random.default_rng(SEED + 7 * N)
    x = _u32(rng, (3, N))
    res_ref = ref_ntt.to_residues(np, x, tab)
    res = ntt.to_residues(ntt.words(x), tab)
    _eq(ntt.to_host(res), res_ref)
    f_ref = ref_ntt.ntt_fwd(np, res_ref, tab)
    f = ntt.ntt_fwd(res, tab)
    _eq(ntt.to_host(f), f_ref)
    _eq(ntt.to_host(ntt.ntt_inv(f, tab)), ref_ntt.ntt_inv(np, f_ref, tab))
    # Garner on arbitrary residues (not just round trips)
    r = np.stack(
        [rng.integers(0, int(p), size=(3, N)) for p in tab.primes], axis=-2
    ).astype(np.uint32)
    _eq(
        ntt.to_host(ntt.garner_to_u32(ntt.words(r), tab)),
        ref_ntt.garner_to_u32(np, r, tab),
    )


def test_generic_modmul_mul_shoup_reduce():
    N = 64
    tab = get_tables(N)
    rng = np.random.default_rng(SEED + 1)
    primes = tab.primes.reshape(NUM_PRIMES, 1)
    x = np.stack([rng.integers(0, int(p), size=N) for p in tab.primes]).astype(np.uint32)
    y = np.stack([rng.integers(0, int(p), size=N) for p in tab.primes]).astype(np.uint32)
    ref = ref_ntt._generic_modmul(np, x, y, primes)
    port = ntt._generic_modmul(ntt.words(x), ntt.words(y), ntt.words(primes))
    _eq(ntt.to_host(port), ref)
    w = tab.psi_rev[:, :N]
    ref = ref_ntt.mul_shoup(np, x, w, tab.psi_rev_sh, primes)
    port = ntt.mul_shoup(
        ntt.words(x), ntt.words(w), ntt.words(tab.psi_rev_sh), ntt.words(primes)
    )
    _eq(ntt.to_host(port), ref)
    s = (x.astype(np.uint64) + y).astype(np.uint32)
    _eq(
        ntt.to_host(ntt.reduce_small_sum(ntt.words(s), ntt.words(primes), 2)),
        ref_ntt.reduce_small_sum(np, s, primes, 2),
    )


def test_i32_bit_patterns_roundtrip():
    x = _u32(np.random.default_rng(SEED + 2), (1000,))
    t = ntt.to_i32_bits(ntt.words(x))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), x.view(np.int32))
    _eq(ntt.to_host(ntt.from_i32_bits(t)), x)
