"""helm_tpu_torch.fhe.pbs / ops.mb_pbs / ops.sb_pbs against helm_tpu.

Same keys (the reference's, carried across with
`server_key_from_reference`) and the same ciphertexts (numpy, fixed
seeds) through the jnp reference and through the port on CPU tensors; the
words must be equal (zero tolerance — the pipeline is exact integer
arithmetic). pbs_jnp is the reference that tests/test_pallas.py pins the
TPU kernels to; the single-bit plain version is also held against the two
TPU kernels it replaces, run in interpret mode as tests/test_pallas.py
runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu import params as P
from helm_tpu.fhe import lwe, pbs_jnp
from helm_tpu.fhe import ops as ref_ops
from helm_tpu.fhe.server_key import gen_server_key
from helm_tpu_torch.fhe import pbs
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.ops import mb_pbs, sb_pbs
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

SETS = {
    "k3": (P.TEST_PARAMS_K3, 31),
    "mb2": (P.TEST_PARAMS_MB, 32),
    "g1": (P.TEST_PARAMS, 33),
}


@pytest.fixture(scope="module")
def keys():
    """(client key, jnp device key, port device key) per set, made once."""
    out = {}
    for name, (p, seed) in SETS.items():
        ck = lwe.keygen(p, seed)
        sk = gen_server_key(ck)
        out[name] = (
            ck,
            pbs_jnp.DeviceServerKey.from_host(sk),
            pbs.DeviceServerKey.from_host(server_key_from_reference(sk), "cpu"),
        )
    return out


def _ctxts(ck, G, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G).astype(bool)
    return lwe.encrypt(ck, lwe.encode_bool(bits)), rng


def _testv(p, G, rng, per_gate):
    if not per_gate:
        return pbs_jnp.gates_test_poly(p)
    return rng.integers(0, 1 << 32, size=(G, p.N), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name,G,per_gate", [("k3", 5, True), ("mb2", 4, False)])
def test_blind_rotate_multibit_matches_jnp(keys, name, G, per_gate):
    ck, jdsk, tdsk = keys[name]
    x, rng = _ctxts(ck, G, 100 + G)
    tv = _testv(ck.params, G, rng, per_gate)
    ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    got = to_host(pbs.blind_rotate_multibit(tdsk, words(x), words(tv)))
    np.testing.assert_array_equal(got, ref)
    # the dispatcher takes the plain path for CPU tensors
    np.testing.assert_array_equal(to_host(mb_pbs.blind_rotate_mb(tdsk, words(x), words(tv))), ref)


def test_blind_rotate_g1_matches_jnp(keys):
    ck, jdsk, tdsk = keys["g1"]
    x, rng = _ctxts(ck, 3, 7)
    tv = _testv(ck.params, 3, rng, False)
    ref = np.asarray(pbs_jnp.blind_rotate(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    np.testing.assert_array_equal(to_host(pbs.blind_rotate(tdsk, words(x), words(tv))), ref)
    # the wrapper takes the plain path for CPU tensors, per-gate test polys too
    tv = _testv(ck.params, 3, rng, True)
    ref = np.asarray(pbs_jnp.blind_rotate(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    np.testing.assert_array_equal(to_host(sb_pbs.blind_rotate_sb(tdsk, words(x), words(tv))), ref)


@pytest.mark.parametrize("kernel", ["blind_rotate_pallas", "blind_rotate_mxu"])
def test_blind_rotate_sb_plain_matches_tpu_kernel(keys, kernel):
    """K2's plain version against the TPU kernel it replaces (K2b, K2a),
    interpret mode, TEST_PARAMS, G=4."""
    from helm_tpu.ops import mxu_pbs, pallas_pbs

    ck, jdsk, tdsk = keys["g1"]
    p = ck.params
    x, _ = _ctxts(ck, 4, 17)
    tv = jnp.asarray(pbs_jnp.gates_test_poly(p))
    if kernel == "blind_rotate_pallas":
        bsk, bsk_sh = jdsk.bsk_ntt, jdsk.bsk_ntt_sh
        fn = pallas_pbs.blind_rotate_pallas
    else:
        bsk, bsk_sh = mxu_pbs.mxu_server_key(jdsk)
        fn = mxu_pbs.blind_rotate_mxu
    ref = np.asarray(fn(p, bsk, bsk_sh, jnp.asarray(x), tv, g_tile=4, interpret=True))
    got = to_host(sb_pbs.blind_rotate_sb(tdsk, words(x), words(pbs.gates_test_poly(p))))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["k3"])
def test_keyswitch_matches_jnp(keys, name):
    ck, jdsk, tdsk = keys[name]
    p = ck.params
    rng = np.random.default_rng(5)
    for G in (3, 20):  # below and above the 16-row GEMM padding edge
        big = rng.integers(0, 1 << 32, size=(G, p.big_n + 1), dtype=np.uint64).astype(np.uint32)
        ref = np.asarray(pbs_jnp.keyswitch(jdsk, jnp.asarray(big)))
        np.testing.assert_array_equal(to_host(pbs.keyswitch(tdsk, words(big))), ref)


@pytest.mark.parametrize("name", ["mb2", "g1"])
def test_bootstrap_matches_jnp(keys, name):
    ck, jdsk, tdsk = keys[name]
    x, rng = _ctxts(ck, 4, 11)
    tv = pbs_jnp.gates_test_poly(ck.params)
    ref = np.asarray(pbs_jnp.bootstrap(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    np.testing.assert_array_equal(to_host(mb_pbs.bootstrap(tdsk, words(x), words(tv))), ref)


@pytest.mark.parametrize("gate,fn", [
    ("AND", lambda a, b: a & b),
    ("OR", lambda a, b: a | b),
    ("XOR", lambda a, b: a ^ b),
])
def test_gate_truth_tables(keys, gate, fn):
    from helm_tpu.circuit.gates import GateType
    from helm_tpu.circuit.plan import _BOOL_RECIPE

    ck, _, tdsk = keys["k3"]
    p = ck.params
    a = np.array([0, 0, 1, 1], bool)
    b = np.array([0, 1, 0, 1], bool)
    c1, c2, off = _BOOL_RECIPE[GateType[gate]]
    ca, cb = lwe.encrypt(ck, lwe.encode_bool(a)), lwe.encrypt(ck, lwe.encode_bool(b))
    lin = (ca.astype(np.uint64) * (c1 % (1 << 32)) + cb.astype(np.uint64) * (c2 % (1 << 32)))
    lin = (lin % (1 << 32)).astype(np.uint32)
    lin[:, p.n] += np.uint32(off)
    out = mb_pbs.bootstrap(tdsk, words(lin), words(pbs.gates_test_poly(p)))
    got = lwe.decode_bool(lwe.decrypt_phase(ck, to_host(out)))
    np.testing.assert_array_equal(got, fn(a, b))


def test_mod_switch_and_initial_acc_match_jnp(keys):
    ck, _, _ = keys["k3"]
    p = ck.params
    x, _ = _ctxts(ck, 6, 3)
    bbar = np.asarray(ref_ops.mod_switch(jnp, jnp.asarray(x[:, p.n]), p.N))
    neg_b = (np.uint32(2 * p.N) - bbar) & np.uint32(2 * p.N - 1)
    tv = np.broadcast_to(pbs_jnp.gates_test_poly(p), (6, p.N))
    body = np.asarray(ref_ops.negacyclic_rotate(jnp, jnp.asarray(tv), jnp.asarray(neg_b), p.N))
    acc = to_host(pbs.initial_acc(p, words(x), words(pbs_jnp.gates_test_poly(p))))
    np.testing.assert_array_equal(acc[:, p.k], body)
    assert not acc[:, : p.k].any()


def test_test_polys_are_the_reference_ones():
    for p in (P.TEST_PARAMS_K3, P.TEST_PARAMS_LUT):
        np.testing.assert_array_equal(pbs.gates_test_poly(p), pbs_jnp.gates_test_poly(p))
    tab = np.array([0, 1, 1, 0], np.uint64)
    np.testing.assert_array_equal(
        pbs.lut_test_poly(P.TEST_PARAMS_LUT, tab), pbs_jnp.lut_test_poly(P.TEST_PARAMS_LUT, tab)
    )


def test_cuda_g1_raises_naming_k2(keys):
    """Off the CPU the single-bit wrapper launches its kernel or raises: it
    never falls back to the plain path (a meta tensor stands in for a
    device with no kernel). K1 takes grouping-1 keys too (P_1 = X^a - 1),
    and off the CPU it also launches or raises."""
    _, _, tdsk = keys["g1"]
    x = torch.zeros((2, tdsk.params.n + 1), dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="blind_rotate_sb"):
        sb_pbs.blind_rotate_sb(tdsk, x, x)
    with pytest.raises(NotImplementedError, match="blind_rotate_mb"):
        mb_pbs.blind_rotate_mb(tdsk, x, x)
    with pytest.raises(ValueError, match="grouping 2"):
        sb_pbs.blind_rotate_sb(keys["mb2"][2], x, x)
