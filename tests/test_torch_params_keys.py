"""The port's parameter sets and keys against helm_tpu's.

Every named set equals the reference's field by field; keygen from one
seed gives the reference's words; keys carry across with
`params.from_reference`, `lwe.client_key_from_reference` and
`server_key.server_key_from_reference`; and key files written by either
package load in the other (the npz format is the reference's).
"""

import dataclasses
import inspect

import numpy as np
import pytest

from helm_tpu import params as RP
from helm_tpu.fhe import keys as ref_keys
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import keys, lwe, server_key
from _port_threads import compute_share  # noqa: F401,E402 (autouse)


def test_same_set_names():
    assert sorted(P.ALL_PARAMS) == sorted(RP.ALL_PARAMS)
    for name in ("DEFAULT_GATES", "DEFAULT_LUT", "DEFAULT_ARITH"):
        assert getattr(P, name).name == getattr(RP, name).name


@pytest.mark.parametrize("name", sorted(RP.ALL_PARAMS))
def test_param_set_equals_reference_field_by_field(name):
    mine, ref = P.ALL_PARAMS[name], RP.ALL_PARAMS[name]
    for f in dataclasses.fields(ref):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("component_gadgets", "gadget_rows", "big_n", "delta", "msg_space"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.var_pbs_out() == ref.var_pbs_out()
    assert mine.conv_bound() == ref.conv_bound()
    assert P.from_reference(ref) is mine


def test_from_reference_checks_the_named_set():
    drifted = dataclasses.replace(RP.GATES_TPU, pbs_level=3)
    with pytest.raises(ValueError, match="differs"):
        P.from_reference(drifted)
    fresh = dataclasses.replace(RP.TEST_PARAMS_K3, name="test_tiny_k3_g1", grouping=1)
    got = P.from_reference(fresh)
    assert isinstance(got, P.TfheParams) and got.grouping == 1 and got.k == 3


@pytest.mark.parametrize("name", ["test_tiny", "test_tiny_lut", "test_noisy_lut_k2"])
def test_keygen_gives_the_reference_words(name):
    """Client and server key words from one seed (the port's keygen runs
    its NTT on the CPU here)."""
    ck = lwe.keygen(P.ALL_PARAMS[name], 31)
    ref_ck = ref_lwe.keygen(RP.ALL_PARAMS[name], 31)
    np.testing.assert_array_equal(ck.lwe_key, ref_ck.lwe_key)
    np.testing.assert_array_equal(ck.glwe_key, ref_ck.glwe_key)
    sk = server_key.gen_server_key(ck, device="cpu")
    ref_sk = ref_gen_server_key(ref_ck)
    for f in ("bsk_ntt", "bsk_ntt_sh", "ksk_limbs"):
        np.testing.assert_array_equal(getattr(sk, f), getattr(ref_sk, f), err_msg=f)
    # and encryption draws the same stream afterwards
    mu = lwe.encode_msg(ck.params, np.arange(8) % 2)
    np.testing.assert_array_equal(lwe.encrypt(ck, mu), ref_lwe.encrypt(ref_ck, mu))


def test_keys_from_reference_copy_the_words():
    ref_ck = ref_lwe.keygen(RP.TEST_PARAMS_LUT, 5)
    ref_sk = ref_gen_server_key(ref_ck)
    ck = lwe.client_key_from_reference(ref_ck)
    sk = server_key.server_key_from_reference(ref_sk)
    assert ck.params is P.TEST_PARAMS_LUT and sk.params is P.TEST_PARAMS_LUT
    np.testing.assert_array_equal(ck.lwe_key, ref_ck.lwe_key)
    np.testing.assert_array_equal(ck.glwe_key, ref_ck.glwe_key)
    for f in ("bsk_ntt", "bsk_ntt_sh", "ksk_limbs"):
        np.testing.assert_array_equal(getattr(sk, f), getattr(ref_sk, f), err_msg=f)
    # a ciphertext of either key decrypts under the other
    ct = ref_lwe.encrypt(ref_ck, ref_lwe.encode_msg(RP.TEST_PARAMS_LUT, [3, 5]))
    assert list(lwe.decode_msg(ck.params, lwe.decrypt_phase(ck, ct))) == [3, 5]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_key_files_load_in_the_other_package(tmp_path, writer):
    ck = lwe.keygen(P.TEST_PARAMS, 8)
    sk = server_key.gen_server_key(ck, device="cpu")
    ckp, skp = str(tmp_path / "ck.npz"), str(tmp_path / "sk.npz")
    if writer == "port":
        keys.save_client_key(ckp, ck)
        keys.save_server_key(skp, sk)
        ck2, sk2 = ref_keys.load_client_key(ckp), ref_keys.load_server_key(skp)
    else:
        ref_keys.save_client_key(ckp, ck)
        ref_keys.save_server_key(skp, sk)
        ck2, sk2 = keys.load_client_key(ckp), keys.load_server_key(skp)
    assert ck2.params.name == sk2.params.name == "test_tiny"
    np.testing.assert_array_equal(ck2.lwe_key, ck.lwe_key)
    for f in ("bsk_ntt", "bsk_ntt_sh", "ksk_limbs"):
        np.testing.assert_array_equal(getattr(sk2, f), getattr(sk, f), err_msg=f)


def test_keygen_entry_points_default_to_the_card():
    for fn in (server_key.gen_bsk, server_key.gen_bsk_multibit, server_key.gen_server_key,
               keys.load_or_generate):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_encrypt_many_is_encrypt_with_its_stream():
    """Below its threshold encrypt_many is encrypt() and its stream; at or
    above it (the reference's 8192), the C++ encryptor keyed by 32 bytes of
    that stream (io/native_loader.py, as the reference routes it)."""
    from helm_tpu_torch.io import native_loader

    a, b = lwe.keygen(P.TEST_PARAMS, 3), lwe.keygen(P.TEST_PARAMS, 3)
    mu = lwe.encode_bool(np.arange(20000) % 3 == 0)
    np.testing.assert_array_equal(lwe.encrypt_many(a, mu, native_threshold=20001), lwe.encrypt(b, mu))
    np.testing.assert_array_equal(
        lwe.encrypt_many(a, mu),
        native_loader.encrypt_batch(b.lwe_key, mu, P.TEST_PARAMS.lwe_noise_std, seed=b.rng.bytes(32)),
    )
