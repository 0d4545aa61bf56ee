"""The port's keygen (torch NTT on an explicit device) against helm_tpu's.

For the same seed the server keys must come out bit-identical: the port
draws from ClientKey.rng in the reference's order and its NTT is exact.
The tests pass device="cpu": the keygen entry points default to the card.
"""

import numpy as np
import pytest

from helm_tpu import params as RP
from helm_tpu.fhe import keys as ref_keys
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import keys, lwe, server_key
from _port_threads import compute_share  # noqa: F401,E402 (autouse)


def _ref_set(p):
    """helm_tpu's parameter set of the same name."""
    return next(v for v in vars(RP).values() if isinstance(v, RP.TfheParams) and v.name == p.name)


@pytest.mark.parametrize("params,seed", [
    (P.TEST_PARAMS_K3, 11),  # the main path's shape: k=3, grouping 2
    (P.TEST_PARAMS_MB4, 12),  # grouping 4
    (P.TEST_PARAMS, 13),  # grouping 1 (gen_bsk)
])
def test_server_key_bit_identical(params, seed):
    ref = ref_gen_server_key(ref_lwe.keygen(_ref_set(params), seed))
    ck = lwe.keygen(params, seed)
    got = server_key.gen_server_key(ck, device="cpu")
    for name in ("bsk_ntt", "bsk_ntt_sh", "ksk_limbs"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the client rng is left where the reference leaves it
    ref_ck = ref_lwe.keygen(_ref_set(params), seed)
    ref_gen_server_key(ref_ck)
    np.testing.assert_array_equal(
        ck.rng.integers(0, 1 << 32, size=8, dtype=np.uint64),
        ref_ck.rng.integers(0, 1 << 32, size=8, dtype=np.uint64),
    )


def test_keygen_chunks_match_one_batch(monkeypatch):
    """The chunked device NTT gives the same key as one big batch."""
    p = P.TEST_PARAMS_K3
    whole = server_key.gen_server_key(lwe.keygen(p, 21), device="cpu")
    monkeypatch.setattr(server_key, "CHUNK", 7)
    chunked = server_key.gen_server_key(lwe.keygen(p, 21), device="cpu")
    np.testing.assert_array_equal(whole.bsk_ntt, chunked.bsk_ntt)


def test_load_or_generate_roundtrip(tmp_path):
    p = P.TEST_PARAMS_K3
    ck, sk = keys.load_or_generate(str(tmp_path), p, seed=5, device="cpu")
    # the files are the reference's format, readable by helm_tpu
    sk2 = ref_keys.load_server_key(str(tmp_path / f"sk_{p.name}.npz"))
    np.testing.assert_array_equal(sk2.bsk_ntt, sk.bsk_ntt)
    ck3, sk3 = keys.load_or_generate(str(tmp_path), p, seed=999, device="cpu")
    np.testing.assert_array_equal(ck3.lwe_key, ck.lwe_key)
    np.testing.assert_array_equal(sk3.ksk_limbs, sk.ksk_limbs)
