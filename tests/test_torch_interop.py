"""helm_tpu_torch.io.tfhers_interop against helm_tpu.io.tfhers_interop: an
interchange file written by either package loads in the other with equal
u32 words, key and header (tolerance 0), survives the
tools/tfhers_interop/npz2raw.py round trip exactly, and a version, q or
dimension mismatch raises ValueError in both.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from helm_tpu import params as RP
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.io import tfhers_interop as ref
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import lwe
from helm_tpu_torch.io import tfhers_interop as port
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SETS = ["test_tiny", "gates_128_k3"]


def _cts(ck, m=5, seed=0):
    bits = np.random.default_rng(seed).integers(0, 2, m).astype(bool)
    return lwe.encrypt(ck, lwe.encode_bool(bits)), bits


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("key", [False, True], ids=["no_key", "key"])
def test_port_export_loads_in_the_reference(tmp_path, name, key):
    ck = lwe.keygen(P.ALL_PARAMS[name], 3)
    cts, bits = _cts(ck)
    path = tmp_path / "x.npz"
    port.export_client(str(path), ck, cts, include_key=key)
    got, k, hdr = ref.load_lwe(str(path), RP.ALL_PARAMS[name])
    np.testing.assert_array_equal(got, cts)
    assert got.dtype == np.uint32
    assert hdr == {"n": ck.params.n, "q_log2": 32, "msg_space_log": ck.params.msg_space_log}
    if key:
        np.testing.assert_array_equal(k, ck.lwe_key)
        ref_ck = ref_lwe.keygen(RP.ALL_PARAMS[name], 3)
        np.testing.assert_array_equal(k, ref_ck.lwe_key)  # the same key from the same seed
        assert (ref_lwe.decode_bool(ref_lwe.decrypt_phase(ref_ck, got)) == bits).all()
    else:
        assert k is None


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("key", [False, True], ids=["no_key", "key"])
def test_reference_export_loads_in_the_port(tmp_path, name, key):
    rck = ref_lwe.keygen(RP.ALL_PARAMS[name], 4)
    bits = np.random.default_rng(1).integers(0, 2, 7).astype(bool)
    cts = ref_lwe.encrypt(rck, ref_lwe.encode_bool(bits))
    path = tmp_path / "x.npz"
    ref.export_client(str(path), rck, cts, include_key=key)
    got, k, hdr = port.load_lwe(str(path), P.ALL_PARAMS[name])
    want = ref.load_lwe(str(path))
    np.testing.assert_array_equal(got, want[0])
    assert hdr == want[2]
    ck = lwe.client_key_from_reference(rck)
    if key:
        np.testing.assert_array_equal(k, rck.lwe_key)
    else:
        assert k is None
    assert (lwe.decode_bool(lwe.decrypt_phase(ck, got)) == bits).all()


@pytest.mark.parametrize("key", [False, True], ids=["no_key", "key"])
def test_npz2raw_round_trip_is_exact(tmp_path, key):
    ck = lwe.keygen(P.TEST_PARAMS, 5)
    cts, _ = _cts(ck, 9, 2)
    src, raw, back = tmp_path / "a.npz", tmp_path / "b.raw", tmp_path / "c.npz"
    port.export_client(str(src), ck, cts, include_key=key)
    for a, b in ((src, raw), (raw, back)):
        res = subprocess.run(
            [sys.executable, str(ROOT / "tools/tfhers_interop/npz2raw.py"), str(a), str(b)],
            capture_output=True, text=True, timeout=60,
        )
        assert res.returncode == 0, res.stderr
    for mod in (port, ref):
        got, k, hdr = mod.load_lwe(str(back))
        np.testing.assert_array_equal(got, cts)
        assert hdr == {"n": 16, "q_log2": 32, "msg_space_log": P.TEST_PARAMS.msg_space_log}
        if key:
            np.testing.assert_array_equal(k, ck.lwe_key)
        else:
            assert k is None


@pytest.mark.parametrize("bad,match", [
    ("version", "unsupported interchange version"),
    ("q", "not supported"),
    ("dimension", "dimension mismatch"),
    ("shape", "ciphertext shape"),
])
def test_mismatches_raise_in_both(tmp_path, bad, match):
    n = P.TEST_PARAMS.n
    header = np.array([port.VERSION, n, 32, 3], dtype=np.int64)
    cts = np.zeros((2, n + 1), dtype=np.uint32)
    if bad == "version":
        header[0] = 2
    elif bad == "q":
        header[2] = 64
    elif bad == "shape":
        cts = np.zeros((2, n), dtype=np.uint32)
    path = tmp_path / "x.npz"
    np.savez(path, header=header, cts=cts)
    other = "gates_128_k3" if bad == "dimension" else "test_tiny"
    with pytest.raises(ValueError, match=match):
        port.load_lwe(str(path), P.ALL_PARAMS[other])
    with pytest.raises(ValueError, match=match):
        ref.load_lwe(str(path), RP.ALL_PARAMS[other])
