"""helm_tpu_torch's client-side native code (helm_tpu_torch/native/*.cpp).

The port's C++ netlist parser (`circuit/native.py`) against the port's
Python parser on the reference test's eight netlists; the port's C++
loader (`io/native_loader.py`) against the port's Python CSV reader, and
its threaded encryptor against helm_tpu's C++ encryptor word for word for
the same seed and messages (the reference's `native/loader.cpp` built with
g++ into a temporary directory and run through helm_tpu's binding in a
subprocess: nothing is written under `native/`), at every thread count;
`lwe.encrypt_many` below and above its threshold. Both port libraries
build from the repository's sources into `build/native/` on first use.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from helm_tpu_torch import params as P
from helm_tpu_torch.circuit import native
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import read_verilog_file
from helm_tpu_torch.fhe import lwe
from helm_tpu_torch.io import csv_io, native_loader
from helm_tpu_torch.ops import build
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]

NETLISTS = [
    ("benchmarks/netlists/2-bit-adder.v", False),
    ("benchmarks/netlists/s27.v", False),
    ("benchmarks/netlists/8-bit-adder-lut-3-1.v", False),
    ("benchmarks/netlists/c880-like.v", False),
    ("benchmarks/netlists/chi_squared_arith.v", True),
    ("benchmarks/netlists/128-bit-mult.v", False),
    ("benchmarks/netlists/s15850-like.v", False),
    ("benchmarks/netlists/mmult15_arith.v", True),
]


def test_libraries_build_into_build_native():
    for name in ("loader", "graph"):
        lib = build.load_native(name)
        path = Path(lib._name)
        assert path.parent == ROOT / "build" / "native" and path.name.startswith(f"lib{name}-"), path


@pytest.mark.parametrize("path,is_arith", NETLISTS)
def test_native_parser_matches_python(path, is_arith):
    nl_py = read_verilog_file(str(ROOT / path), is_arith)
    c_py = Circuit.from_netlist(read_verilog_file(str(ROOT / path), is_arith))
    nl_n, c_n = native.parse_and_levelize(str(ROOT / path), is_arith)
    assert sorted(nl_n.inputs) == sorted(nl_py.inputs)
    assert sorted(nl_n.outputs) == sorted(nl_py.outputs)
    assert sorted(nl_n.dff_outputs) == sorted(nl_py.dff_outputs)
    assert nl_n.wire_set == nl_py.wire_set
    assert (nl_n.has_luts, nl_n.has_arith) == (nl_py.has_luts, nl_py.has_arith)

    def level_sets(c):
        return [sorted((g.name, g.type.value, g.output, tuple(g.inputs)) for g in gs) for _, gs in c.levels]

    assert level_sets(c_n) == level_sets(c_py)


def test_native_parser_lut_consts_and_errors(tmp_path):
    _, c = native.parse_and_levelize(str(ROOT / "benchmarks/netlists/8-bit-adder-lut-3-1.v"))
    luts = [g for _, gs in c.levels for g in gs if g.lut_const is not None]
    py = {g.name: g.lut_const for g in read_verilog_file(
        str(ROOT / "benchmarks/netlists/8-bit-adder-lut-3-1.v")).gates if g.lut_const}
    assert luts and all(g.lut_const == py[g.name] and len(g.lut_const) == 8 for g in luts)
    bad = tmp_path / "bad.v"
    bad.write_text("module m(a);\n input a;\nendmodule\n")
    with pytest.raises(ValueError, match="no gates"):
        native.parse_and_levelize(str(bad))
    mixed = tmp_path / "mixed.v"
    mixed.write_text("module m(a,b,c);\n input a, b;\n output c;\n lut g0(6, a, b, t);\n add g1(t, b, c);\nendmodule\n")
    with pytest.raises(ValueError, match="mix LUTs"):
        native.parse_and_levelize(str(mixed))


@pytest.mark.parametrize("path,kind", [
    ("benchmarks/test-cases/2-bit-adder.inputs.csv", "bool"),
    ("benchmarks/test-cases/s27.inputs.csv", "bool"),
    ("benchmarks/test-cases/8-bit-adder.inputs.csv", "bool"),
    ("benchmarks/test-cases/chi_squared_arith_1.inputs.csv", "u32"),
    ("benchmarks/test-cases/chi_squared_arith_2.inputs.csv", "u16"),
])
def test_native_csv_matches_python(path, kind):
    assert native_loader.read_input_wires(str(ROOT / path), kind) == csv_io.read_input_wires(str(ROOT / path), kind)


def test_native_csv_hex_width_and_malformed(tmp_path):
    f = tmp_path / "in.csv"
    f.write_text("wire, value\nin3, 5A, 8\nflag, true\nz, 0\n")
    assert native_loader.read_input_wires(str(f), "bool") == csv_io.read_input_wires(str(f), "bool")
    bad = tmp_path / "bad.csv"
    bad.write_text("wire,value\na,1,2,3\n")
    with pytest.raises(ValueError, match="malformed input CSV"):
        native_loader.read_input_wires(str(bad), "bool")
    with pytest.raises(ValueError, match="malformed input CSV"):
        native_loader.read_input_wires(str(tmp_path / "missing.csv"), "bool")


_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    from helm_tpu.io import native_loader
    assert native_loader.native_available(), "the reference's loader did not load"
    d = sys.argv[1]
    key, mu = np.load(d + "/key.npy"), np.load(d + "/mu.npy")
    for nt in (1, 3):
        np.save(f"{d}/ref{nt}.npy", native_loader.encrypt_batch(key, mu, 3.5, seed=21, nthreads=nt))
    np.save(d + "/ref_bytes.npy", native_loader.encrypt_batch(key, mu[:40], 0.0, seed=bytes(range(32))))
    try:
        native_loader.read_input_wires(d + "/bad.csv", "bool")
        print(json.dumps(None))
    except ValueError as e:
        print(json.dumps(str(e)))
""")


def test_encrypt_batch_equals_the_reference_cpp(tmp_path):
    """helm_tpu's C++ encryptor (its own source, built here into tmp_path,
    loaded through HELM_TPU_NATIVE_LOADER in a subprocess) and the port's
    give the same words for the same seed and messages, at every thread
    count; a malformed CSV raises the same error from both."""
    so = tmp_path / "libhelm_loader.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(so),
                    str(ROOT / "native" / "loader.cpp"), "-lpthread"], check=True, timeout=300)
    ck = lwe.keygen(P.GATES_TPU, 12)
    mu = np.random.default_rng(5).integers(0, 1 << 32, 2500, dtype=np.uint64).astype(np.uint32)
    np.save(tmp_path / "key.npy", ck.lwe_key)
    np.save(tmp_path / "mu.npy", mu)
    bad = tmp_path / "bad.csv"
    bad.write_text("wire,value\na,1,2,3\n")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "HELM_TPU_NATIVE_LOADER": str(so)})
    assert res.returncode == 0, res.stderr[-3000:]
    ref_err = json.loads(res.stdout.strip().splitlines()[-1])
    for nt in (1, 2, 8, 0):
        got = native_loader.encrypt_batch(ck.lwe_key, mu, 3.5, seed=21, nthreads=nt)
        np.testing.assert_array_equal(got, np.load(tmp_path / "ref1.npy"), err_msg=f"nthreads={nt}")
    np.testing.assert_array_equal(np.load(tmp_path / "ref3.npy"), np.load(tmp_path / "ref1.npy"))
    np.testing.assert_array_equal(native_loader.encrypt_batch(ck.lwe_key, mu[:40], 0.0, seed=bytes(range(32))),
                                  np.load(tmp_path / "ref_bytes.npy"))
    with pytest.raises(ValueError) as err:
        native_loader.read_input_wires(str(bad), "bool")
    assert str(err.value) == ref_err


def test_encrypt_batch_decrypts_at_its_noise():
    p = P.GATES_TPU
    ck = lwe.keygen(p, 11)
    bits = np.random.default_rng(1).integers(0, 2, 2048).astype(bool)
    mu = lwe.encode_bool(bits)
    ct = native_loader.encrypt_batch(ck.lwe_key, mu, p.lwe_noise_std, seed=3)
    assert ct.shape == (2048, p.n + 1) and ct.dtype == np.uint32
    assert (lwe.decode_bool(lwe.decrypt_phase(ck, ct)) == bits).all()
    ph = lwe.decrypt_phase(ck, ct).astype(np.int64)
    err = ((ph - mu.astype(np.int64) + 2**31) % 2**32) - 2**31
    assert 0.7 * p.lwe_noise_std < err.std() < 1.3 * p.lwe_noise_std
    two = native_loader.encrypt_batch(ck.lwe_key, mu.reshape(2, 1024), p.lwe_noise_std, seed=3)
    np.testing.assert_array_equal(two.reshape(2048, -1), ct)  # the shape of mu is kept


def test_encrypt_many_threshold():
    """Below the threshold encrypt_many is encrypt() and its rng stream;
    at or above it, the C++ encryptor keyed by 32 bytes of that stream."""
    p = P.TEST_PARAMS
    a, b = lwe.keygen(p, 9), lwe.keygen(p, 9)
    mu = lwe.encode_bool(np.arange(100) % 3 == 0)
    np.testing.assert_array_equal(lwe.encrypt_many(a, mu), lwe.encrypt(b, mu))
    np.testing.assert_array_equal(lwe.encrypt_many(a, mu), lwe.encrypt(b, mu))  # the streams stay in step
    big = lwe.encode_bool(np.arange(1 << 13) % 5 == 0)
    got = lwe.encrypt_many(a, big)
    exp = native_loader.encrypt_batch(b.lwe_key, big, p.lwe_noise_std, seed=b.rng.bytes(32))
    np.testing.assert_array_equal(got, exp)
    assert (lwe.decode_bool(lwe.decrypt_phase(a, got)) == (np.arange(1 << 13) % 5 == 0)).all()
    np.testing.assert_array_equal(lwe.encrypt_many(a, big[:10], native_threshold=8),
                                  native_loader.encrypt_batch(b.lwe_key, big[:10], p.lwe_noise_std,
                                                              seed=b.rng.bytes(32)))
