"""The ports of the reference's measurement tools on the CPU, against the
JAX package: the arith half of refbound.py, security.report, the AES
oracle and aes_bench, family_bench and chi2_bench's RESULT lines, and the
noise tools' errors word for word.

The noise tools run the port's gate bootstrap (`mb_pbs.bootstrap`, its
plain versions on the CPU) on the reference's keys carried across
(`client_key_from_reference`, `server_key_from_reference`); the same
loop through `helm_tpu.fhe.pbs_jnp` with the same numpy streams must
give the same phase errors, so the tools' RESULT lines must equal the
statistics of the reference's errors. Each tool runs at a tiny set; on
the card they run at the production sets in chip_smoke.py phase `tools`.
"""

import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu import params as RP
from helm_tpu import refbound as ref_refbound
from helm_tpu.circuit.graph import Circuit as RefCircuit
from helm_tpu.circuit.verilog import read_verilog_file as ref_read_verilog_file
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe import ops as ref_ops
from helm_tpu.fhe import pbs_jnp
from helm_tpu.fhe import security as ref_security
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import params as P
from helm_tpu_torch import refbound
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import read_verilog_file
from helm_tpu_torch.fhe import pbs, security
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.tools import aes_bench, chi2_bench, family_bench, noise_decompose, noise_validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "benchmarks", "netlists")
sys.path.insert(0, os.path.join(REPO, "benchmarks"))
import gen_circuits  # noqa: E402
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

CPU = torch.device("cpu")


# -- refbound (arith half) and security.report ---------------------------------


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("netlist", ["chi_squared_arith.v", "box_blur_arith.v"])
def test_arith_reference_bounds_equal_reference(netlist, width):
    path = os.path.join(NETS, netlist)
    mine = Circuit.from_netlist(read_verilog_file(path, True))
    ref = RefCircuit.from_netlist(ref_read_verilog_file(path, True))
    assert refbound.arith_level_profile(mine, width) == ref_refbound.arith_level_profile(ref, width)
    for kw in ({}, {"cores": 16, "t_bootstrap_s": 0.02}):
        assert refbound.arith_reference_bounds(mine, width, **kw) == ref_refbound.arith_reference_bounds(
            ref, width, **kw)


def test_radix_op_costs_equal_reference():
    from helm_tpu.circuit.gates import GateType as RefGateType
    from helm_tpu_torch.circuit.gates import GateType

    for t in GateType:
        for width in (2, 8, 32, 128):
            for plain in (False, True):
                assert refbound.radix_op_costs(t, width, plain) == ref_refbound.radix_op_costs(
                    RefGateType(t.value), width, plain)


def test_security_report_equals_reference_byte_for_byte():
    prod = [p for p in P.ALL_PARAMS.values() if not p.name.startswith("test_")]
    ref_prod = [p for p in RP.ALL_PARAMS.values() if not p.name.startswith("test_")]
    assert [p.name for p in prod] == [p.name for p in ref_prod]
    assert security.report(prod) == ref_security.report(ref_prod)


# -- AES -------------------------------------------------------------------------


def test_aes_copy_equals_gen_circuits_and_fips197():
    assert aes_bench.aes_sbox() == gen_circuits.aes_sbox()
    assert aes_bench.aes_encrypt(aes_bench.PT, aes_bench.KEY).hex() == aes_bench.C1
    rng = np.random.default_rng(0)
    for rounds in (1, 2, 5, 10):
        for _ in range(3):
            pt, key = bytes(rng.integers(0, 256, 16).tolist()), bytes(rng.integers(0, 256, 16).tolist())
            assert aes_bench.aes_encrypt(pt, key, rounds) == gen_circuits.aes_encrypt(pt, key, rounds)


def test_aes_bench_one_round_on_the_cpu(tmp_path):
    path = tmp_path / "aes1.v"
    path.write_text(gen_circuits.aes128_gates_circuit(rounds=1))
    res = aes_bench.run({"NETLIST": str(path), "ROUNDS": "1", "PSET": "TEST_PARAMS"}, CPU)
    assert res["correct"] and res["batch"] == 0 and res["backend"] == "plain (cpu)"
    assert res["ciphertexts"] == [aes_bench.aes_encrypt(aes_bench.PT, aes_bench.KEY, 1).hex()]


@pytest.mark.parametrize("knob", ["BACKEND", "GT"])
def test_tools_refuse_tpu_knobs(knob):
    with pytest.raises(SystemExit, match=f"{knob}="):
        family_bench.run({knob: "mxu"}, CPU)
    with pytest.raises(SystemExit, match=f"{knob}="):
        aes_bench.run({knob: "8"}, CPU)
    if knob == "BACKEND":
        with pytest.raises(SystemExit, match="BACKEND="):
            chi2_bench.run({"BACKEND": "jnp"}, CPU)


# -- family_bench and chi2_bench ---------------------------------------------------

#: the reference's RESULT fields; the port prints pred_slots_per_vector on
#: the CPU (pred_gate_times_per_vector and pred_s_per_vector on the card) in
#: place of pred_lanes_per_vector
FAMILY_FIELDS = {
    "family", "mode", "params", "backend", "batch", "cycles", "cycfuse", "steady_s", "per_vector_s",
    "per_cycle_s", "first_s", "correct", "ref_infinite_core_floor_s", "ref_core_bound_s", "ref_cores",
    "ref_bootstraps", "vs_ref_floor", "vs_ref_cores", "pred_lanes_per_vector", "pred_fill",
}


def _result_lines(out):
    return [json.loads(line[len("RESULT "):]) for line in out.splitlines() if line.startswith("RESULT ")]


def test_family_bench_gates_and_lut(capsys):
    env = {"PSET": "TEST_PARAMS", "CYCFUSE": "1",
           "NETLISTS": f"{NETS}/2-bit-adder.v {NETS}/s27.v:0:3 {NETS}/2-bit-adder.v:3"}
    got = family_bench.run(env, CPU)
    got += family_bench.run({"MODE": "lut", "PSET": "TEST_PARAMS_LUT", "NETLIST": f"{NETS}/8-bit-adder-lut-3-1.v"},
                            CPU)
    assert _result_lines(capsys.readouterr().out) == got
    for r, (net, B, cycles) in zip(got, [("2-bit-adder", 0, 1), ("s27", 0, 3), ("2-bit-adder", 3, 1),
                                         ("8-bit-adder-lut-3-1", 0, 1)]):
        assert r["correct"] is True and r["family"] == net and r["batch"] == B and r["cycles"] == cycles
        assert set(r) == FAMILY_FIELDS - {"pred_lanes_per_vector"} | {"pred_slots_per_vector"}
        assert r["backend"] == "plain (cpu)" and r["cycfuse"] == (cycles > 1)
        ref = ref_refbound.bounds_for_netlist(f"{NETS}/{net}.v", cores=64, cycles=cycles)
        assert r["ref_infinite_core_floor_s"] == ref["infinite_core_floor_s"]
        assert r["ref_core_bound_s"] == ref["core_bound_s"]
        assert r["ref_bootstraps"] == ref["bootstraps"] and r["ref_cores"] == 64
    assert got[0]["mode"] == "gates" and got[-1]["mode"] == "lut" and got[-1]["params"] == "test_tiny_lut"


def test_chi2_bench_chi_squared_u8():
    got = chi2_bench.run({"PARAMS": "TEST_PARAMS_ARITH_MB", "WIDTH": "u8", "BATCH": "2",
                          "NETLIST": f"{NETS}/chi_squared_arith.v"}, CPU)
    (r,) = got
    assert r["correct"] is True and r["width"] == "u8" and r["batch"] == 2
    assert r["params"] == "test_tiny_arith_mb2" and r["backend"] == "plain (cpu)"
    c = RefCircuit.from_netlist(ref_read_verilog_file(f"{NETS}/chi_squared_arith.v", True))
    ref = ref_refbound.arith_reference_bounds(c, 8, cores=64)
    for k in ("infinite_core_floor_s", "core_bound_s", "cores", "bootstraps"):
        assert r[f"ref_{k}"] == ref[k]
    assert r["bounds_model"] == ref["model"]


# -- the noise tools ---------------------------------------------------------------


def _rng(ck, seed):
    """The client key with a numpy stream of `seed` (the same on both
    sides, so that both encrypt the same ciphertexts)."""
    return dataclasses.replace(ck, rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def noisy_keys():
    p = RP.TEST_NOISY_GATES_MB
    ck = ref_lwe.keygen(p, 11)
    sk = ref_gen_server_key(ck)
    psk = server_key_from_reference(sk)
    return ck, sk, client_key_from_reference(ck), psk, pbs.DeviceServerKey.from_host(psk, CPU)


def _ref_errors(ck, sk, samples, G, seed, stages):
    """The reference's loop (tools/noise_validate.py, noise_decompose.py)
    through pbs_jnp: per batch the output errors, or (big-LWE errors,
    output errors)."""
    p = ck.params
    dsk = pbs_jnp.DeviceServerKey.from_host(sk)
    tv = jnp.asarray(pbs_jnp.gates_test_poly(p))

    @jax.jit
    def run(lin):
        acc = pbs_jnp.blind_rotate_multibit(dsk, lin, tv)
        big = ref_ops.sample_extract(jnp, acc, p.k, p.N)
        return big, pbs_jnp.keyswitch(dsk, big)

    rng = np.random.default_rng(seed)
    out = []
    for _ in range((samples + G - 1) // G):
        b1 = rng.integers(0, 2, G).astype(bool)
        b2 = rng.integers(0, 2, G).astype(bool)
        lin = (ref_lwe.encrypt(ck, ref_lwe.encode_bool(b1)) + ref_lwe.encrypt(ck, ref_lwe.encode_bool(b2))).astype(
            np.uint32)
        lin[:, p.n] += np.uint32((-(1 << 29)) % (1 << 32))
        exp = np.where(b1 & b2, 1 << 29, (-(1 << 29)) % (1 << 32)).astype(np.int64)
        big, small = (np.asarray(a) for a in run(jnp.asarray(lin)))

        def err(ph):
            return ((ph.astype(np.int64) - exp + (1 << 31)) % (1 << 32)) - (1 << 31)

        e_out = err(ref_lwe.decrypt_phase(ck, small))
        out.append((err(ref_lwe.decrypt_phase(ck, big, big=True)), e_out) if stages else e_out)
    return out


def test_noise_validate_errors_equal_reference(noisy_keys):
    ck, sk, pck, psk, dsk = noisy_keys
    samples, G, seed = 96, 32, 5
    ref = _ref_errors(_rng(ck, 99), sk, samples, G, seed, stages=False)
    # batch by batch, the port's loop gives the same errors word for word
    rng = np.random.default_rng(seed)
    key = _rng(pck, 99)
    for want in ref:
        np.testing.assert_array_equal(noise_validate.errors(key, dsk, rng, G), want)
    # and the tool's RESULT holds their statistics
    res = noise_validate.run({"PSET": "TEST_NOISY_GATES_MB", "SAMPLES": str(samples), "G": str(G),
                              "SEED": str(seed)}, CPU, keys={pck.params.name: (_rng(pck, 99), psk)})
    err = np.concatenate(ref)
    p = pck.params
    model = math.sqrt(p.var_pbs_out() + p.var_ks())
    assert res["samples"] == samples and res["decision_failures"] == 0
    assert res["measured_std"] == round(math.sqrt(float((err.astype(np.float64) ** 2).sum()) / samples), 1)
    assert res["model_std"] == round(model, 1)
    assert res["worst_abs_err_sigma"] == round(int(np.abs(err).max()) / model, 2)
    hist = np.bincount(np.minimum((np.abs(err) / model).astype(np.int64), 11), minlength=12)
    assert res["hist_abs_err_sigma"] == hist.tolist()
    assert res["model_failure_log2"] == round(p.pbs_failure_log2(), 1)


def test_noise_decompose_errors_equal_reference(noisy_keys):
    ck, sk, pck, psk, dsk = noisy_keys
    samples, G, seed = 64, 32, 6
    ref = _ref_errors(_rng(ck, 98), sk, samples, G, seed, stages=True)
    rng = np.random.default_rng(seed)
    key = _rng(pck, 98)
    for want_pbs, want_out in ref:
        got_pbs, got_out = noise_decompose.stage_errors(key, dsk, rng, G)
        np.testing.assert_array_equal(got_pbs, want_pbs)
        np.testing.assert_array_equal(got_out, want_out)
    res = noise_decompose.run({"PSET": "TEST_NOISY_GATES_MB", "SAMPLES": str(samples), "G": str(G),
                               "SEED": str(seed)}, CPU, keys={pck.params.name: (_rng(pck, 98), psk)})
    e_pbs = np.concatenate([a for a, _ in ref]).astype(np.float64)
    e_out = np.concatenate([b for _, b in ref]).astype(np.float64)
    assert res["pbs_std_measured"] == round(math.sqrt((e_pbs ** 2).sum() / samples), 1)
    assert res["out_std_measured"] == round(math.sqrt((e_out ** 2).sum() / samples), 1)
    assert res["ks_std_measured"] == round(math.sqrt(((e_out - e_pbs) ** 2).sum() / samples), 1)


def test_noise_tools_use_the_bench_key_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_KEY_CACHE", str(tmp_path))
    env = {"PSET": "TEST_NOISY_GATES_MB", "SAMPLES": "16", "G": "16", "SEED": "3"}
    first = noise_validate.run(env, CPU)
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "bench_ck_test_noisy_gates_mb_s3.npz", "bench_sk_test_noisy_gates_mb_s3.npz"]
    second = noise_validate.run(env, CPU)  # keys loaded: the same key, another ChaCha stream
    assert first["samples"] == second["samples"] == 16 and second["decision_failures"] == 0
