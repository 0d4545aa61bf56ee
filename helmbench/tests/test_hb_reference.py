"""The plain reference against the program's plain path and its oracle."""

import numpy as np
import pytest

from helmbench import harness, reference
from helmbench.tests.hbutil import run_cpu


@pytest.mark.parametrize("config", ["c880_gates128", "chi2_u32_arith128"])
def test_netlist_reader_counts(config):
    cfg = harness.load_config(config)
    nl = reference.read_netlist(cfg["netlist_path"], cfg["mode"] == "arith")
    c = cfg["circuit"]
    assert (len(nl.inputs), len(nl.outputs), len(nl.gates)) == (c["inputs"], c["outputs"], c["gates"])


def test_gates_reference_equals_the_program_oracle():
    from helm_tpu_torch.circuit.graph import Circuit
    from helm_tpu_torch.circuit.verilog import read_verilog_file

    cfg = harness.load_config("c880_gates128")
    nl = reference.read_netlist(cfg["netlist_path"], False)
    bits = np.random.default_rng(5).integers(0, 2, size=(16, len(nl.inputs))).astype(bool)
    ours = reference.evaluate_gates(nl, bits)
    pnl = read_verilog_file(cfg["netlist_path"])
    c = Circuit.from_netlist(pnl)
    for v in range(bits.shape[0]):
        inputs = dict(zip(nl.inputs, bits[v]))
        exp = c.evaluate(c.initialize_wire_map(pnl.wire_set, inputs))
        assert [bool(exp[w]) for w in nl.outputs] == list(ours[v])


def test_arith_reference_wraps_mod_2_32():
    cfg = harness.load_config("chi2_u32_arith128")
    nl = reference.read_netlist(cfg["netlist_path"], True)
    vals = np.random.default_rng(6).integers(0, 1 << 32, size=(32, 3), dtype=np.uint64)
    got = reference.evaluate_arith(nl, vals)
    n0, n1, n2 = (int(x) for x in vals[0])
    m = (1 << 32) - 1
    t5, t8 = (2 * n0 + n1) & m, (2 * n2 + n1) & m
    want = [((4 * n0 * n2 - n1 * n1) ** 2) & m, (2 * t5 * t5) & m, (t5 * t8) & m, (2 * t8 * t8) & m]
    assert [int(x) for x in got[0]] == want


def test_phase_and_judges_on_hand_made_ciphertexts():
    rng = np.random.default_rng(7)
    n = 8
    key = rng.integers(0, 2, n).astype(np.uint32)
    a = rng.integers(0, 1 << 32, size=(2, 3, n), dtype=np.uint64)
    bits = np.array([[True, False, True], [False, False, True]])
    enc = np.where(bits, 1 << 29, (1 << 32) - (1 << 29)).astype(np.uint64)
    err = np.array([[5, -7, 0], [1 << 20, 0, -(1 << 27)]], dtype=np.int64)
    b = ((a * key).sum(-1) + enc + err) % (1 << 32)
    cts = np.concatenate([a, b[..., None]], axis=-1).astype(np.uint32)
    j = reference.judge_gates(bits, cts, key)
    assert (j.wrong_outputs, j.failed) == (0, 0)
    assert j.noise_max == pytest.approx((1 << 27) / (1 << 29))
    j = reference.judge_gates(~bits, cts, key)
    assert (j.wrong_outputs, j.failed) == (6, 2)


@pytest.mark.parametrize("config", ["c880_test", "chi2_test"])
def test_the_program_plain_path_is_judged_correct(config):
    out = run_cpu(config, "one_vector")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["wrong_outputs"]["value"] == 0
