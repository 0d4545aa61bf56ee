"""The least-time functions against hand counts; they take a set's
parameters and counts of work only."""

import inspect

import pytest

from helmbench import harness, yardstick


def params(config):
    return harness.load_config(config)["params"]


def test_rotation_at_gates_128_k3_by_hand():
    # per group and gate: (8 + 4) transforms x 256 x 9 butterflies x 10,
    # (8 x 3 x 4 + 3 x 4) x 512 multiply-adds x 2; 352 groups
    per_gate = 352 * (12 * 256 * 9 * 10 + (8 * 3 * 4 + 3 * 4) * 512 * 2)
    assert yardstick.rotation_ops(704, 3, 512, 8, 2) == per_gate == 136249344
    assert yardstick.rotation_least_s(params("c880_gates128"), 1024) * 1e3 == pytest.approx(8.34, abs=0.005)


def test_rotation_at_arith_128_mb2_by_hand():
    per_gate = 416 * (8 * 1024 * 11 * 10 + (6 * 3 * 2 + 3 * 2) * 2048 * 2)
    assert yardstick.rotation_ops(832, 1, 2048, 6, 2) == per_gate
    assert yardstick.rotation_least_s(params("chi2_u32_arith128"), 1) * 1e6 == pytest.approx(26.7, abs=0.05)


def test_keyswitch_at_gates_128_k3_by_hand():
    p = params("c880_gates128")
    assert yardstick.keyswitch_key_bytes(p) == 1536 * 14 * 705 * 4 == 60641280
    # narrow calls: the key read bounds them
    assert yardstick.keyswitch_least_s(p, 24, 383) == pytest.approx(24 * 60641280 / 3.35e12)
    # very wide: the multiply-adds do
    macs = 1536 * 14 * 705
    assert yardstick.keyswitch_least_s(p, 1, 10**6) == pytest.approx(10**6 * 2 * macs / 1979e12)


def test_no_prime_count_or_route():
    for fn in (yardstick.rotation_ops, yardstick.rotation_least_s, yardstick.keyswitch_least_s,
               yardstick.keyswitch_key_bytes):
        names = set(inspect.signature(fn).parameters)
        assert not names & {"primes", "NP", "np_", "kernel", "route"}, (fn.__name__, names)
    src = inspect.getsource(yardstick)
    assert "helm_tpu_torch" not in src and "import torch" not in src


def test_stated_peaks():
    assert yardstick.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    assert yardstick.HBM_BYTES_PER_S == 3.35e12 and yardstick.INT8_OPS_PER_S == 1979e12
