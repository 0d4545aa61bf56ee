"""helm_tpu_torch BooleanEngine in LUT mode (CPU tensors) against helm_tpu's.

Both engines get the same keys (the reference's, carried across with
`client_key_from_reference` / `server_key_from_reference`) and the same
encrypted input wires; every wire the port computes must equal the jnp
engine's word for word (zero tolerance: exact arithmetic), and the
decrypted outputs must equal the golden CSV and the plaintext oracle. Two
sets: TEST_PARAMS_LUT (grouping 1: the single-bit path) and
TEST_NOISY_LUT_K2 (grouping 2, k=2, real noise: the multi-bit path).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from helm_tpu import params as RP
from helm_tpu.circuit.verilog import parse_verilog as ref_parse_verilog
from helm_tpu.engines.boolean import BooleanEngine as RefEngine
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import BooleanEngine
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import parse_verilog
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.ntt import to_host
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.io import csv_io
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

SETS = {"g1": (RP.TEST_PARAMS_LUT, 61), "k2_mb2": (RP.TEST_NOISY_LUT_K2, 62)}


@pytest.fixture(scope="module", params=sorted(SETS))
def engines(request):
    p, seed = SETS[request.param]
    ck = ref_lwe.keygen(p, seed)
    sk = ref_gen_server_key(ck)
    ref = RefEngine(mode="lut", params=p, backend="jnp", keys=(ck, sk), fuse_levels=True)
    port = BooleanEngine(
        mode="lut", params=p, device="cpu",
        keys=(client_key_from_reference(ck), server_key_from_reference(sk)),
    )
    return ref, port


ADDER = "benchmarks/netlists/8-bit-adder-lut-3-1.v"


def _compile(engines, src):
    """Each engine compiles its own package's parse of the netlist text;
    returns the port's netlist."""
    ref, port = engines
    ref.compile(ref_parse_verilog(src))
    nl = parse_verilog(src)
    port.compile(nl)
    assert ref.plan.wire_index == port.plan.wire_index
    return nl


def _run_both(engines, wires):
    """Evaluate one encryption through both engines; words must agree on
    every wire but the trash slot (index num_wires-1, written by padding)."""
    ref, port = engines
    got = port.evaluate(wires)
    exp = np.asarray(ref.evaluate(jnp.asarray(to_host(wires))))
    keep = port.plan.num_wires - 1
    np.testing.assert_array_equal(to_host(got)[..., :keep, :], exp[..., :keep, :])
    return got


def _oracle(nl, inputs, cycles=1):
    c = Circuit.from_netlist(nl)
    st = c.initialize_wire_map(nl.wire_set, inputs)
    for _ in range(cycles):
        st = c.evaluate(st)
    return st


def test_lut_adder_golden_csv_and_every_wire(engines):
    _, port = engines
    with open(ADDER) as f:
        nl = _compile(engines, f.read())
    inputs = csv_io.read_input_wires("benchmarks/test-cases/8-bit-adder.inputs.csv", "bool")
    got = _run_both(engines, port.encrypt_inputs(inputs))
    golden = csv_io.read_input_wires("benchmarks/test-cases/8-bit-adder-lut-3-1.outputs.csv", "bool")
    assert port.decrypt_outputs(got) == {w: int(v) for w, v in golden.items()}
    wires = port.decrypt_all_wires(got)
    for w, v in _oracle(nl, inputs).items():
        assert wires[w] == int(bool(v)), w


def test_bivariate_and_unary_luts(engines):
    _, port = engines
    nl = _compile(engines, """
module m(a, b, y2, y1);
  input a, b;
  output y2, y1;
  lut g0(6, a, b, y2);
  lut g1(1, a, y1);
endmodule
""")
    for a, b in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        out = port.decrypt_outputs(_run_both(engines, port.encrypt_inputs({"a": bool(a), "b": bool(b)})))
        assert out == {"y2": a ^ b, "y1": 1 - a}, (a, b)


def test_five_input_lut_shannon_decomposition(engines):
    _, port = engines
    rnd = random.Random(7)
    table = [rnd.randint(0, 1) for _ in range(32)]
    const = sum(b << i for i, b in enumerate(table))
    nl = _compile(engines, f"""
module m(a, b, c, d, e, y);
  input a, b, c, d, e;
  output y;
  lut g0({const}, a, b, c, d, e, y);
endmodule
""")
    assert len(port.plan.levels) > 1  # split into a tree of 3-input LUTs
    for trial in range(3):
        bits = [rnd.randint(0, 1) for _ in range(5)]
        out = port.decrypt_outputs(
            _run_both(engines, port.encrypt_inputs(dict(zip("abcde", map(bool, bits)))))
        )
        assert out["y"] == table[sum(b << (4 - i) for i, b in enumerate(bits))], (trial, bits)


def test_ready_latch(engines):
    ref, port = engines
    nl = _compile(engines, """
module seq(a, out);
  input a;
  output out;
  dff d0(n1, s1);
  dff d1(s1, READY);
  lut g0(1, a, n1);
  lut g1(2, s1, out);
endmodule
""")
    assert port.has_ready()
    w = port.encrypt_inputs({"a": False})
    valid, rvalid = port.init_ready(), ref.init_ready()
    np.testing.assert_array_equal(to_host(valid), np.asarray(rvalid))
    for _ in range(3):
        w = _run_both(engines, w)
        rw = jnp.asarray(to_host(w))
        valid, rvalid = port.evaluate_ready(w, valid), ref.evaluate_ready(rw, rvalid)
        np.testing.assert_array_equal(to_host(valid), np.asarray(rvalid))
    # lut const 1 = NOT, const 2 = identity: out latches NOT(a) = 1
    assert port.decrypt_outputs(valid, from_valid=True) == {"out": 1}


def test_batched_shape_matches_per_vector(engines):
    _, port = engines
    with open(ADDER) as f:
        nl = _compile(engines, f.read())
    rng = np.random.default_rng(3)
    maps = [{w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(3)]
    w = port.encrypt_inputs(maps)
    assert tuple(w.shape) == (3, port.plan.num_wires, port.params.n + 1)
    got = _run_both(engines, w)
    for m, out in zip(maps, port.decrypt_outputs(got)):
        exp = _oracle(nl, m)
        assert out == {k: int(bool(exp[k])) for k in nl.outputs}
