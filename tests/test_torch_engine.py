"""helm_tpu_torch BooleanEngine (gates mode, CPU tensors) against helm_tpu's.

Both engines get the same keys (the reference's, carried across with
`client_key_from_reference` / `server_key_from_reference`) and the same
encrypted input wires; every wire the port computes must equal the jnp
engine's word for word (zero tolerance: exact arithmetic), and the
decrypted outputs must equal the golden CSVs and the plaintext oracle.
LUT mode is held the same way in tests/test_torch_lut.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from helm_tpu import params as P
from helm_tpu.circuit.graph import Circuit
from helm_tpu.circuit.verilog import parse_verilog, read_verilog_file
from helm_tpu.engines.boolean import BooleanEngine as RefEngine
from helm_tpu.fhe import lwe
from helm_tpu.fhe.server_key import gen_server_key
from helm_tpu.io import csv_io
from helm_tpu_torch import BooleanEngine
from helm_tpu_torch.circuit.gates import Gate, GateType
from helm_tpu_torch.circuit.verilog import Netlist
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.ntt import to_host
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

#: k=1 multi-bit: the reference's compile time grows with k (the k=3 path
#: is held word for word in test_torch_pbs.py and on the card)
PARAMS = P.TEST_PARAMS_MB


@pytest.fixture(scope="module")
def engines():
    ck = lwe.keygen(PARAMS, 4242)
    sk = gen_server_key(ck)
    ref = RefEngine(mode="gates", params=PARAMS, backend="jnp", keys=(ck, sk), fuse_levels=True)
    port = BooleanEngine(
        mode="gates", params=PARAMS, device="cpu",
        keys=(client_key_from_reference(ck), server_key_from_reference(sk)),
    )
    return ref, port


def _port_netlist(nl):
    """The reference's parsed netlist as the port's own types (the port's
    planner matches gates against its own GateType)."""
    gates = [
        Gate(g.name, GateType(g.type.value), list(g.inputs), g.output, g.lut_const)
        for g in nl.gates
    ]
    return Netlist(gates, set(nl.wire_set), list(nl.inputs), list(nl.outputs),
                   list(nl.dff_outputs), nl.has_luts, nl.has_arith)


def _compile(engines, nl):
    ref, port = engines
    ref.compile(nl)
    port.compile(_port_netlist(nl))
    assert ref.plan.wire_index == port.plan.wire_index


def _same_words(port_wires, ref_wires, num_wires):
    """All wires but the trash slot (index num_wires-1, written by padding)."""
    got = to_host(port_wires)[..., : num_wires - 1, :]
    np.testing.assert_array_equal(got, np.asarray(ref_wires)[..., : num_wires - 1, :])


def _golden(name):
    return csv_io.read_input_wires(f"benchmarks/test-cases/{name}", "bool")


def _oracle(nl, inputs):
    c = Circuit.from_netlist(nl)
    return c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))


def test_two_bit_adder_all_wires(engines):
    ref, port = engines
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    _compile(engines, nl)
    inputs = _golden("2-bit-adder.inputs.csv")
    w0 = port.encrypt_inputs(inputs)
    got = port.evaluate(w0)
    exp = ref.evaluate(jnp.asarray(to_host(w0)))
    _same_words(got, exp, port.plan.num_wires)
    wires = port.decrypt_all_wires(got)
    for w, v in _oracle(nl, inputs).items():
        assert wires[w] == v, w
    assert port.decrypt_outputs(got) == _golden("2-bit-adder.outputs.csv")


def test_s27_three_cycles(engines):
    ref, port = engines
    nl = read_verilog_file("benchmarks/netlists/s27.v")
    _compile(engines, nl)
    inputs = _golden("s27.inputs.csv")
    w0 = port.encrypt_inputs(inputs)
    w, rw = w0, jnp.asarray(to_host(w0))
    c = Circuit.from_netlist(read_verilog_file("benchmarks/netlists/s27.v"))
    state = c.initialize_wire_map(nl.wire_set, inputs)
    for cycle in range(3):
        w = port.evaluate(w)
        rw = ref.evaluate(rw)
        state = c.evaluate(state)
        _same_words(w, rw, port.plan.num_wires)
        got = port.decrypt_all_wires(w)
        for name, v in state.items():
            assert got[name] == v, (cycle, name)
    assert port.decrypt_outputs(w) == _golden("s27_3cycles.outputs.csv")
    # evaluate_cycles is the same loop; evaluate leaves its input untouched
    np.testing.assert_array_equal(to_host(port.evaluate_cycles(w0, 3)), to_host(w))


def test_ready_latch(engines):
    ref, port = engines
    nl = parse_verilog(
        """
module seq(a, out);
  input a;
  output out;
  dff d0(n1, s1);
  dff d1(s1, READY);
  not g0(a, n1);
  buf g1(s1, out);
endmodule
"""
    )
    _compile(engines, nl)
    assert port.has_ready()
    w = port.encrypt_inputs({"a": False})
    rw = jnp.asarray(to_host(w))
    valid, rvalid = port.init_ready(), ref.init_ready()
    for _ in range(3):
        w, rw = port.evaluate(w), ref.evaluate(rw)
        valid, rvalid = port.evaluate_ready(w, valid), ref.evaluate_ready(rw, rvalid)
        np.testing.assert_array_equal(to_host(valid), np.asarray(rvalid))
    assert port.decrypt_outputs(valid, from_valid=True) == {"out": True}


def test_batched_shape_matches_per_vector(engines):
    ref, port = engines
    nl = read_verilog_file("benchmarks/netlists/2-bit-adder.v")
    _compile(engines, nl)
    rng = np.random.default_rng(3)
    maps = [{w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(3)]
    w = port.encrypt_inputs(maps)
    assert tuple(w.shape) == (3, port.plan.num_wires, PARAMS.n + 1)
    got = port.evaluate(w)
    _same_words(got, ref.evaluate(jnp.asarray(to_host(w))), port.plan.num_wires)
    for m, out in zip(maps, port.decrypt_outputs(got)):
        exp = _oracle(nl, m)
        assert out == {k: bool(exp[k]) for k in nl.outputs}


def test_c880_like(engines):
    ref, port = engines
    nl = read_verilog_file("benchmarks/netlists/c880-like.v")
    _compile(engines, nl)
    inputs = _golden("c880-like.inputs.csv")
    w0 = port.encrypt_inputs(inputs)
    got = port.evaluate(w0)
    _same_words(got, ref.evaluate(jnp.asarray(to_host(w0))), port.plan.num_wires)
    out = port.decrypt_outputs(got)
    assert out == _golden("c880-like.outputs.csv")
    exp = _oracle(nl, inputs)
    assert out == {k: bool(exp[k]) for k in nl.outputs}
