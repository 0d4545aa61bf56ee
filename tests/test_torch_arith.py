"""helm_tpu_torch ArithEngine (CPU tensors) against helm_tpu's.

Both engines get the same keys (the reference's, carried across with
`client_key_from_reference` / `server_key_from_reference`) and the same
encrypted inputs. Every radix op and every wire of an evaluated netlist
must equal the jnp engine's word for word (zero tolerance: exact integer
arithmetic), the decrypted values must equal the plaintext, and the
dataflow scheduler must take as many merged bootstrap rounds as the
reference's (`radix.LAUNCHES`). Two sets: TEST_PARAMS_ARITH (grouping 1,
the single-bit path: the netlists, which run add, sub, mul, square,
mul_plain and div_plain through the scheduler) and TEST_PARAMS_ARITH_MB
(grouping 2, multi-bit: the netlists, a batch, and every radix op on its
own). The file keeps to about a minute and a half on one CPU process.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from helm_tpu import params as RP
from helm_tpu.circuit.graph import Circuit as RefCircuit
from helm_tpu.circuit.verilog import parse_verilog as ref_parse_verilog
from helm_tpu.engines import radix as ref_radix
from helm_tpu.engines.arith import ArithEngine as RefEngine
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu.io import csv_io as ref_csv_io
from helm_tpu_torch import ArithEngine
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.verilog import parse_verilog
from helm_tpu_torch.engines import radix
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.io import csv_io
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

SETS = {"g1": (RP.TEST_PARAMS_ARITH, 71), "mb2": (RP.TEST_PARAMS_ARITH_MB, 72)}
CHI = "benchmarks/netlists/chi_squared_arith.v"
BLUR = "benchmarks/netlists/box_blur_arith.v"


@pytest.fixture(scope="module")
def pairs():
    """(reference engine, port engine) per set, each made on first use."""
    made = {}

    def get(name):
        if name not in made:
            p, seed = SETS[name]
            ck = ref_lwe.keygen(p, seed)
            sk = ref_gen_server_key(ck)
            made[name] = (
                RefEngine("u8", params=p, keys=(ck, sk)),
                ArithEngine(
                    "u8", params=p, device="cpu",
                    keys=(client_key_from_reference(ck), server_key_from_reference(sk)),
                ),
            )
        return made[name]

    return get


@pytest.fixture
def engines(pairs, request):
    return pairs(request.param)


BOTH = pytest.mark.parametrize("engines", sorted(SETS), indirect=True)
MB2 = pytest.mark.parametrize("engines", ["mb2"], indirect=True)


def _enc(port, vals):
    """[B, nb, n+1] encryptions of vals, as numpy words."""
    return np.stack([port._encrypt_value(int(v)) for v in vals])


def _same(ref_out, port_out):
    np.testing.assert_array_equal(to_host(port_out), np.asarray(ref_out))


def _values(port, out):
    return [port._decrypt_value(to_host(out[i])) for i in range(out.shape[0])]


XS = [250, 3, 0]
YS = [10, 77, 9]
#: division's operand pairs (one by zero: all ones)
DIV = ([200, 3], [7, 0])


@MB2
@pytest.mark.parametrize("op", ["add", "sub", "mul", "square", "div"])
def test_radix_binary_ops(engines, op):
    ref, port = engines
    xs, ys = DIV if op == "div" else (XS, YS)
    x, y = _enc(port, xs), _enc(port, ys)
    args = {"square": ((x, x), {"square": True})}.get(op, ((x, y), {}))
    name = "mul" if op == "square" else op
    got = getattr(port.ops, name)(*(words(a) for a in args[0]), **args[1])
    _same(getattr(ref.ops, name)(*(jnp.asarray(a) for a in args[0]), **args[1]), got)
    exp = {
        "add": [(a + b) % 256 for a, b in zip(xs, ys)],
        "sub": [(a - b) % 256 for a, b in zip(xs, ys)],
        "mul": [(a * b) % 256 for a, b in zip(xs, ys)],
        "square": [(a * a) % 256 for a in xs],
        "div": [a // b if b else 255 for a, b in zip(xs, ys)],
    }[op]
    assert _values(port, got) == exp


@MB2
@pytest.mark.parametrize("d", [0, 4, 3])
def test_radix_div_plain(engines, d):
    ref, port = engines
    x = _enc(port, XS)
    got = port.ops.div_plain(words(x), d)
    _same(ref.ops.div_plain(jnp.asarray(x), d), got)
    assert _values(port, got) == [v // d if d else 255 for v in XS]


@MB2
@pytest.mark.parametrize("amount,left", [(1, True), (2, False), (3, False)])
def test_radix_shift_plain(engines, amount, left):
    ref, port = engines
    x = _enc(port, XS)
    got = port.ops.shift_plain(words(x), amount, left)
    _same(ref.ops.shift_plain(jnp.asarray(x), amount, left), got)
    exp = [((v << amount) if left else (v >> amount)) % 256 for v in XS]
    assert _values(port, got) == exp


@MB2
@pytest.mark.parametrize("left", [True, False])
def test_radix_shift_encrypted_amount(engines, left):
    ref, port = engines
    xs, amounts = [250, 3], [1, 6]
    x, y = _enc(port, xs), _enc(port, amounts)
    got = port.ops.shift_ct(words(x), words(y), left)
    _same(ref.ops.shift_ct(jnp.asarray(x), jnp.asarray(y), left), got)
    exp = [((v << a) if left else (v >> a)) % 256 for v, a in zip(xs, amounts)]
    assert _values(port, got) == exp


def _compile(engines, path):
    """Each engine compiles its own package's parse of the netlist."""
    ref, port = engines
    with open(path) as f:
        src = f.read()
    ref.compile(ref_parse_verilog(src, True))
    nl = parse_verilog(src, True)
    port.compile(nl)
    assert ref.wire_index == port.wire_index
    return nl


def _run_both(engines, inputs):
    """Evaluate one encryption through both engines: every wire's words
    must agree, and so must the number of merged bootstrap rounds."""
    ref, port = engines
    wires = port.encrypt_inputs(inputs)
    ref_radix.LAUNCHES[0] = radix.LAUNCHES[0] = 0
    got = port.evaluate(wires)
    exp = ref.evaluate(jnp.asarray(to_host(wires)))
    np.testing.assert_array_equal(to_host(got), np.asarray(exp))
    assert radix.LAUNCHES[0] == ref_radix.LAUNCHES[0] > 0
    return got


def _oracle(nl, inputs, width=8):
    c = Circuit.from_netlist(nl)
    return c.evaluate_arith(c.initialize_wire_map(nl.wire_set, inputs, default=0), width)


@BOTH
@pytest.mark.parametrize("path,inputs", [
    (CHI, {"n0": 2, "n1": 7, "n2": 9}),
    (BLUR, {"p0": 10, "p1": 40, "p2": 70, "p3": 100, "p4": 130, "p5": 160}),
])
def test_netlist_every_wire_and_the_oracle(engines, path, inputs):
    _, port = engines
    nl = _compile(engines, path)
    got = _run_both(engines, inputs)
    exp = _oracle(nl, inputs)
    assert port.decrypt_all_wires(got) == {w: exp[w] for w in port.wire_index}
    assert port.decrypt_outputs(got) == {w: exp[w] for w in nl.outputs}


@MB2
def test_batched_chi_squared(engines):
    _, port = engines
    nl = _compile(engines, CHI)
    maps = [{"n0": 10, "n1": 20, "n2": 30}, {"n0": 1, "n1": 2, "n2": 3}, {"n0": 255, "n1": 0, "n2": 7}]
    got = _run_both(engines, maps)
    assert tuple(got.shape) == (len(port.wire_index), 3, port.nb, port.params.n + 1)
    for m, out in zip(maps, port.decrypt_outputs(got)):
        exp = _oracle(nl, m)
        assert out == {w: exp[w] for w in nl.outputs}


@pytest.mark.parametrize("i", [1, 2, 3, 4])
def test_evaluate_arith_equals_the_reference_on_chi_squared_u32(i):
    with open(CHI) as f:
        src = f.read()
    path = f"benchmarks/test-cases/chi_squared_arith_{i}"
    got = {}
    for parse, circuit, io in ((parse_verilog, Circuit, csv_io), (ref_parse_verilog, RefCircuit, ref_csv_io)):
        nl = parse(src, True)
        c = circuit.from_netlist(nl)
        ins = io.read_input_wires(f"{path}.inputs.csv", "u32")
        got[parse] = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, ins, default=0), 32)
    assert got[parse_verilog] == got[ref_parse_verilog]
    golden = csv_io.read_input_wires(f"{path}.outputs.csv", "u32")
    assert {w: got[parse_verilog][w] for w in golden} == golden
