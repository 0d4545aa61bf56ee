"""helm_tpu_torch ArithEngine under gate sharding (parallel/mesh.py) on a
virtual CPU mesh, against helm_tpu's unsharded jnp engine.

`ArithEngine.set_sharding` gives the engine's radix ops a mesh, so every
merged radix bootstrap of that engine goes through the mesh's exchange;
the words of every wire must equal the reference's (tolerance 0), with one
merged launch per round in both (`radix.LAUNCHES`); a second engine of the
process runs alone. About 40 s alone on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from helm_tpu import params as RP
from helm_tpu.circuit.verilog import parse_verilog as ref_parse_verilog
from helm_tpu.engines import radix as ref_radix
from helm_tpu.engines.arith import ArithEngine as RefArith
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import ArithEngine
from helm_tpu_torch.circuit.verilog import parse_verilog
from helm_tpu_torch.engines import radix
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.ntt import to_host
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.parallel import mesh as M
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

NETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "netlists")


def test_sharded_arith_equals_the_reference(monkeypatch):
    """Chi-squared u8 at TEST_PARAMS_ARITH: every merged radix bootstrap
    sharded on 4 virtual shards (the engine's `ops.mesh`), every wire equal
    to helm_tpu's jnp engine's, one merged launch per round in both, each
    through the mesh's exchange."""
    p = RP.TEST_PARAMS_ARITH
    ck = ref_lwe.keygen(p, 44)
    sk = ref_gen_server_key(ck)
    ref = RefArith("u8", params=p, keys=(ck, sk))
    pck = client_key_from_reference(ck)
    port = ArithEngine("u8", params=pck.params, device="cpu", keys=(pck, server_key_from_reference(sk)))
    mesh = M.make_gate_mesh(4, "cpu")
    port.set_sharding(M.batch_sharding(mesh), M.replicated(mesh))
    assert port.ops.mesh is mesh
    exchanges = []
    sharded = M.bootstrap_sharded
    monkeypatch.setattr(M, "bootstrap_sharded", lambda m, *a: exchanges.append(m) or sharded(m, *a))
    with open(os.path.join(NETS, "chi_squared_arith.v")) as f:
        src = f.read()
    ref.compile(ref_parse_verilog(src, True))
    port.compile(parse_verilog(src, True))
    wires = port.encrypt_inputs({"n0": 3, "n1": 5, "n2": 7})
    ref_radix.LAUNCHES[0] = radix.LAUNCHES[0] = 0
    got = port.evaluate(wires)
    exp = ref.evaluate(jnp.asarray(to_host(wires)))
    np.testing.assert_array_equal(to_host(got), np.asarray(exp))
    assert radix.LAUNCHES[0] == ref_radix.LAUNCHES[0] == len(exchanges) > 0
    assert all(m is mesh for m in exchanges)
    out = port.decrypt_outputs(got)
    assert out["alpha"] == ((4 * 3 * 7 - 5 * 5) ** 2) % 256 and out["beta1"] == (2 * (2 * 3 + 5) ** 2) % 256


def test_sharding_stays_with_its_engine(monkeypatch):
    """The mesh belongs to the engine that was sharded: a second engine of
    the same process (the same keys) bootstraps alone, never through the
    exchange, and its radix add is right."""
    p = RP.TEST_PARAMS_ARITH
    ck = ref_lwe.keygen(p, 45)
    keys = (client_key_from_reference(ck), server_key_from_reference(ref_gen_server_key(ck)))
    first = ArithEngine("u8", params=keys[0].params, device="cpu", keys=keys)
    first.set_sharding(*(f(M.make_gate_mesh(2, "cpu")) for f in (M.batch_sharding, M.replicated)))
    second = ArithEngine("u8", params=keys[0].params, device="cpu", keys=keys)
    assert second.ops.mesh is None

    def refuse(*a):
        raise AssertionError("an unsharded engine reached the mesh's exchange")

    monkeypatch.setattr(M, "bootstrap_sharded", refuse)
    enc = [torch.from_numpy(second._encrypt_value(v).astype(np.int64))[None] for v in (100, 57)]
    got = second.ops.add(*enc)
    assert second._decrypt_value(to_host(got)[0]) == 157
