"""helm_tpu_torch gate sharding (parallel/mesh.py) on virtual CPU meshes.

The port's sharded engines, on meshes of 1, 2, 4 and 8 virtual shards,
against helm_tpu's unsharded engines: the same keys (the reference's,
carried across), the same encrypted inputs, and every real wire equal word
for word (tolerance 0; the plan's trash wire and padding slots aside).
helm_tpu's own tests/test_sharding.py shows that its sharded engine equals
its unsharded one, so the unsharded engine stands in for it here and no
XLA mesh compile runs in this process; one case runs helm_tpu's sharded
engine in a fresh subprocess (as test_sharding.py does) and compares.
Also: sharded against unsharded within the port (fused and eager), the
exchange alone and the API's errors. Arith mode under
`ArithEngine.set_sharding` is tests/test_torch_mesh_arith.py, the dryrun
tests/test_torch_dryrun.py (each file near a minute alone).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu import params as RP
from helm_tpu.circuit.verilog import parse_verilog as ref_parse_verilog
from helm_tpu.engines.boolean import BooleanEngine as RefEngine
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu.parallel.distributed import parse_multihost_flag as ref_parse_multihost_flag
from helm_tpu_torch import BooleanEngine
from helm_tpu_torch.circuit.verilog import parse_verilog
from helm_tpu_torch.fhe.lwe import client_key_from_reference
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.parallel import mesh as M
from helm_tpu_torch.parallel.distributed import parse_multihost_flag
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "benchmarks", "netlists")

#: set name -> (reference params, key seed)
SETS = {
    "tiny": (RP.TEST_PARAMS, 13),
    "noisy_mb": (RP.TEST_NOISY_GATES_MB, 7),
    "noisy_lut": (RP.TEST_NOISY_LUT_K2, 7),
}


@pytest.fixture(scope="module")
def keys():
    """(reference keys, port keys) per set, made on first use."""
    made = {}

    def get(name):
        if name not in made:
            p, seed = SETS[name]
            ck = ref_lwe.keygen(p, seed)
            sk = ref_gen_server_key(ck)
            made[name] = ((ck, sk), (client_key_from_reference(ck), server_key_from_reference(sk)))
        return made[name]

    return get


def _netlists(name):
    with open(os.path.join(NETS, name)) as f:
        src = f.read()
    return ref_parse_verilog(src), parse_verilog(src)


def _port(keys, name, mode, shards, **kw):
    """The port's engine on a mesh of `shards` virtual CPU shards (None:
    unsharded)."""
    ck, sk = keys(name)[1]
    eng = BooleanEngine(mode=mode, params=ck.params, device="cpu", keys=(ck, sk), **kw)
    if shards is not None:
        mesh = M.shard_engine(eng, shards)
        assert mesh.size == shards and mesh.devices == [torch.device("cpu")] * shards
        assert eng.mesh is mesh
    return eng


def _real(wires, eng):
    """The real wires: all but the plan's trash wire (the last)."""
    return to_host(wires)[..., : eng.plan.num_wires - 1, :]


def _bits(name, value, width):
    return {f"{name}[{i}]": bool(value >> i & 1) for i in range(width)}


ADDER2 = {"a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True, "cin": True}

#: (case, set, mode, netlist, inputs, cycles): the 2-bit adder, the noisy
#: multi-bit 8-bit adder, s27 over 3 cycles, the noisy k=2 LUT adder and a
#: batch of 3 input vectors
CASES = {
    "adder2": ("tiny", "gates", "2-bit-adder.v", ADDER2, 1),
    "adder8_noisy_mb": ("noisy_mb", "gates", "8-bit-adder.v", _bits("a", 90, 8) | _bits("b", 33, 8) | {"cin": False}, 1),
    "s27_x3": ("tiny", "gates", "s27.v", {"G0": True, "G1": False, "G2": True, "G3": True}, 3),
    "lut_adder_noisy_k2": ("noisy_lut", "lut", "8-bit-adder-lut-3-1.v", _bits("a", 0x2B, 8) | _bits("b", 0x4D, 8), 1),
    "batch3": ("tiny", "gates", "2-bit-adder.v", [
        _bits("a", a, 2) | _bits("b", b, 2) | {"cin": c} for a, b, c in ((3, 2, True), (0, 3, False), (1, 1, True))
    ], 1),
}


@pytest.mark.parametrize("case,shards", [
    ("adder2", 1), ("adder2", 2), ("adder2", 4), ("adder2", 8),
    ("adder8_noisy_mb", 2), ("s27_x3", 4), ("lut_adder_noisy_k2", 2), ("batch3", 8),
])
def test_sharded_port_equals_the_unsharded_reference(keys, case, shards):
    name, mode, net, inputs, cycles = CASES[case]
    ref_nl, nl = _netlists(net)
    if mode == "lut":
        inputs = inputs | {w: False for w in nl.inputs if w not in inputs}
    p, _ = SETS[name]
    ref = RefEngine(mode=mode, params=p, keys=keys(name)[0], backend="jnp", fuse_levels=False)
    ref.compile(ref_nl)
    port = _port(keys, name, mode, shards)
    port.compile(nl)
    assert port.plan.wire_index == ref.plan.wire_index
    assert all(lp.num_slots % shards == 0 for lp in port.plan.levels if lp.num_slots)
    wires = port.encrypt_inputs(inputs)
    exp = jnp.asarray(to_host(wires))
    got = wires
    for _ in range(cycles):
        got = port.evaluate(got)
        exp = ref.evaluate(exp)
    np.testing.assert_array_equal(_real(got, port), np.asarray(exp)[..., : port.plan.num_wires - 1, :])


_REF_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from helm_tpu import params as P
from helm_tpu.circuit.verilog import read_verilog_file
from helm_tpu.engines.boolean import BooleanEngine
from helm_tpu.fhe import lwe
from helm_tpu.fhe.server_key import gen_server_key
from helm_tpu.parallel.mesh import shard_engine

out = sys.argv[1]
ck = lwe.keygen(P.TEST_PARAMS, 13)
e = BooleanEngine(mode="gates", params=P.TEST_PARAMS, keys=(ck, gen_server_key(ck)))
shard_engine(e, 4)
e.compile(read_verilog_file("benchmarks/netlists/2-bit-adder.v"))
w = e.encrypt_inputs({"a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True, "cin": True})
np.save(os.path.join(out, "in.npy"), np.asarray(w))
np.save(os.path.join(out, "out.npy"), np.asarray(e.evaluate(w)))
"""


def test_sharded_port_equals_the_sharded_reference(keys, tmp_path):
    """helm_tpu's sharded engine (4 virtual XLA devices, in a fresh
    subprocess) and the port's on 4 virtual shards, from one key seed: the
    same words on every real wire."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_SHARDED, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    _, nl = _netlists("2-bit-adder.v")
    port = _port(keys, "tiny", "gates", 4)
    port.compile(nl)
    got = port.evaluate(words(np.load(tmp_path / "in.npy")))
    np.testing.assert_array_equal(_real(got, port), np.load(tmp_path / "out.npy")[: port.plan.num_wires - 1])
    assert port.decrypt_outputs(got) == {"sum[0]": True, "sum[1]": False, "cout": True}


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_port_equals_the_unsharded_port(keys, fuse, shards):
    """Fused or eager, the sharded engine's words are the unsharded one's
    (on the CPU fusing runs the same loop; on the card it is one graph)."""
    _, nl = _netlists("s27.v")
    base = _port(keys, "tiny", "gates", None, fuse_levels=fuse)
    sharded = _port(keys, "tiny", "gates", shards, fuse_levels=fuse)
    base.compile(nl)
    sharded.compile(nl)
    assert base.fused == sharded.fused == fuse
    wires = base.encrypt_inputs({"G0": False, "G1": True, "G2": True, "G3": False})
    np.testing.assert_array_equal(_real(sharded.evaluate_cycles(wires, 2), sharded),
                                  _real(base.evaluate_cycles(wires, 2), base))


def test_bootstrap_sharded_pads_and_slices(keys):
    """The exchange alone: R = 5 slots on 4 shards (padded to 8), with one
    test polynomial per slot and with one for all, equals one unsharded
    bootstrap."""
    from helm_tpu_torch.fhe import lwe, pbs
    from helm_tpu_torch.ops import mb_pbs

    ck, sk = keys("tiny")[1]
    dsk = pbs.DeviceServerKey.from_host(sk, "cpu")
    p = dsk.params
    x = words(lwe.encrypt(ck, lwe.encode_bool(np.array([1, 0, 1, 1, 0], bool))))
    rng = np.random.default_rng(5)
    per_slot = words(rng.integers(0, 1 << 32, size=(5, p.N), dtype=np.uint64).astype(np.uint32))
    mesh = M.GateMesh(["cpu"] * 4)
    for tv in (words(pbs.gates_test_poly(p)), per_slot):
        got = M.bootstrap_sharded(mesh, dsk, x, tv)
        assert torch.equal(got, mb_pbs.bootstrap(dsk, x, tv))
    assert M.bootstrap(None, dsk, x, per_slot).shape == (5, p.n + 1)


def test_api_errors(keys):
    _, nl = _netlists("2-bit-adder.v")
    eng = _port(keys, "tiny", "gates", None)
    eng.compile(nl)
    with pytest.raises(RuntimeError, match="before compile"):
        M.shard_engine(eng, 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 available"):
            M.make_gate_mesh(2, device="cuda")
    for spec in ("10.0.0.1:8476,4,2", "localhost:1,1,0"):
        assert parse_multihost_flag(spec) == ref_parse_multihost_flag(spec)
    for bad in ("bad", "a:1,2", "a:1,2,3,4"):
        with pytest.raises(ValueError) as port_err:
            parse_multihost_flag(bad)
        with pytest.raises(ValueError) as ref_err:
            ref_parse_multihost_flag(bad)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="do not split"):
        M.GateMesh([])
    with pytest.raises(NotImplementedError, match="one card"):
        M.check_capturable(M.GateMesh(["cpu"] * 2), torch.device("cuda", 0))
