"""The multi-device dryrun: a full encrypted evaluation sharded over a mesh.

Counterpart of `__graft_entry__.py::dryrun_multichip` (the reference's
`entry()` beside it returns a jittable function for a compile check, which
has no PyTorch counterpart and is not ported). The same four checks, with
the same parameter sets, netlists, seeds and operands, printing the same
four lines:

1. the 8-bit adder at TEST_NOISY_GATES_MB (90+33);
2. the LUT adder at TEST_NOISY_LUT_K2 (0x2B+0x4D);
3. a fused 2-bit adder (1+3+1): on a card one graph replay a call, the
   shards' kernels inside it; on the CPU fusing changes nothing;
4. chi-squared u8 at TEST_PARAMS_ARITH against the arith oracle.

Like every entry point of the port it runs on the card: on n cards
(`make_gate_mesh`, which raises when fewer exist), or on the shard devices
`devices` given, e.g. four shards of one card. `device="cpu"` runs it on n
virtual shards, as the reference's runs on XLA's virtual CPU devices.

    python -m helm_tpu_torch.parallel.dryrun 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bits(name: str, value: int, width: int) -> dict:
    return {f"{name}[{i}]": bool(value >> i & 1) for i in range(width)}


def _word(out: dict, width: int) -> int:
    return sum(int(out[f"sum[{i}]"]) << i for i in range(width)) + (int(out["cout"]) << width)


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> None:
    """Shard a full encrypted evaluation over an n-device mesh and run it;
    raises on a wrong result."""
    from .. import params as P
    from ..circuit.graph import Circuit
    from ..circuit.verilog import read_verilog_file
    from ..engines.arith import ArithEngine
    from ..engines.boolean import BooleanEngine
    from .mesh import GateMesh, batch_sharding, make_gate_mesh, replicated

    def mesh_for(engine):
        mesh = GateMesh(devices) if devices is not None else make_gate_mesh(n_devices, device)
        assert mesh.size == n_devices, (mesh.size, n_devices)
        engine.set_sharding(batch_sharding(mesh), replicated(mesh))
        return mesh

    def netlist(name, arith=False):
        return read_verilog_file(os.path.join(ROOT, "benchmarks/netlists", name), arith)

    nl = netlist("8-bit-adder.v")
    # the noisy multi-bit set: sigma > 0 decryption margins and the
    # grouping-2 key layout under sharding
    engine = BooleanEngine(mode="gates", params=P.TEST_NOISY_GATES_MB, seed=7, device=device)
    mesh = mesh_for(engine)
    engine.compile(nl)
    a, b = 90, 33
    inputs = _bits("a", a, 8) | _bits("b", b, 8) | {"cin": False}
    got = _word(engine.decrypt_outputs(engine.evaluate(engine.encrypt_inputs(inputs))), 8)
    assert got == a + b, f"sharded eval wrong: {got} != {a + b}"
    print(f"dryrun_multichip({n_devices}): OK — {a}+{b}={got} on mesh {mesh}")

    # LUT mode over the mesh (the noisy k=2 geometry of LUT_128_K2): the
    # per-slot test polynomials sharded with the batch
    nl_lut = netlist("8-bit-adder-lut-3-1.v")
    el = BooleanEngine(mode="lut", params=P.TEST_NOISY_LUT_K2, seed=7, device=device)
    mesh_for(el)
    el.compile(nl_lut)
    la, lb = 0x2B, 0x4D
    lin = _bits("a", la, 8) | _bits("b", lb, 8)
    lin |= {w: False for w in nl_lut.inputs if w not in lin}
    lgot = _word(el.decrypt_outputs(el.evaluate(el.encrypt_inputs(lin))), 8)
    assert lgot == la + lb, f"sharded LUT eval wrong: {lgot} != {la + lb}"
    print(f"dryrun_multichip({n_devices}): LUT OK — {la}+{lb}={lgot}")

    # fused and sharded: on a card the level loop with every shard's
    # kernels is one graph; a second call replays it
    em = BooleanEngine(mode="gates", params=P.TEST_NOISY_GATES_MB, seed=7, device=device,
                       fuse_levels=True)
    mesh_for(em)
    em.compile(netlist("2-bit-adder.v"))
    mi = {"a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True, "cin": True}
    wires = em.encrypt_inputs(mi)
    first = em.evaluate(wires)
    mgot = _word(em.decrypt_outputs(em.evaluate(wires)), 2)
    assert _word(em.decrypt_outputs(first), 2) == mgot == 1 + 3 + 1, f"sharded fused eval wrong: {mgot}"
    print(f"dryrun_multichip({n_devices}): fused shards OK — 1+3+1={mgot}")

    # arith mode over the same mesh: every merged radix bootstrap sharded
    nl2 = netlist("chi_squared_arith.v", True)
    ea = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=7, device=device)
    mesh_for(ea)
    ea.compile(nl2)
    ins = {"n0": 3, "n1": 5, "n2": 7}
    out2 = ea.decrypt_outputs(ea.evaluate(ea.encrypt_inputs(ins)))
    c2 = Circuit.from_netlist(nl2)
    exp2 = c2.evaluate_arith(c2.initialize_wire_map(nl2.wire_set, ins, default=0), 8)
    for w in ("alpha", "beta1", "beta2", "beta3"):
        assert out2[w] == exp2[w], (w, out2[w], exp2[w])
    print(f"dryrun_multichip({n_devices}): arith OK — chi-squared sharded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the multi-device dryrun on a gate mesh")
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (n cards, the default) or cpu (n virtual shards)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available (--device cpu runs virtual shards)")
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
