"""Library-API walkthrough of helm_tpu_torch: everything the CLI does, as
Python calls, on a torch device.

Counterpart of `examples/library_api.py`, with its five sections at its
tiny test sets:

    python -m helm_tpu_torch.examples.library_api              # the card
    python -m helm_tpu_torch.examples.library_api --device cpu # plain torch versions

Covers the client/server split explicitly:
  client: keygen, encrypt inputs, decrypt outputs
  server: compile netlist, evaluate encrypted wires (never sees the
          client key, only the server key on the device)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from .. import params as P
from ..circuit.graph import Circuit
from ..circuit.verilog import read_verilog_file
from ..engines.arith import ArithEngine
from ..engines.boolean import BooleanEngine
from ..fhe.ntt import to_host, words

NETLISTS = Path(__file__).resolve().parents[2] / "benchmarks" / "netlists"


def gates_mode(device):
    """Boolean circuit: one gate bootstrap per gate, one launch per level."""
    nl = read_verilog_file(str(NETLISTS / "2-bit-adder.v"))
    # production: params=None -> GATES_128_K3 (>= 100-bit core-SVP; the
    # multi-bit kernel K1 on the card). Weak reference-mirroring sets
    # (P.GATES_PARAMS etc.) print a security warning when selected.
    engine = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=7, device=device)
    engine.compile(nl)

    inputs = {"a[0]": True, "a[1]": False, "b[0]": True, "b[1]": True, "cin": False}
    wires = engine.encrypt_inputs(inputs)          # client
    wires = engine.evaluate(wires)                 # server
    outputs = engine.decrypt_outputs(wires)        # client
    # cross-check against the plaintext oracle
    c = Circuit.from_netlist(nl)
    expected = c.evaluate(c.initialize_wire_map(nl.wire_set, inputs))
    assert all(bool(expected[w]) == bool(v) for w, v in outputs.items())
    print("gates:", dict(sorted(outputs.items())))


def lut_mode_sequential(device):
    """A DFF state loop evaluated for several cycles."""
    nl = read_verilog_file(str(NETLISTS / "s27.v"))
    engine = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=8, device=device)
    engine.compile(nl)
    inputs = {"G0": True, "G1": False, "G2": True, "G3": False}
    wires = engine.encrypt_inputs(inputs)
    for _cycle in range(3):
        wires = engine.evaluate(wires)
    print("s27 after 3 cycles:", engine.decrypt_outputs(wires))


def arith_mode(device):
    """Radix integers; ops merge into batched PBS rounds (dataflow)."""
    nl = read_verilog_file(str(NETLISTS / "chi_squared_arith.v"), True)
    engine = ArithEngine("u16", params=P.TEST_PARAMS_ARITH, seed=9, device=device)
    engine.compile(nl)
    inputs = {"n0": 10, "n1": 20, "n2": 30}
    outputs = engine.decrypt_outputs(engine.evaluate(engine.encrypt_inputs(inputs)))
    assert outputs["alpha"] == ((4 * 10 * 30 - 20 * 20) ** 2) % 2**16
    print("chi-squared u16:", outputs)


def batched_serving(device):
    """The production shape: V independent input vectors in ONE pass."""
    nl = read_verilog_file(str(NETLISTS / "2-bit-adder.v"))
    engine = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=10, device=device)
    engine.compile(nl)
    rng = np.random.default_rng(0)
    vecs = [{w: bool(rng.integers(0, 2)) for w in nl.inputs} for _ in range(4)]
    outs = engine.decrypt_outputs(engine.evaluate(engine.encrypt_inputs(vecs)))
    print("batched serving:", len(outs), "vectors in one pass")


def radix_ops_direct(device):
    """RadixOps as a library (no netlist): encrypted integer arithmetic on
    word tensors [B, blocks, n+1] on the device (engines/radix.py)."""
    e = ArithEngine("u8", params=P.TEST_PARAMS_ARITH, seed=11, device=device)
    x = words(np.stack([e._encrypt_value(v) for v in (17, 200)]), device)
    y = words(np.stack([e._encrypt_value(v) for v in (5, 99)]), device)
    s = to_host(e.ops.add(x, y))
    q = to_host(e.ops.div_plain(x, 3))
    print(
        "radix direct:",
        [e._decrypt_value(s[i]) for i in range(2)],
        [e._decrypt_value(q[i]) for i in range(2)],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to run the plain torch versions)"
        )
    gates_mode(device)
    lut_mode_sequential(device)
    arith_mode(device)
    batched_serving(device)
    radix_ops_direct(device)
    print("all examples OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
