"""Gates/LUT family benchmark on a torch device: the port of
`tools/family_bench.py` (the RUNNING.md matrix).

Each netlist is compiled on one engine (keygen once), evaluated once
(the first call: on the card a fused engine captures its CUDA graph
there), then once more timed; the decrypted wires of that second pass
are checked against the plaintext oracle over every cycle, and one
`RESULT` JSON line is printed per netlist with the reference's fields.
Fields that differ from the reference's:
  backend                    the blind-rotation kernel that ran
                             (`mb_pbs.blind_rotation`, e.g. blind_rotate_mb)
                             on the card; "plain (cpu)" on the CPU
  pred_gate_times_per_vector the H100 serving model's cost a vector
                             (`batching.predicted_cost_per_vector`), in
                             place of the TPU's pred_lanes_per_vector
  pred_s_per_vector          that cost in seconds (x `batching.GATE_S`)
  pred_slots_per_vector      on the CPU, where the model counts slots
                             (in place of the two above)
pred_fill keeps its name (the gates the launches carry over the positions
they occupy).

    python -m helm_tpu_torch.tools.family_bench                # the card
    NETLISTS="benchmarks/netlists/s27.v:0:3" python -m helm_tpu_torch.tools.family_bench --device cpu

Env:
  NETLIST  path (default benchmarks/netlists/c880-like.v)
  NETLISTS space-separated `path[:batch[:cycles]]` entries, run in ONE
           process on one engine. Overrides NETLIST/BATCH/CYCLES.
  MODE     gates|lut (default gates)
  PSET     params name (default GATES_128_K3 / LUT_128_K2 by mode)
  FUSE     1/0 level fusion (unset = auto)
  BATCH    vectors per pass (0 = single vector, latency shape)
  CYCLES   sequential cycles (default 1)
  CYCFUSE  1 = all cycles in one dispatch (engine.evaluate_cycles)
  SEED     input RNG seed (default 7)
  REF_CORES  cores of the reference machine for its bounds (default 64)
BACKEND and GT are the TPU engine's knobs (its jnp/mxu backends and its
gate tile); the port has one route a set and the kernels choose their own
tiles, so a non-empty value exits.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import params as P
from ..circuit.graph import Circuit
from ..circuit.verilog import read_verilog_file
from .probe_timing import device_arg

TPU_KNOBS = {
    "BACKEND": "the TPU engine's jnp/mxu backend (the port has one route a set: mb_pbs.blind_rotation)",
    "GT": "the TPU kernels' gate tile (the Hopper kernels choose their own: mb_pbs.tile_plan)",
}


def refuse_tpu_knobs(env, knobs) -> None:
    """Exit on a non-empty TPU-only knob rather than ignore it."""
    for k in knobs:
        if env.get(k, ""):
            raise SystemExit(f"{k}={env[k]!r}: {TPU_KNOBS[k]}; leave {k} unset")


def params_named(name: str):
    p = getattr(P, name, None)
    if not isinstance(p, P.TfheParams):
        raise SystemExit(f"PSET={name!r} names no parameter set of helm_tpu_torch.params")
    return p


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def route(params, device) -> str:
    """The blind-rotation kernel an engine at `params` launches on
    `device` (the CPU runs the plain versions)."""
    if device.type != "cuda":
        return "plain (cpu)"
    from ..ops import mb_pbs

    return mb_pbs.blind_rotation(params).__name__


def jobs_of(env) -> list[tuple[str, int, int]]:
    if env.get("NETLISTS", ""):
        jobs = []
        for ent in env["NETLISTS"].split():
            parts = ent.split(":")
            jobs.append((parts[0], int(parts[1]) if len(parts) > 1 else 0, int(parts[2]) if len(parts) > 2 else 1))
        return jobs
    return [(env.get("NETLIST", "benchmarks/netlists/c880-like.v"), int(env.get("BATCH", "0")),
             int(env.get("CYCLES", "1")))]


def engine_for(mode, pset, fuse, device, keys=None):
    """The reference's engine (keygen seed 3), or one on `keys[pset.name]`
    = (client key, server key) when given (a caller that holds keys of the
    set already)."""
    from ..engines.boolean import BooleanEngine

    t0 = time.time()
    pre = keys.get(pset.name) if keys is not None else None
    e = BooleanEngine(mode=mode, params=pset, seed=None if pre else 3, keys=pre, device=device,
                      fuse_levels=fuse)
    print(f"KeyGen {time.time() - t0:.1f}s", flush=True)
    return e


def run_one(e, path: str, B: int, cycles: int, cycfuse: bool, rng, ref_cores: int) -> dict:
    """One netlist on engine `e`: compile, a first and a timed pass, the
    oracle over every cycle; the RESULT dict."""
    from ..batching import GATE_S, predicted_cost_per_vector
    from ..refbound import level_bootstrap_profile, reference_bounds

    device = e.device
    nl = read_verilog_file(path)
    e.compile(nl)

    def vec():
        return {w: bool(rng.integers(0, 2)) for w in sorted(nl.inputs)}

    inputs = [vec() for _ in range(B)] if B else vec()
    cycfuse = cycfuse and cycles > 1

    def once(wires):
        if cycfuse:
            return e.evaluate_cycles(wires, cycles)
        for _ in range(cycles):
            wires = e.evaluate(wires)
        return wires

    wires = e.encrypt_inputs(inputs)
    t0 = time.time()
    wires = once(wires)
    sync(device)
    first = time.time() - t0
    print(f"first eval (incl. capture): {first:.1f}s", flush=True)

    wires = e.encrypt_inputs(inputs)
    cyc_t = []
    t_all = time.time()
    if cycfuse:
        wires = once(wires)
        sync(device)
        dt = time.time() - t_all
        cyc_t = [dt / cycles] * cycles
    else:
        for _ in range(cycles):
            t0 = time.time()
            wires = e.evaluate(wires)
            sync(device)
            cyc_t.append(time.time() - t0)
        dt = time.time() - t_all

    c = Circuit.from_netlist(read_verilog_file(path))
    got = e.decrypt_all_wires(wires)
    ok = True
    vecs = inputs if B else [inputs]
    gots = got if B else [got]
    for iv, g in zip(vecs, gots):
        st = c.initialize_wire_map(nl.wire_set, iv)
        for _ in range(cycles):
            st = c.evaluate(st)
        ok = ok and all(bool(g[w]) == bool(v) for w, v in st.items())

    rb = reference_bounds(level_bootstrap_profile(c), cores=ref_cores, cycles=cycles)
    pv = dt / (B or 1)
    cost, fill = predicted_cost_per_vector(e, B or 1)
    if device.type == "cuda":
        pred = {"pred_gate_times_per_vector": round(cost, 1), "pred_s_per_vector": round(cost * GATE_S, 4)}
    else:
        pred = {"pred_slots_per_vector": round(cost, 1)}
    name = Path(path).stem
    backend = route(e.params, device)
    print(
        f"{name} steady-state: {dt:.3f}s"
        + (f" ({dt / B:.3f}s/vector, batch {B})" if B else "")
        + (f" cycles={cycles} per-cycle={[round(t, 3) for t in cyc_t]}" if cycles > 1 else "")
        + f" [{e.params.name}, {e.mode}, backend={backend}] correct={ok}",
        flush=True,
    )
    res = {
        "family": name, "mode": e.mode, "params": e.params.name, "backend": backend,
        "batch": B, "cycles": cycles, "cycfuse": cycfuse,
        "steady_s": round(dt, 3), "per_vector_s": round(pv, 3),
        "per_cycle_s": [round(t, 3) for t in cyc_t], "first_s": round(first, 1), "correct": ok,
        "ref_infinite_core_floor_s": rb["infinite_core_floor_s"], "ref_core_bound_s": rb["core_bound_s"],
        "ref_cores": rb["cores"], "ref_bootstraps": rb["bootstraps"],
        "vs_ref_floor": round(rb["infinite_core_floor_s"] / pv, 3),
        "vs_ref_cores": round(rb["core_bound_s"] / pv, 3),
        **pred, "pred_fill": round(fill, 3),
    }
    print("RESULT " + json.dumps(res), flush=True)
    return res


def run(env, device, keys=None) -> list[dict]:
    """Every job of `env` on one engine; the RESULT dicts."""
    refuse_tpu_knobs(env, ("BACKEND", "GT"))
    mode = env.get("MODE", "gates")
    if mode not in ("gates", "lut"):
        raise SystemExit(f"MODE={mode!r}: gates or lut")
    pset = params_named(env.get("PSET", "GATES_128_K3" if mode == "gates" else "LUT_128_K2"))
    fuse = bool(int(env["FUSE"])) if env.get("FUSE", "") else None
    jobs = jobs_of(env)
    e = engine_for(mode, pset, fuse, device, keys)
    rng = np.random.default_rng(int(env.get("SEED", "7")))
    cycfuse = bool(int(env.get("CYCFUSE", "0")))
    cores = int(env.get("REF_CORES", "64"))
    return [run_one(e, path, B, cycles, cycfuse, rng, cores) for path, B, cycles in jobs]


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    results = run(env, device)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
