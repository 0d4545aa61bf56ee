"""Arith-mode benchmark on a torch device: the port of
`tools/chi2_tpu_bench.py` (chi_squared u32 by default, a BASELINE config;
any arith netlist at any width).

One engine a width (keygen once a width); each netlist is evaluated once
(first call), then once more timed, checked against
`Circuit.evaluate_arith` on every vector, and one `RESULT` JSON line is
printed with the reference's fields and the reference's arith bounds
(`refbound.arith_reference_bounds`), plus `backend`, the blind-rotation
kernel that ran (K2 `blind_rotate_sb` at the default ARITH_PARAMS,
grouping 1; K1 `blind_rotate_mb` at ARITH_128_MB2).

    python -m helm_tpu_torch.tools.chi2_bench                  # the card
    PARAMS=TEST_PARAMS_ARITH WIDTH=u8 python -m helm_tpu_torch.tools.chi2_bench --device cpu

Env: PARAMS (a helm_tpu_torch.params name; default ARITH_PARAMS), BATCH
(vectors a pass, default 1), NETLIST, WIDTH=u8..u128, NETLISTS
(space-separated `path[:width[:batch]]`, run in one process, one engine a
width; overrides NETLIST/WIDTH/BATCH), REF_CORES (default 64). BACKEND is
the TPU engine's jnp/mxu choice; a non-empty value exits.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

from .. import params as P
from ..circuit.graph import Circuit
from ..circuit.verilog import read_verilog_file
from .family_bench import params_named, refuse_tpu_knobs, route, sync
from .probe_timing import device_arg


def jobs_of(env) -> list[tuple[str, str, int]]:
    if env.get("NETLISTS", ""):
        jobs = []
        for ent in env["NETLISTS"].split():
            parts = ent.split(":")
            jobs.append((parts[0], parts[1] if len(parts) > 1 else "u32", int(parts[2]) if len(parts) > 2 else 1))
        return jobs
    return [(env.get("NETLIST", "benchmarks/netlists/chi_squared_arith.v"), env.get("WIDTH", "u32"),
             int(env.get("BATCH", "1")))]


def run(env, device, keys=None, engines=None) -> list[dict]:
    """Every job of `env`; the RESULT dicts. `keys`: (client key, server
    key) by set name, used when there; `engines`: a dict of engines by
    width, filled and reused (the reference's per-width cache)."""
    from ..engines.arith import ArithEngine
    from ..refbound import arith_reference_bounds

    refuse_tpu_knobs(env, ("BACKEND",))
    pset = params_named(env["PARAMS"]) if env.get("PARAMS") else P.ARITH_PARAMS
    engines = {} if engines is None else engines
    cores = int(env.get("REF_CORES", "64"))
    results = []
    for path, width, B in jobs_of(env):
        bits = int(width[1:])
        nl = read_verilog_file(path, True)
        if width not in engines:
            t0 = time.time()
            pre = keys.get(pset.name) if keys is not None else None
            engines[width] = ArithEngine(width, params=pset, seed=None if pre else 11, keys=pre, device=device)
            print(f"KeyGen[{width}] {time.time() - t0:.1f}s", flush=True)
        e = engines[width]
        e.compile(nl)
        if "chi_squared" in path:
            base = {"n0": 10, "n1": 20, "n2": 30}  # the recorded-vector-1 inputs
        else:
            base = {w: (11 * j + 10) % (1 << min(bits, 16)) for j, w in enumerate(sorted(nl.inputs))}
        vecs = [{k: v + 7 * i for k, v in base.items()} for i in range(B)]
        inputs = vecs if B > 1 else base
        wires = e.encrypt_inputs(inputs)
        t0 = time.time()
        wires = e.evaluate(wires)
        sync(device)
        first = time.time() - t0
        print(f"first evaluation: {first:.1f}s", flush=True)
        w2 = e.encrypt_inputs(inputs)
        t0 = time.time()
        w2 = e.evaluate(w2)
        sync(device)
        dt = time.time() - t0
        name = Path(path).stem
        print(f"steady-state {name} {width} eval: {dt:.2f}s"
              + (f" ({dt / B:.2f}s/vector at batch {B})" if B > 1 else ""), flush=True)
        out = e.decrypt_outputs(w2)
        c = Circuit.from_netlist(read_verilog_file(path, True))
        outs = out if isinstance(out, list) else [out]
        ok = True
        for vi, o in enumerate(outs):
            exp = c.evaluate_arith(c.initialize_wire_map(nl.wire_set, vecs[vi], default=0), bits)
            ok = ok and all(o[w] == exp[w] for w in o)
        print("outputs:", outs[0], flush=True)
        print("correct:", ok, flush=True)
        rb = arith_reference_bounds(c, bits, cores=cores)
        pv = dt / (B or 1)
        res = {
            "family": name, "mode": "arith",
            "params": pset.name if env.get("PARAMS") else "ARITH_PARAMS",
            "backend": route(pset, device), "width": width, "batch": B,
            "steady_s": round(dt, 3), "per_vector_s": round(pv, 3), "first_s": round(first, 1),
            "correct": ok,
            "ref_infinite_core_floor_s": rb["infinite_core_floor_s"], "ref_core_bound_s": rb["core_bound_s"],
            "ref_cores": rb["cores"], "ref_bootstraps": rb["bootstraps"],
            "vs_ref_floor": round(rb["infinite_core_floor_s"] / pv, 3),
            "vs_ref_cores": round(rb["core_bound_s"] / pv, 3),
            "bounds_model": rb["model"],
        }
        print("RESULT " + json.dumps(res), flush=True)
        results.append(res)
    return results


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    results = run(env, device)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
