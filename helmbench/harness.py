"""One run of one cell: keys and inputs from the seed, the program's engine
warmed up on the cell's own shape, a measured window driven by the traffic
mix, then the program's outputs judged by the plain reference.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by name: `configs/<config>.json`,
`traffic/<mix>.json` (parameters for the one generator, `generator.py`),
`metrics/<metric before its first dot>.py` (end-to-end and per-layer
readers alike), and the engine's adapter `modes/<mode>.py` that the
configuration names.

A reader's `read(run, name)` gets the whole record of the run (`Run`)
and returns a number, or None where it finds nothing to read. With
`--trace 1` the window's first half runs untraced (`run.window`: what the
host clock reads) and its second half under the profiler (`run.traced`,
`run.trace`: what the device trace reads), so that the profiler's own
cost stays out of host-clock readings.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import generator, reference
from .trace import WINDOW, summarize

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the numbers of the reference's judgement compared with the configuration's limits
COMPARED = ("wrong_outputs", "noise_std")
#: the program's parameter fields a configuration states
PARAM_FIELDS = ("name", "n", "k", "N", "pbs_base_log", "pbs_level", "ks_base_log", "ks_level",
                "lwe_noise_std", "glwe_noise_std", "msg_space_log", "message_bits", "grouping",
                "gadget_rows")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") the cell reports:
    those that list it, and those without a list whose end-to-end metric it
    reports."""
    e2e = [m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_config(name: str, configs_dir: Path = HERE / "configs") -> dict:
    cfg = load_json(configs_dir / f"{name}.json")
    cfg["netlist_path"] = str(ROOT / cfg["netlist"])
    return cfg


def program_params(cfg: dict):
    """The program's parameter set the configuration names, held to every
    number the configuration states."""
    from helm_tpu_torch import params as P

    p = getattr(P, cfg["params"]["program_name"])
    for f in PARAM_FIELDS:
        if getattr(p, f) != cfg["params"][f]:
            raise SystemExit(f"{cfg['name']}: the program's {cfg['params']['program_name']}.{f} is "
                             f"{getattr(p, f)!r}, the configuration states {cfg['params'][f]!r}")
    return p


def reader(name: str):
    """The reader of metric `name`: `metrics/<name before its first dot>.py`."""
    return importlib.import_module(f"helmbench.metrics.{name.split('.')[0]}")


@contextlib.contextmanager
def timed_builds(phases: dict):
    """Seconds the program spends compiling its kernels (nvcc, on a cold
    checkout only) go into phases["build"]; the builds themselves are the
    program's, untouched."""
    from helm_tpu_torch.ops import build

    compile_ = build._compile

    def timed(jobs):
        t0 = time.perf_counter()
        try:
            return compile_(jobs)
        finally:
            phases["build"] = phases.get("build", 0.0) + time.perf_counter() - t0

    build._compile = timed
    try:
        yield
    finally:
        build._compile = compile_


class Server:
    """What the generator drives: one call into the program's timed path,
    from the hand-over of a call's encrypted inputs to `engine.evaluate`
    until its output ciphertexts are on the host."""

    def __init__(self, engine, layout, pool, mode):
        self.engine, self.layout, self.pool, self.mode = engine, layout, pool, mode
        self.batch = layout.batch

    def call(self, rows, tracing: bool):
        with generator.span("helmbench.handover", tracing):
            wires = self.layout.fill(self.pool, rows)
        with generator.span("helmbench.evaluate", tracing):
            out = self.engine.evaluate(wires)
        with generator.span("helmbench.outputs_to_host", tracing):
            return self.layout.outputs_to_host(out)

    def counters(self) -> dict:
        return self.mode.counters(self.engine)

def client_key(params, seed_seq):
    """The benchmark's secret keys, drawn from the seed, in the program's
    ClientKey; its random stream (the masks and noise of the server key and
    of every encryption) is the program's CSPRNG, seeded from the seed."""
    from helm_tpu_torch.fhe import lwe
    from helm_tpu_torch.fhe.csprng import make_rng

    keys_ss, stream_ss = seed_seq.spawn(2)
    rng = np.random.default_rng(keys_ss)
    lwe_key = rng.integers(0, 2, size=params.n).astype(np.uint32)
    glwe_key = rng.integers(0, 2, size=(params.k, params.N)).astype(np.uint32)
    stream = int.from_bytes(stream_ss.generate_state(8, np.uint32).tobytes(), "little")
    return lwe.ClientKey(params, lwe_key, glwe_key, make_rng(stream))


@dataclass
class Run:
    """The record a reader gets.

    window: the untraced stretch (`generator.Part`): the whole window with
        `--trace 0`, its first half with `--trace 1`;
    traced: the traced stretch, or None;
    trace: the profiler's summary of the traced stretch (`trace.py`), or None;
    setup_s, phases: set-up's seconds, and the process clock at the end of
        each set-up phase (`build`: seconds compiling kernels, 0 when cached);
    params, config, traffic: the cell's parameter set, configuration, mix;
    program: what set-up read from the program (batch, the batch layer's
        fill of the card's slots or None).
    Each stretch's `counts` holds the program's counters' change over it,
    and `launches` and `bootstraps` (real slots bootstrapped)."""

    window: generator.Part
    traced: generator.Part | None
    trace: object | None
    setup_s: float
    phases: dict
    params: dict
    config: dict
    traffic: dict
    program: dict = field(default_factory=dict)


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, configs_dir: Path = HERE / "configs", hooks=None,
             traffic_dir: Path = HERE / "traffic") -> dict:
    """One run of `workload`. Returns the result line's fields and the
    numbers compared ("checks"). `hooks` (tests and the control only) may
    wrap the engine after set-up: hooks(engine, layout) -> engine."""
    import torch

    from helm_tpu_torch.fhe.server_key import gen_server_key

    cell = find_cell(spec, workload)
    cfg = load_config(cell["config"], configs_dir)
    mix = {"name": cell["traffic"], **load_json(traffic_dir / f"{cell['traffic']}.json")}
    generator.arrival_kind(mix)
    mode = importlib.import_module(f"helmbench.modes.{cfg['mode']}")
    nl = reference.read_netlist(cfg["netlist_path"], cfg["mode"] == "arith")
    params = program_params(cfg)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    phases = {"start": time.perf_counter() - t_process, "build": 0.0}
    inputs_ss, keys_ss = np.random.SeedSequence(seed).spawn(2)
    with timed_builds(phases):
        ck = client_key(params, keys_ss)
        sk = gen_server_key(ck, dev)
        phases["keys"] = time.perf_counter() - t_process
        engine = mode.make_engine(cfg, params, (ck, sk), dev)
        phases["engine"] = time.perf_counter() - t_process
        batch = mix["batch"]
        if batch == "auto":
            batch = mode.auto_batch(engine, mix["max_batch"])
        layout = mode.Layout(engine, nl, batch)
        program = {"batch": batch, "fill": mode.batch_fill(engine, batch) if dev.type == "cuda" else None}
        if hooks is not None:
            engine = hooks(engine, layout)

        # warm-up on the cell's own shape, with vectors of its own: the
        # calls the engine needs before it runs as it will in the window
        rng = np.random.default_rng(inputs_ss)
        warm = mode.encrypt(engine, nl, mode.draw_inputs(rng, nl, batch, cfg))
        t_call = None
        for _ in range(mode.warmup_calls(engine)):
            t0 = time.perf_counter()
            layout.outputs_to_host(engine.evaluate(layout.fill(warm, list(range(batch)))))
            t_call = time.perf_counter() - t0
    phases["warm-up"] = time.perf_counter() - t_process
    pool_inputs = mode.draw_inputs(rng, nl, generator.pool_vectors(mix, batch, seconds, t_call), cfg)
    pool = mode.encrypt(engine, nl, pool_inputs)
    del warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_process
    phases["pool"] = setup_s
    print("helmbench: set-up done at " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr, flush=True)

    server = Server(engine, layout, pool, mode)
    P = pool.shape[0]
    traced = summary = None
    if not trace:
        window = generator.run(server, mix, P, seconds, False, 0, rng)
    else:
        from torch.profiler import ProfilerActivity, profile

        window = generator.run(server, mix, P, seconds / 2, False, 0, rng)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with generator.span(WINDOW, True):
                traced = generator.run(server, mix, P, seconds / 2, True, window.vectors % P, rng)
        summary = summarize(prof)
        del prof
    parts = [p for p in (window, traced) if p is not None]
    for part in parts:
        part.counts = mode.counts(engine, part)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the program's state goes before the reference runs
    del engine, layout, pool, sk, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows = np.concatenate([np.asarray(p.rows) for p in parts])
    cts = np.concatenate([c for p in parts for c in p.outputs])
    verdict = mode.judge(cfg, mode.expected(cfg, nl, pool_inputs[rows]), cts, ck.lwe_key)
    limits = cfg["limits"]
    checks = {name: {"value": getattr(verdict, name), "limit": limits[name]} for name in COMPARED}
    vectors = sum(p.vectors for p in parts)
    correct = vectors > 0 and all(c["value"] <= c["limit"] for c in checks.values())

    run = Run(window, traced, summary, setup_s, phases, cfg["params"], cfg, mix, program)
    metrics = {}
    for m in cell_metrics(spec, workload, "per_layer" if trace else "end_to_end"):
        value = reader(m["name"]).read(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": vectors,
        "failed": verdict.failed,
        "metrics": metrics,
        "device": {"count": cell["chips"], "memory_peak_bytes": int(peak)},
        "batch": batch,
        "calls": sum(p.calls for p in parts),
        "pool_vectors": int(pool_inputs.shape[0]),
        "setup_phases": phases,
        "noise_rms": verdict.noise_rms,
        "noise_max": verdict.noise_max,
    }
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.top(summary.device_s),
                            "idle_gaps": summary.top(summary.idle_gaps)}
    out["checks"] = checks
    return out
