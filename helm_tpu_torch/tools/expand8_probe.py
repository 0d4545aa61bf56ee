"""Lane expansion probe (K7): the port of `tools/expand8_hw_test.py`.

Expands x u32 [6144, 8] (< 61441, numpy seed 0) to [6144, 128] through
the one-hot e8 f32 [8, 768] (its first 128 columns), as `_expand8` does,
checks it against np.tile(x, (1, 16)) and prints the time a call (eager:
events around REPS calls, the host's enqueue rate at this size; and the
device time: GRAPH_CALLS calls captured into a CUDA graph, replayed
GRAPH_REPLAYS times), the bytes a second of the device time, the bound
and the card's readings of the build; the same two times of
x.repeat(1, 16), the one PyTorch call of the same function.

    python -m helm_tpu_torch.tools.expand8_probe                # the card (K7)
    python -m helm_tpu_torch.tools.expand8_probe --device cpu   # the plain version

Env: REPS (default 30; 1 on the CPU, where the graph time is not
measured).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import probes
from .probe_timing import bound_s, device_arg, device_name, graph_ms, notes, timed

R, N1, WIDE, L = 6144, 8, 768, 128
#: calls in a graph and its replays (the card)
GRAPH_CALLS, GRAPH_REPLAYS = 30, 20


def inputs():
    """The reference's x and e8 (numpy seed 0)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 61441, size=(R, N1), dtype=np.uint32)
    e8 = np.zeros((N1, WIDE), np.float32)
    lanes = np.arange(WIDE)
    e8[lanes % N1, lanes] = 1.0
    return x, e8


def work() -> tuple[float, float]:
    """(FP32 operations, bytes) of one call: 8 multiply-adds a limb a word; x
    and e8 read once, the words written once."""
    return 4.0 * N1 * R * L, 4.0 * (R * N1 + N1 * L + R * L)


def run(device, reps: int) -> dict:
    x, e8 = inputs()
    xd = torch.from_numpy(x.astype(np.int32)).to(device)
    ed = torch.from_numpy(np.ascontiguousarray(e8[:, :L])).to(device)
    _, dt, out = timed(lambda: probes.expand8(xd, ed), reps, device)
    _, lib_dt, _ = timed(lambda: xd.repeat(1, 16), reps, device)
    match = bool(np.array_equal(out.cpu().numpy().astype(np.uint32), np.tile(x, (1, 16))))
    ops, nbytes = work()
    bound, by = bound_s(fp32_ops=ops, nbytes=nbytes)
    graph_s = lib_graph_s = None
    if device.type == "cuda":
        graph_s = graph_ms(lambda: probes.expand8(xd, ed), GRAPH_CALLS, GRAPH_REPLAYS) / 1e3
        lib_graph_s = graph_ms(lambda: xd.repeat(1, 16), GRAPH_CALLS, GRAPH_REPLAYS) / 1e3

    def both(eager, graph):
        if graph is None:
            return f"{eager * 1e3:.6f} ms eager; graph replay not measured (cpu)"
        return f"{graph * 1e3:.6f} ms graph replay ({nbytes / graph / 1e9:.1f} GB/s), {eager * 1e3:.6f} ms eager"

    print(f"match: {match}", flush=True)
    print(f"x.repeat(1, 16) on {device_name(device)}: {both(lib_dt, lib_graph_s)}", flush=True)
    print(f"expand8 [{R},{N1}] -> [{R},{L}] on {device_name(device)}: {both(dt, graph_s)}; "
          f"{notes(device, bound, by, lambda: probes.resources('probe_expand8', 'helm_probe_expand8_resources'))}",
          flush=True)
    return {"match": match, "s": dt, "graph_s": graph_s, "library_s": lib_dt, "library_graph_s": lib_graph_s,
            "bound_s": bound, "bound_by": by}


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    res = run(device, int(env.get("REPS", "30" if device.type == "cuda" else "1")))
    return 0 if res["match"] else 1


if __name__ == "__main__":
    sys.exit(main())
