"""The one traffic generator. A traffic mix is a data file
(`traffic/<mix>.json`) of parameters that this module reads:

- `batch`: the vectors the engine evaluates in one call, a number, or
  "auto" with `max_batch`: the batch the program's batch layer picks;
- `arrival`: how requests come.
  - {"kind": "closed"}: one client with one request in flight; a request
    carries the next `batch` vectors and the next leaves when its outputs
    are on the host. A backlog that never empties is the same loop.
  - {"kind": "poisson", "rate_per_s": r, "linger_s": l}: independent
    clients, one vector each, arriving open-loop at r vectors a second.
    The server takes up to `batch` waiting vectors once `batch` are
    waiting or the oldest has waited `linger_s`, fills the call's empty
    slots with copies of its last vector (the engine's shape is fixed at
    `batch`), and serves them; a vector's latency runs from its arrival to
    its outputs on the host. Every seed gets the same inter-arrival gaps
    (the exponential's quantiles), in an order of its own.

A stretch of the window (`Part`) closes at the completion of the call in
flight once its seconds have passed; open-loop vectors that arrived
before the close are served after it and counted. No call is cut.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

import numpy as np

#: the pool of encrypted vectors holds this many times what a stretch
#: needs at the warm-up's speed, and never more than MAX_POOL_VECTORS
POOL_MARGIN = 2.0
MAX_POOL_VECTORS = 4096
ARRIVALS = ("closed", "poisson")


def arrival_kind(mix: dict) -> str:
    kind = mix.get("arrival", {"kind": "closed"})["kind"]
    if kind not in ARRIVALS:
        raise SystemExit(f"traffic {mix.get('name')!r}: no arrival kind {kind!r} (one of {ARRIVALS})")
    return kind


@dataclass
class Part:
    """One stretch of the measured window: a record a served vector (its
    pool row, its arrival and completion on the host clock), the calls
    into the engine, the output ciphertexts on the host, and the program's
    counters before and after."""

    batch: int
    start: float = 0.0
    end: float = 0.0
    rows: list = field(default_factory=list)
    arrivals: list = field(default_factory=list)
    done: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    calls: int = 0
    before: dict = field(default_factory=dict)
    after: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @property
    def vectors(self) -> int:
        """Vectors served (a call's filler slots not counted)."""
        return len(self.rows)

    @property
    def slots(self) -> int:
        """Vector slots the engine evaluated: calls x batch."""
        return self.calls * self.batch

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def latencies(self) -> np.ndarray:
        return np.asarray(self.done, dtype=np.float64) - np.asarray(self.arrivals, dtype=np.float64)


def pool_vectors(mix: dict, batch: int, seconds: float, t_call: float) -> int:
    """Vectors the pool holds for `seconds` of this mix."""
    if arrival_kind(mix) == "closed":
        want = (math.ceil(POOL_MARGIN * seconds / max(t_call, 1e-6)) + 1) * batch
    else:
        want = len(_gaps(mix, seconds)) + batch
    return max(batch, min(want, (MAX_POOL_VECTORS // batch) * batch))


def _gaps(mix: dict, seconds: float) -> np.ndarray:
    """The inter-arrival gaps of `seconds` of open-loop arrivals: the
    exponential's quantiles at (i + 1/2) / M, the same set for every seed."""
    rate = float(mix["arrival"]["rate_per_s"])
    m = max(1, math.ceil(rate * seconds * POOL_MARGIN))
    return -np.log1p(-(np.arange(m) + 0.5) / m) / rate


def span(name: str, tracing: bool):
    """A host span of the trace, or nothing when not tracing."""
    if tracing:
        from torch.profiler import record_function

        return record_function(name)
    return contextlib.nullcontext()


def run(server, mix: dict, pool_size: int, seconds: float, tracing: bool, first_row: int,
        rng: np.random.Generator) -> Part:
    """Drive `server` (batch, call(rows) -> output ciphertexts on the host,
    counters() -> dict) for one stretch of `seconds`, from pool row
    `first_row` on."""
    part = Part(server.batch)
    part.before = server.counters()
    if arrival_kind(mix) == "closed":
        _closed(server, part, pool_size, seconds, tracing, first_row)
    else:
        gaps = rng.permutation(_gaps(mix, seconds))
        _poisson(server, part, pool_size, seconds, tracing, first_row, gaps, float(mix["arrival"]["linger_s"]))
    part.after = server.counters()
    return part


def _call(server, part: Part, rows: list, tracing: bool):
    with span("helmbench.request", tracing):
        cts = server.call(rows, tracing)
    part.calls += 1
    return cts


def _closed(server, part, pool_size, seconds, tracing, nxt):
    B = server.batch
    part.start = time.perf_counter()
    while True:
        rows = [(nxt + j) % pool_size for j in range(B)]
        nxt += B
        t0 = time.perf_counter()
        cts = _call(server, part, rows, tracing)
        t1 = time.perf_counter()
        part.rows.extend(rows)
        part.arrivals.extend([t0] * B)
        part.done.extend([t1] * B)
        part.outputs.append(cts)
        if t1 - part.start >= seconds:
            part.end = t1
            return


def _poisson(server, part, pool_size, seconds, tracing, nxt, gaps, linger):
    B = server.batch
    part.start = time.perf_counter()
    offsets = np.cumsum(gaps)
    arrivals = (part.start + offsets[offsets < seconds]).tolist()
    rows_of = [(nxt + i) % pool_size for i in range(len(arrivals))]
    head = 0  # the first vector not yet served
    while head < len(arrivals):
        now = time.perf_counter()
        waiting = sum(1 for t in arrivals[head:head + B] if t <= now)
        if waiting == 0 or (waiting < B and now - arrivals[head] < linger):
            wake = arrivals[head] + linger if waiting else arrivals[head]
            if head + waiting < len(arrivals):
                wake = min(wake, arrivals[head + waiting])
            time.sleep(max(0.0, wake - now))
            continue
        take = list(range(head, head + waiting))
        rows = [rows_of[i] for i in take]
        cts = _call(server, part, rows + [rows[-1]] * (B - len(rows)), tracing)
        t1 = time.perf_counter()
        part.rows.extend(rows)
        part.arrivals.extend(arrivals[i] for i in take)
        part.done.extend([t1] * len(take))
        part.outputs.append(cts[: len(take)])
        head += len(take)
    part.end = max(part.done[-1] if part.done else 0.0, part.start + seconds)
