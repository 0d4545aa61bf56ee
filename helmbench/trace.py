"""The traced run's reading of torch.profiler: the device's busy time over
the measured window, device time by kernel name, and the idle gaps named
by what the host was doing in them.

The window is the harness's own span `helmbench.window`; the host spans
`helmbench.<step>` around each call into the program name the gaps the
program's own operations do not cover.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "helmbench.window"
#: how far back from a gap a host event that covers it is looked for
_LOOKBACK = 4096


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)  # device operation name -> seconds
    idle_gaps: dict = field(default_factory=dict)  # host event name -> seconds

    def kernel_s(self, *patterns: str) -> float | None:
        """Seconds of the device operations whose name holds any of the
        patterns (case blind), or None where there is none."""
        pats = [p.lower() for p in patterns]
        hits = [s for n, s in self.device_s.items() if any(p in n.lower() for p in pats)]
        return sum(hits) if hits else None

    def top(self, what: dict, count: int = 10) -> list:
        return [[name[:120], s] for name, s in sorted(what.items(), key=lambda x: -x[1])[:count]]


def summarize(prof) -> TraceSummary:
    """Read the profiler's events: device operations inside the window
    merged into busy intervals, the gaps between them named by the
    innermost host event open at each gap's middle."""
    from torch.autograd import DeviceType

    window = None
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (start, end)
            host.append((start, end, name))
        elif not name.startswith("helmbench."):  # on the card: kernels, copies, sets
            device.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    device_s: dict = defaultdict(float)
    spans = []
    for start, end, name in device:
        if end <= w0 or start >= w1:
            continue
        start, end = max(start, w0), min(end, w1)
        device_s[name] += (end - start) / 1e9
        spans.append((start, end))
    spans.sort()
    busy = 0
    gaps = []
    cursor = w0
    for start, end in spans:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    host.sort()
    starts = [h[0] for h in host]
    own = [h for h in host if h[2].startswith("helmbench.")]
    idle: dict = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = None
        for j in range(i, max(-1, i - _LOOKBACK), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        if name is None:  # the innermost of the harness's own spans
            covering = [h for h in own if h[0] <= mid <= h[1]]
            name = max(covering)[2] if covering else "(no host event)"
        idle[name] += (g1 - g0) / 1e9
    return TraceSummary((w1 - w0) / 1e9, busy / 1e9, dict(device_s), dict(idle))
