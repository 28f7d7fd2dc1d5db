"""The traced run's reading of ``torch.profiler``'s trace.

The harness traces a span of the running load with the profiler's CUDA
activity alone (kernels, copies, sets, and the CUDA runtime and driver
calls that launch them; no record of the host's operators, which would
slow the host that paces the cell). At the span's two ends the main
thread makes ``ANCHORS`` stream queries, each between two readings of the
host clock: the trace's ``cudaStreamQuery`` events tie the host clock to
the profiler's (the tightest pair at each end; within a few microseconds),
and give the span on the profiler's clock. A trace whose queries do not
match the anchors is refused: nothing is read on a clock that is not tied
to the host's. This module reads the exported Chrome trace: the device's
kernels, copies and sets in the span, and for each call the harness timed
(``spans.py``) the device time of the kernels launched inside the call's
interval: a launch is a CUDA runtime or driver call, tied to its kernel by
the profiler's correlation id. (The profiler does not name the calling
thread of a launch in a form the harness can match, so launches of every
thread count; the calls timed so are scans whose device time dwarfs what
another thread launches meanwhile.) Times are seconds.
"""

from __future__ import annotations

import bisect
import json
import time
from dataclasses import dataclass, field

from recall_bench import measure

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
ANCHOR_CALL = "cudaStreamQuery"
ANCHORS = 16


def anchor() -> list:
    """(before, after) host-clock readings around ``ANCHORS`` stream queries."""
    import torch

    stream = torch.cuda.current_stream()
    out = []
    for _ in range(ANCHORS):
        a = time.perf_counter()
        stream.query()
        out.append((a, time.perf_counter()))
    return out


@dataclass
class Span:
    name: str
    shapes: dict
    start: float              # profiler clock
    end: float
    device_s: float = 0.0     # kernels launched inside the call
    kernels: int = 0


@dataclass
class Trace:
    window: tuple             # (start, end), profiler clock
    device: list              # [(start, end, name)] of every device operation
    spans: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        return measure.merge([(s, e) for s, e, _ in self.device], *self.window)

    def busy_s(self) -> float:
        return float(sum(e - s for s, e in self.busy()))

    def in_window(self, name: str) -> list:
        lo, hi = self.window
        return [s for s in self.spans if s.name == name and lo <= s.start < hi]


def read(path: str, anchors: dict, calls: list) -> Trace:
    """``anchors``: the traced window's (start, end) on the host clock and
    ``anchor``'s readings at its two ends; ``calls``: the timed calls
    (``spans.Call``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches, queries = [], [], []
    kernel_s: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", "")))
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None and cat == "kernel":
                kernel_s[corr] = kernel_s.get(corr, 0.0) + dur
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches.append((ts, corr))
            if ev.get("name") == ANCHOR_CALL:
                queries.append(ts)
    to_trace = _clock_map(anchors, queries)
    launches.sort()
    spans = []
    for c in calls:
        span = Span(c.name, c.shapes, to_trace(c.start), to_trace(c.end))
        i = bisect.bisect_left(launches, (span.start, -1))
        while i < len(launches) and launches[i][0] <= span.end:
            k = kernel_s.get(launches[i][1])
            if k is not None:
                span.device_s += k
                span.kernels += 1
            i += 1
        spans.append(span)
    return Trace(window=tuple(to_trace(h) for h in anchors["window"]), device=device,
                 spans=spans)


def _clock_map(anchors: dict, queries: list):
    """host clock -> profiler clock, through the tightest anchor at each end
    of the span; raises unless the trace holds the anchors' queries."""
    mine = sorted(queries)
    groups = anchors["queries"]
    if len(groups) != 2 or not all(groups) or len(mine) != sum(map(len, groups)):
        raise ValueError(f"the trace holds {len(mine)} {ANCHOR_CALL} events; the anchors "
                         f"made {sum(map(len, groups))}")
    pts, i0 = [], 0
    for group in groups:
        i = min(range(len(group)), key=lambda i: group[i][1] - group[i][0])
        pts.append((0.5 * (group[i][0] + group[i][1]), mine[i0 + i]))
        i0 += len(group)
    (h0, p0), (h1, p1) = pts
    rate = (p1 - p0) / (h1 - h0)
    return lambda h: p0 + (h - h0) * rate


def top_device_ops(tr: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    the window, by name."""
    lo, hi = tr.window
    by: dict = {}
    for s, e, name in tr.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            key = name if len(name) <= 120 else name[:117] + "..."
            by[key] = by.get(key, 0.0) + d
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(tr: Trace, a: str, b: str) -> list:
    """[[what the host was in, seconds]]: the device's idle time in the
    window, split by which of the host spans ``a`` and ``b`` were open
    (``none``: neither, the coalescer collecting or waiting)."""
    lo, hi = tr.window
    idle = measure.gaps(tr.busy(), lo, hi)
    sa = measure.merge([(s.start, s.end) for s in tr.spans if s.name == a], lo, hi)
    sb = measure.merge([(s.start, s.end) for s in tr.spans if s.name == b], lo, hi)
    t_both = measure.overlap(idle, measure.intersect(sa, sb))
    t_a = measure.overlap(idle, sa) - t_both
    t_b = measure.overlap(idle, sb) - t_both
    total = float(sum(e - s for s, e in idle))
    out = {f"{a}+{b}": t_both, a: t_a, b: t_b, "none": total - t_both - t_a - t_b}
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])]
