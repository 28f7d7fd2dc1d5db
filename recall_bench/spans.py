"""The benchmark's own timers around the calls into the port's layers, put
in place for a traced run only and taken out after it. No program file
changes: the engine instance's two stage methods are shadowed on the
instance (the coalescer looks them up there each batch), and the two scans
are replaced in their modules, whose callers look them up at each call.

- ``dispatch`` / ``finalize``: ``RecallEngine._dispatch_device_batch`` and
  ``_finalize_device_batch``;
- ``k1`` (shapes n, d, b, sub, t): ``ops/scorer.py block_topt_int8_coarse``;
- ``xla_scan`` (shapes n, d, b, w): ``ops/xla_scorer.py score_topm``.

Each call is kept with its host-clock interval; the traced
run's reader (``trace.py``) places the intervals on the profiler's clock
and counts the device time of the kernels each call launched.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class Call:
    name: str
    start: float      # host clock (time.perf_counter)
    end: float
    shapes: dict


class HostClock:
    """Every timed call, in the order the calls ended."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls: list = []

    def add(self, call: Call) -> None:
        with self._lock:
            self.calls.append(call)

    def in_window(self, name: str, lo: float, hi: float) -> list:
        return [c for c in self.calls if c.name == name and lo <= c.start < hi]


def mean_ms(run, name: str):
    """Host ms of one ``name`` call: every call the run's window started,
    their total over their count; None in a run without the timers."""
    calls = run.clock.in_window(name, *run.window) if run.clock else []
    return 1e3 * sum(c.end - c.start for c in calls) / len(calls) if calls else None


def _timed(clock: HostClock, name: str, fn, shapes=None):
    def call(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            clock.add(Call(name, t, time.perf_counter(),
                           shapes(*args, **kwargs) if shapes else {}))
    return call


def _k1_shapes(emb8, q8, *args, t=None, sub=512, **_):
    if t is None:
        t = args[4]
    return {"n": emb8.shape[0], "d": emb8.shape[1], "b": q8.shape[0], "sub": sub, "t": t}


def _xla_shapes(emb, bloom, created, valid, q, *_, **__):
    return {"n": emb.shape[0], "d": emb.shape[1], "b": q.shape[0], "w": bloom.shape[1]}


def install(engine, clock: HostClock):
    """Put the timers in place; returns the function that takes them out."""
    from omni_recall_tpu_torch.ops import scorer, xla_scorer

    for stage in ("dispatch", "finalize"):
        attr = f"_{stage}_device_batch"
        setattr(engine, attr, _timed(clock, stage, getattr(engine, attr)))
    k1, xla = scorer.block_topt_int8_coarse, xla_scorer.score_topm
    scorer.block_topt_int8_coarse = _timed(clock, "k1", k1, _k1_shapes)
    xla_scorer.score_topm = _timed(clock, "xla_scan", xla, _xla_shapes)

    def remove():
        scorer.block_topt_int8_coarse, xla_scorer.score_topm = k1, xla
        for stage in ("dispatch", "finalize"):
            delattr(engine, f"_{stage}_device_batch")
    return remove
