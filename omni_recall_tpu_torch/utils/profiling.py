"""Profiling helpers (PyTorch port of omni_recall_tpu/utils/profiling.py).

- ``Stopwatch``: a tiny monotonic timer, used by the eval harness and the
  tools.
- ``device_trace(log_dir, device="cuda")``: a ``torch.profiler`` trace of
  the block (CPU and, on the card, CUDA activities), written into
  ``log_dir`` as a Chrome trace (``trace.json``) for Perfetto or
  ``chrome://tracing``, where the reference captures a ``jax.profiler``
  trace. ``device_ops`` reads the device's kernels back out of it.
- ``median_ms``: the median of ``runs`` timed calls after a warm-up, with
  CUDA events on the card (optionally device-only: a ~10 ms device sleep is
  queued first, so every launch of fn is queued before its start event and
  the time is the device's alone) and the host clock on the CPU. The
  stage probes of ``omni_recall_tpu_torch/tools`` and ``chip_smoke.py``
  time with it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from dataclasses import dataclass, field

import torch

from omni_recall_tpu_torch.device import resolve_device

SLEEP_CYCLES = 20_000_000  # ~10 ms of the card's clock cycles


class Stopwatch:
    def __init__(self) -> None:
        self._start = time.monotonic()

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self._start) * 1000.0


@dataclass
class DeviceTrace:
    """What ``device_trace`` yields: the trace file's path (written when the
    block ends) and the finished ``torch.profiler.profile``."""

    path: str
    profile: object = field(default=None, repr=False)


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device = "cuda"):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json``. CUDA unless the CPU is asked; raises without a
    card."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    trace = DeviceTrace(os.path.join(log_dir, "trace.json"))
    with profile(activities=activities) as prof:
        yield trace
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(trace.path)
    trace.profile = prof


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_ops(path: str) -> list[dict]:
    """The device's operations in a Chrome trace, by name: {name, category,
    count, total_us, max_us}, longest total first."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    ops: dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        op = ops.setdefault(ev["name"], {"name": ev["name"], "category": ev["cat"],
                                         "count": 0, "total_us": 0.0, "max_us": 0.0})
        dur = float(ev.get("dur", 0.0))
        op["count"] += 1
        op["total_us"] += dur
        op["max_us"] = max(op["max_us"], dur)
    return sorted(ops.values(), key=lambda op: -op["total_us"])


def cuda_median_ms(fn, runs: int = 5, device_only: bool = False) -> float:
    """Median of ``runs`` CUDA-event timings of fn() after one warm-up (and a
    synchronize). Without ``device_only`` a launch that takes less time on
    the device than on the host is timed at its host launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_median_ms(fn, runs: int = 5, sync: bool = False) -> float:
    """Median host-clock time of ``runs`` calls of fn() after one warm-up;
    ``sync`` waits for the card after each call (the time then includes
    the device's)."""
    fn()
    if sync:
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median_ms(fn, device: torch.device, runs: int = 8, device_only: bool = False) -> float:
    """``cuda_median_ms`` on the card, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return cuda_median_ms(fn, runs, device_only)
    return host_median_ms(fn, runs)
