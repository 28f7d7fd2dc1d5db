"""Counterparts of the repository's ``tools/``: the probes that reach a TPU
kernel, and host-only tools.

Each module mirrors its tool by name, holds the probe's CUDA kernel wrapper
beside its plain PyTorch version, and runs the tool's own sweep from
``main`` (``python -m omni_recall_tpu_torch.tools.<name>``):

- ``profile_kernel`` (T1): K6's body split into cosine, cosine + keyword and
  the full top-9 extraction.
- ``probe_pipe`` (T2): K1's coarse scan, software-pipelined.
- ``probe_keys_emit`` (T4): K1's scan with three emit layouts of its
  packed-key extraction.
- ``profile_bloomT`` (T5): K4's int8 body over row-major and transposed
  bloom.
- ``probe_serve`` (T3): K3's body over pre-gathered candidate slabs, and the
  tool's split of a serving batch into its device stages.

Host-only tools (no kernel of their own), each beside the module it drives:

- ``probe_rebuild``: the stages of a shadow rebuild of the device index.
- ``sweep_10m``: K1 over the compact 10M store at several batches and
  layouts.
- ``bench_ingest``: the index append pipeline in chunks/s.
"""

from __future__ import annotations

import statistics
import time

import torch


def median_ms(fn, device: torch.device, runs: int = 8, device_only: bool = False) -> float:
    """Median wall time of ``runs`` calls of fn() after one warm-up call: on
    the card each call is timed with CUDA events (the device's time, the
    host's launch included), on the CPU by the host clock. ``device_only``
    queues a ~10 ms device sleep first, so that fn's launches are all queued
    before its first event and a kernel shorter than its host launch is
    timed on the device alone."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if device_only:
                torch.cuda._sleep(20_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bits (f32 compared through its int32 bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
