"""Where a localq (device-resident query) serving batch goes.

Counterpart of the repository's ``tools/probe_localq.py``: builds the
bench's localq engine (``tools/localq.py build_localq_engine``: the
fine-tuned encoder, 2^16 rows by default), serves two warm-up batches,
then wraps the host-side helpers of the serving path with accumulating
timers and serves three sequential batches split into dispatch and
finalize, then ``groups`` batches through ``search_batches_pipelined``.

``python -m omni_recall_tpu_torch.tools.probe_localq [--rows N] [--batch B]
[--groups G] [--steps S] [--device cpu]`` prints one JSON line a stage and
a summary line (QPS of the pipelined batches, the engine's counters).
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from datetime import timedelta

import torch

from omni_recall_tpu_torch.device import resolve_device


class StageTimers:
    """Accumulating wall-clock timers around named functions."""

    def __init__(self) -> None:
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._undo: list = []

    def wrap(self, obj, name: str, key: str | None = None) -> None:
        fn = getattr(obj, name)
        key = key or name

        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.times[key] = self.times.get(key, 0.0) + time.perf_counter() - t0
                self.counts[key] = self.counts.get(key, 0) + 1

        setattr(obj, name, timed)
        self._undo.append((obj, name, fn))

    def dump(self) -> dict:
        out = {k: {"ms": self.times[k] * 1e3, "calls": self.counts[k]}
               for k in sorted(self.times, key=lambda k: -self.times[k])}
        self.times.clear()
        self.counts.clear()
        return out

    def restore(self) -> None:
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)
        self._undo.clear()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(engine, make_reqs, batch: int = 1536, groups: int = 6, emit=print) -> dict:
    """The probe's stages on a built localq engine; returns the summary."""
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.ops import exact_cos, hashing, native
    from omni_recall_tpu_torch.search import engine as engine_mod

    device = engine.device_index.device
    now = EPOCH + timedelta(days=365.0)
    for i in (60, 61):
        t0 = time.perf_counter()
        engine.search_batches_pipelined([make_reqs(i, batch)], now=now)
        emit(json.dumps({"stage": f"warmup{i - 59}", "s": time.perf_counter() - t0}))
    timers = StageTimers()
    for obj, name in ((engine, "_exact_rescore_rows"), (engine, "_kw_scores_flat"),
                      (engine, "_search_full_host"), (engine_mod, "_dd_certify_batch"),
                      (exact_cos, "finish_cosines"), (engine._device_embedder, "embed_device"),
                      (hashing, "query_bit_weights_batch"), (native, "hybrid_rescore")):
        if hasattr(obj, name):
            timers.wrap(obj, name)
    try:
        split = []
        for i in range(3):
            reqs = make_reqs(300 + i, batch)
            _sync(device)
            t0 = time.perf_counter()
            ctx = engine._dispatch_device_batch(reqs, 0, now)
            t1 = time.perf_counter()
            engine._finalize_device_batch(ctx)
            t2 = time.perf_counter()
            split.append({"dispatch_ms": (t1 - t0) * 1e3, "finalize_ms": (t2 - t1) * 1e3})
            emit(json.dumps({"stage": f"batch{i}", **split[-1]}))
        sequential = timers.dump()
        emit(json.dumps({"stage": "sequential_timers", "timers": sequential}))
        batches = [make_reqs(400 + i, batch) for i in range(groups)]
        s0 = dict(engine.stats)
        _sync(device)
        t0 = time.perf_counter()
        engine.search_batches_pipelined(batches, now=now)
        _sync(device)
        el = time.perf_counter() - t0
        pipelined = timers.dump()
    finally:
        timers.restore()
    keys = ("dd_resolved_total", "dd_escalations_total", "host_fallbacks_total",
            "escalation_rounds_total", "coarse_resolved_total", "rescore_pairs_total")
    return {"qps": groups * batch / el, "ms_per_batch": el / groups * 1e3, "split": split,
            "sequential_timers": sequential, "pipelined_timers": pipelined,
            "stats": {k: engine.stats.get(k, 0) - s0.get(k, 0) for k in keys},
            "batch": batch, "groups": groups}


def main(argv=None) -> dict:
    from omni_recall_tpu_torch.tools import localq

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=1 << 16)
    parser.add_argument("--batch", type=int, default=1536)
    parser.add_argument("--groups", type=int, default=6)
    parser.add_argument("--steps", type=int, default=localq.LQ_STEPS)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    timings: dict = {}
    t0 = time.perf_counter()
    engine, make_reqs, n, client = localq.build_localq_engine(
        args.rows, steps=args.steps, device=device, timings=timings)
    print(json.dumps({"stage": "setup", "s": time.perf_counter() - t0, "rows": n,
                      "encoder": dict(client.cfg.__dict__), **timings}), flush=True)
    out = probe(engine, make_reqs, args.batch, args.groups,
                emit=lambda line: print(line, flush=True))
    out.update(rows=n, setup=timings)
    print(json.dumps({"summary": "probe_localq", **out}), flush=True)
    return out


if __name__ == "__main__":
    main()
