"""One run of one cell of the port's benchmark.

    python3 -m recall_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (its file under ``recall_bench/configs/``) and a
traffic mix (``recall_bench/traffic/<mix>.json``); its limits are
``recall_bench/limits/<cell>.json`` and each metric's reader is
``recall_bench/metrics/<metric>.py``. The run makes the corpus and the
request pool from the seed, builds the port's engine over the corpus (the
configuration's ``build`` module under ``recall_bench/builds/``), warms the
cell's batch shape, and drives ``CoalescingSearchExecutor.search`` (the
served path of ``POST /api/recall/search`` without HTTP) from a closed loop
of callers, each with one request outstanding (``load.py``). After the window it
holds every answer to the plain reference (``check.py``) and prints the
numbers compared with their limits on standard error, then one JSON line
on standard output. ``--trace 1`` reports the per-layer metrics instead of
the end-to-end ones: the host's over the same window, timed by the
benchmark's own wrappers (``spans.py``), and the card's from
``torch.profiler`` over ``TRACE_S`` seconds traced after the window, under
the same load. A cell with an end-to-end metric read from the card's trace
(``device_trace``) has its whole window traced in the ``--trace 0`` run,
the profiler started before the load and exported after it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from datetime import datetime, timedelta, timezone  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from recall_bench import check, generator  # noqa: E402
from recall_bench import corpus as corpus_mod  # noqa: E402
from recall_bench import trace as trace_mod  # noqa: E402
from recall_bench.load import ClosedLoop  # noqa: E402
from recall_bench.reference import EPOCH_US, Reference  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "omni_recall_tpu"}
ANSWER_WAIT_S = 60.0
TRACE_S = 10.0      # seconds traced on the card after a traced run's window


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def load_cell(root: Path, workload: str) -> Cell:
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "recall_bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    generator.check_traffic(traffic)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, config, traffic, check.load_limits(root, workload),
                mine(bench["end_to_end"]), mine(bench["per_layer"]), int(w["chips"]))


def reader(root: Path, name: str):
    path = root / "recall_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("recall_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class RunData:
    """What a metric's reader reads."""
    window: tuple             # host clock (t0, t1)
    latencies: np.ndarray     # s, every request answered inside the window
    completed: int
    setup_s: float
    stats0: dict
    stats1: dict
    clock: object = None      # spans.HostClock in a traced run
    trace: object = None      # trace.Trace: the span after a traced run's window,
    #                           or the window itself (``trace_is_window``)
    trace_is_window: bool = False

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def profiler(torch):
    """``torch.profiler`` with its CUDA activity alone, started."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def read_trace(prof, anchors: dict, calls: list):
    """Export the stopped profiler's trace and read it (``trace.py``)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.read(path, anchors, calls)
    finally:
        os.unlink(path)


def traced_span(torch, seconds: float):
    """Trace ``seconds`` of the running load with ``torch.profiler``'s CUDA
    activity; returns the stopped profiler, not yet exported, and the clock
    anchors (``trace.py``)."""
    prof = profiler(torch)
    anchors = [trace_mod.anchor()]
    h0 = time.perf_counter()
    time.sleep(seconds)
    h1 = time.perf_counter()
    anchors.append(trace_mod.anchor())
    prof.stop()
    return prof, {"window": (h0, h1), "queries": anchors}


class FullPasses:
    """The collector's full passes (generation 2): their (start, seconds)."""

    def __init__(self):
        self.passes: list = []
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] == 2:
            if phase == "start":
                self._t = time.perf_counter()
            else:
                self.passes.append((self._t, time.perf_counter() - self._t))

    def within(self, lo: float, hi: float) -> tuple[int, float]:
        mine = [s for t, s in self.passes if lo <= t < hi]
        return len(mine), float(sum(mine))


def run(root: Path, cell: Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", patch=None) -> dict:
    """One run; returns the result line (a dict). ``patch(engine)``, when
    given, is called on the built engine (the tests plant faults so)."""
    import torch

    from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor

    t = cell.traffic
    corpus = corpus_mod.make_corpus(cell.config["corpus"], seed)
    pool = generator.make_requests(t, corpus, seed)
    now = datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(
        microseconds=EPOCH_US + int(round(corpus.days * 1000)) * 86_400_000)
    build = importlib.import_module(f"recall_bench.builds.{cell.config['build']}")
    engine, answer = build.build(cell.config, corpus, device)
    if patch is not None:
        patch(engine)
    warm = pool[: t["max_batch"]]
    for _ in range(2):
        engine.search_batch(warm, now=now)
    if device == "cuda":
        torch.cuda.synchronize()

    # a device-trace end-to-end metric is read over the whole window: the
    # profiler starts before the load, so its start counts as set-up
    window_prof = None
    if not traced and device == "cuda" and any(
            m["source"] == "device_trace" for m in cell.end_to_end):
        window_prof = profiler(torch)

    ex = CoalescingSearchExecutor(engine, max_batch=t["max_batch"], window_ms=t["window_ms"],
                                  pipeline_depth=t["pipeline_depth"])
    clock = remove_spans = None
    if traced:
        from recall_bench import spans
        clock = spans.HostClock()
        remove_spans = spans.install(engine, clock)
    loop = ClosedLoop(ex, pool, t["clients"], now, answer, t["top_k"])
    full = FullPasses()
    gc.callbacks.append(full)
    loop.start()
    time.sleep(t["ramp_s"])
    if window_prof is not None:
        window_anchors = {"queries": [trace_mod.anchor()]}
    stats0, cpu0, t0 = dict(engine.stats), time.process_time(), time.perf_counter()
    cb0, hs0 = loop.callback_s, loop.harness_s
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1, cpu1, stats1 = time.perf_counter(), time.process_time(), dict(engine.stats)
    cb1, hs1 = loop.callback_s, loop.harness_s
    if window_prof is not None:
        window_anchors["queries"].append(trace_mod.anchor())
        window_anchors["window"] = (t0, t1)
        window_prof.stop()
    prof = anchors = None
    if traced and device == "cuda":
        # the card is traced after the window, under the same load, so the
        # profiler's start, stop and export never fall inside the window
        prof, anchors = traced_span(torch, TRACE_S)
    loop.stop(timeout=max(0.0, t1 + ANSWER_WAIT_S - time.perf_counter()))
    gc.callbacks.remove(full)
    if traced:
        remove_spans()
    mem_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0

    # requests and timings
    cols = loop.answers.columns()
    good = cols["hits"] >= 0 if cols else np.zeros(0, bool)
    sent = cols.get("sent", np.zeros(0))
    done = cols.get("done", np.zeros(0))
    in_window = good & (done >= t0) & (done <= t1)
    lat = done[in_window] - sent[in_window]
    attempted = int(np.sum((sent >= t0) & (sent < t1)))
    failed = int(np.sum(~good & (sent >= t0) & (sent < t1)))
    late = sum(1 for _, ts in list(loop.pending.values()) if ts < t1)
    attempted += late
    failed += late
    by_second = np.bincount(((done[in_window] - t0) // 1.0).astype(np.int64),
                            minlength=int(seconds)).tolist()
    data = RunData(window=(t0, t1), latencies=lat, completed=int(lat.size),
                   setup_s=t0 - T_PROCESS, stats0=stats0, stats1=stats1, clock=clock)
    if prof is not None:
        data.trace = read_trace(prof, anchors, clock.calls)
        del prof
    elif window_prof is not None:    # the trace covers the window itself
        data.trace = read_trace(window_prof, window_anchors, [])
        data.trace_is_window = True
        del window_prof

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(root, m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": mem_peak}
    breakdown = None
    if traced and data.trace is not None:
        dev["busy_s"] = data.trace.busy_s()
        dev["window_s"] = data.trace.window_s
        breakdown = {"device_ops": trace_mod.top_device_ops(data.trace),
                     "idle_gaps": trace_mod.idle_by_host(data.trace, "dispatch", "finalize")}

    loop_errors = dict(loop.answers.errors)
    # the program's state goes before the reference runs
    ex.close()
    del ex, engine, loop
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ref = Reference(corpus)
    k = t["top_k"]
    sample = check.draw_sample(seed, cols["q"][good].tolist() if cols else [], t["sample"])
    reqs = [(pool[q][0], pool[q][1]) for q in sample]
    expected = dict(zip(sample, ref.top_k(reqs, k)))
    values = {"row_gap": check.row_gap(ref, [(r[0], r[1]) for r in pool], cols, k),
              "rank_gap": check.rank_gap(expected, cols, k),
              "unanswered": float(failed)}
    correct, checks = check.judge(values, cell.limits)
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["stats"] = {key: stats1[key] - stats0[key] for key in stats1}
    n_full, full_s = full.within(t0, t1)
    batches = max(1, stats1["searches_total"] - stats0["searches_total"]) / t["max_batch"]
    out["stats"].update({
        "window_qps": data.completed / data.window_s,
        "answers_by_second": by_second,
        "gc_full_passes": n_full, "gc_full_s": full_s,
        "process_cpu_s": cpu1 - cpu0,
        "callback_ms_per_batch": 1e3 * (cb1 - cb0) / batches,
        "harness_ms_per_batch": 1e3 * (hs1 - hs0) / batches})
    if data.trace_is_window:
        out["stats"]["window_busy_s"] = data.trace.busy_s()
    if anchors is not None:
        h0, h1 = anchors["window"]
        out["stats"]["traced_span_qps"] = float(np.sum(good & (done >= h0) & (done <= h1))
                                                / (h1 - h0))
    out["stats"]["first_errors"] = sorted(loop_errors.items())[:3]
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"recall_bench: needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run(root, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"recall_bench: the run loaded {bad}", file=sys.stderr)
        return 4
    print("stats " + json.dumps(out.pop("stats")), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
