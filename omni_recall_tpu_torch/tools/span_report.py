"""Where the served path's host time goes, read from the program's own spans.

Serves a closed loop of callers through ``CoalescingSearchExecutor`` over the
bench's corpus (``tools/e2e_engine.py``) with the span recorder on
(``utils/tracing.py``), and breaks a window of it down by span, batch and
thread (``summarize``):

- ``spans``: each name's count and mean wall, thread CPU and self time
  (wall less its children's), in ms;
- ``host_gc_pct``: the collector's passes (``runtime.gc``, merged) as a
  share of the window; ``gc``: passes by generation, objects collected;
- ``host_stall_pct``: of the stages' own host time (``engine.dispatch`` and
  ``engine.finalize``, each less its ``finalize.wait`` descendants), the
  share spent off the CPU: waiting for the interpreter lock, or stopped by
  another thread's collector pass;
- ``finalize_wait_ms``: the host blocked on the card's results, a finalize;
- ``batch_wait_ms``: a dispatched batch's wait for the pipeline with no
  work done on it (``coalesce.inflight_wait`` + ``coalesce.finalize_queue``);
- ``batches``: the coalescer's fill and the backlog left queued at close;
  ``dispatch``: queries, host-only and device-embedded ones; ``finalize``:
  each per-batch count's total and the batches it touched; ``scans``: each
  scan shape's count, mean batch and mean ms;
- ``threads``: each thread's busy share (its outermost spans, merged) and
  CPU share (over its outermost spans).

The callers are threads blocked in ``search``, as the server's request
threads are. ``site_cost_us`` times one batch's span sites (17 spans) with
the recorder off and on.

``python -m omni_recall_tpu_torch.tools.span_report [--engine int8|xla]
[--n N] [--callers C] [--max-batch B] [--seconds S] [--warmup S] [--seed N]
[--device cpu]`` runs on CUDA by default (``int8``: the bench's headline
options; ``xla``: the reference's default options over f32 storage) and
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import numpy as np

from omni_recall_tpu_torch.utils import tracing as tr

STAGES = (tr.DISPATCH, tr.FINALIZE)


def _merged_s(starts, ends, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of the intervals."""
    s, e = np.clip(starts, lo, hi), np.clip(ends, lo, hi)
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(zip(s.tolist(), e.tolist())):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _ancestor(parent: np.ndarray, name: np.ndarray, targets) -> np.ndarray:
    """Each row's nearest ancestor whose name is in ``targets``, else -1."""
    out = np.full(len(parent), -1, np.int64)
    anc = parent.copy()
    while (anc >= 0).any():
        live = anc >= 0
        at = np.where(live, anc, 0)
        hit = live & np.isin(name[at], targets)
        out[hit] = anc[hit]
        anc = np.where(live & ~hit, parent[at], -1)
    return out


def summarize(rec: dict, t0: float | None = None, t1: float | None = None) -> dict:
    """The breakdown of ``tracing.records()`` over the spans that started in
    [t0, t1) (default: all of them); see the module's docstring."""
    name, parent, batch, attrs = rec["name"], rec["parent"], rec["batch"], rec["attrs"]
    start, end, cpu, thread = rec["start"], rec["end"], rec["cpu"], rec["thread"]
    out = {"dropped": int(rec["dropped"]), "spans": {}}
    closed = (name >= 0) & ~np.isnan(end)
    if not closed.any():
        return out
    lo = float(start[closed].min()) if t0 is None else t0
    hi = float(end[closed].max()) if t1 is None else t1
    win = closed & (start >= lo) & (start < hi)
    out["window_s"] = hi - lo
    wall = np.where(closed, end - start, 0.0)
    kids = np.flatnonzero(closed & (parent >= 0))
    child_wall = np.zeros(len(name))
    np.add.at(child_wall, parent[kids], wall[kids])
    is_ = {i: win & (name == i) for i in range(len(tr.NAMES))}
    for i, nm in enumerate(tr.NAMES):
        m = is_[i]
        if m.any():
            out["spans"][nm] = {"count": int(m.sum()),
                                "wall_ms": 1e3 * float(wall[m].mean()),
                                "cpu_ms": 1e3 * float(cpu[m].mean()),
                                "self_ms": 1e3 * float((wall[m] - child_wall[m]).mean())}

    g = is_[tr.GC]
    out["host_gc_pct"] = 100.0 * _merged_s(start[g], end[g], lo, hi) / (hi - lo)
    gens = attrs[g, 0]
    out["gc"] = {"passes": {str(k): int((gens == k).sum()) for k in np.unique(gens)},
                 "collected": int(attrs[g, 1].sum())}

    stage = is_[tr.DISPATCH] | is_[tr.FINALIZE]
    waits = np.flatnonzero(closed & (name == tr.WAIT))
    owner = _ancestor(parent, name, STAGES)[waits]
    mine = owner >= 0
    waits, owner = waits[mine], owner[mine]
    counted = stage[owner]
    own_wall = wall[stage].sum() - wall[waits[counted]].sum()
    own_cpu = cpu[stage].sum() - cpu[waits[counted]].sum()
    out["host_stall_pct"] = (100.0 * (1.0 - own_cpu / own_wall) if own_wall > 0 else None)
    fin = is_[tr.FINALIZE]
    fin_waits = waits[counted & (name[owner] == tr.FINALIZE)]
    out["finalize_wait_ms"] = (1e3 * wall[fin_waits].sum() / fin.sum() if fin.any() else None)

    queued = np.flatnonzero(is_[tr.FINALIZE_QUEUE])
    if queued.size:
        qb = batch[queued]
        inflight = closed & (name == tr.INFLIGHT_WAIT) & np.isin(batch, qb)
        out["batch_wait_ms"] = 1e3 * (wall[queued].sum() + wall[inflight].sum()) / queued.size

    c = is_[tr.COLLECT]
    if c.any():
        fill, cap, backlog = attrs[c, 0], attrs[c, 1], attrs[c, 2]
        out["batches"] = {"count": int(c.sum()), "fill_mean": float(fill.mean()),
                          "fill_share": float((fill / cap).mean()), "max_batch": int(cap.max()),
                          "backlog_mean": float(backlog.mean()), "backlog_max": int(backlog.max())}
    for key, i in (("dispatch", tr.DISPATCH), ("finalize", tr.FINALIZE)):
        m = is_[i]
        if m.any():
            out[key] = {a: {"total": int(attrs[m, j].sum()), "batches": int((attrs[m, j] > 0).sum())}
                        for j, a in enumerate(tr.ATTRS[tr.NAMES[i]])}
    out["scans"] = {}
    for i in (tr.SCAN_K1, tr.SCAN_XLA):
        keys = tr.ATTRS[tr.NAMES[i]]
        rows = np.flatnonzero(is_[i])
        shape_cols = [j for j, k in enumerate(keys) if k != "b"]   # the batch varies
        shapes = attrs[rows][:, shape_cols]
        for shape in np.unique(shapes, axis=0):
            m = rows[(shapes == shape).all(axis=1)]
            label = tr.NAMES[i] + ":" + ",".join(
                f"{keys[j]}={v}" for j, v in zip(shape_cols, shape))
            out["scans"][label] = {"count": int(m.size),
                                   "b_mean": float(attrs[m, keys.index("b")].mean()),
                                   "wall_ms": 1e3 * float(wall[m].mean())}

    out["threads"] = {}
    names = rec["threads"]
    roots = win & (parent < 0)
    for ident in np.unique(thread[roots & (name != tr.GC)]):
        m = roots & (thread == ident)
        label = names.get(int(ident), str(int(ident)))
        busy = _merged_s(start[m], end[m], lo, hi)
        out["threads"][label] = {"busy_pct": 100.0 * busy / (hi - lo),
                                 "cpu_pct": 100.0 * float(cpu[m].sum()) / (hi - lo)}
    return out


def _one_batch() -> None:
    """The span sites one int8 batch passes through, in order."""
    with tr.span(tr.COLLECT, tr.new_batch()) as sp:
        if sp:
            sp.set(448, 448, 0)
    with tr.span(tr.INFLIGHT_WAIT):
        pass
    with tr.span(tr.DISPATCH) as sp:
        sp.step(tr.PREP)
        sp.step(tr.UPLOAD)
        sp.step(tr.LAUNCH)
        with tr.span(tr.SCAN_K1) as k:
            if k:
                k.set(1 << 20, 768, 448, 1024, 2, 128)
        if sp:
            sp.set(448, 0, 0)
    tr.add(tr.FINALIZE_QUEUE, time.perf_counter(), -1)
    with tr.span(tr.FINALIZE) as sp:
        for step in (tr.WAIT, tr.WAIT, tr.RESCORE):
            with tr.span(step):
                pass
        with tr.span(tr.CERTIFY):
            with tr.span(tr.WAIT):
                pass
        for step in (tr.RESCORE, tr.CERTIFY):
            with tr.span(step):
                pass
        sp.set(0, 0, 1, 0, 0, 14336)
    with tr.span(tr.RESOLVE):
        pass


def site_cost_us(n_off: int = 20000, n_on: int = 4000, reps: int = 7) -> dict:
    """Median microseconds of one batch's 17 span sites, recorder off and on
    (the recorder's state is off afterwards)."""
    def per_batch(n):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                _one_batch()
            out.append((time.perf_counter() - t0) / n * 1e6)
        return statistics.median(out)

    tr.disable()
    off = per_batch(n_off)
    tr.enable(reps * n_on * 20)
    try:
        on = per_batch(n_on)
        spans = len(tr.records()["name"]) / (reps * n_on)
    finally:
        tr.disable()
    return {"off": off, "on": on, "spans": spans}


def serve(engine, requests, now, *, callers: int, max_batch: int, seconds: float,
          warmup_s: float) -> dict:
    """A closed loop of ``callers`` threads for ``warmup_s`` + ``seconds``,
    with the recorder on throughout; the last ``seconds`` are summarized."""
    from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor

    ex = CoalescingSearchExecutor(engine, max_batch=max_batch, window_ms=2.0, pipeline_depth=2)
    stop, measuring = threading.Event(), threading.Event()
    done = [0] * callers
    errors: list = []

    def caller(c):
        i = c
        try:
            while not stop.is_set():
                text, q, k = requests[i % len(requests)]
                ex.search(text, q, k, now)
                if measuring.is_set() and not stop.is_set():
                    done[c] += 1
                i += callers
        except Exception as exc:   # reported, and the loop stops
            errors.append(repr(exc))
            stop.set()

    tr.enable()
    threads = [threading.Thread(target=caller, args=(c,), name=f"caller-{c}")
               for c in range(callers)]
    try:
        for th in threads:
            th.start()
        stop.wait(warmup_s)
        t0 = time.perf_counter()
        measuring.set()
        stop.wait(seconds)
        t1 = time.perf_counter()
        stop.set()
        for th in threads:
            th.join()
        ex.close()
        rec = tr.records()
    finally:
        stop.set()
        tr.disable()
    if errors:
        raise RuntimeError(f"{len(errors)} callers failed, first: {errors[0]}")
    return {"qps": sum(done) / (t1 - t0), **summarize(rec, t0, t1)}


def main(argv=None) -> dict:
    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.device import resolve_device
    from omni_recall_tpu_torch.tools import device_name
    from omni_recall_tpu_torch.tools.e2e_engine import build_e2e_engine

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--engine", choices=("int8", "xla"), default="int8")
    parser.add_argument("--n", type=int, default=1 << 20)
    parser.add_argument("--callers", type=int, default=896)
    parser.add_argument("--max-batch", type=int, default=448)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--warmup", type=float, default=5.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    d, bits = 768, 1024
    options = None
    if args.engine == "xla":
        options = EngineOptions(embedding_dim=d, recent_window=0, candidate_m=128,
                                bloom_bits=bits)
    cost = site_cost_us()
    t0 = time.perf_counter()
    engine, make_requests, now, _ = build_e2e_engine(args.n, d, bits, device=dev,
                                                     options=options)
    requests = make_requests(args.seed, 8192)
    engine.search_batch(requests[:args.max_batch], now=now)   # builds the kernels
    setup_s = time.perf_counter() - t0
    out = {"device": device_name(dev), "engine": args.engine, "n": args.n,
           "callers": args.callers, "max_batch": args.max_batch, "setup_s": setup_s,
           "site_cost_us": cost,
           **serve(engine, requests, now, callers=args.callers, max_batch=args.max_batch,
                   seconds=args.seconds, warmup_s=args.warmup)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
