"""Sweep the coarse scan's extraction layout (sub, t) on the serving path.

Counterpart of the repository's ``tools/sweep_serving_layout.py``. A deeper
extraction (larger t) costs scan time, while collision safety needs only
that no more than t of a query's top rows land in one sub-slice (past that
the certificate fails: an escalation, never an exactness loss). The sweep
measures both sides:

  stage 1  the engine's coarse entry alone (``score_topm_int8_coarse``: K1,
           or K7a at t = 1, and the merge to the top-(m+1)) per layout over
           random unit rows, four calls chained on the previous call's
           output; CUDA-event device time per call beside its bound. A
           layout the scan refuses (m > slices * t) prints its error and is
           skipped.
  stage 2  the engine over the bench's corpus (``tools/e2e_engine.py
           build_e2e_engine``) at each layout: the coarse outcome state
           reset, one warm-up batch, then ``search_batches_pipelined`` over
           g batches; QPS, ms a batch, the coarse and dd resolved shares,
           the escalation rounds and the host fallbacks.

A layout changes speed, never the certified results: ``stage2`` can hand
back each layout's served hits for comparison.

``python -m omni_recall_tpu_torch.tools.sweep_serving_layout [--n N] [--bt B]
[--g G] [--configs "1024,4;512,2;..."] [--no-stage1] [--device cpu]`` runs
on CUDA by default; prints a line a layout and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.tools import device_name
from omni_recall_tpu_torch.tools import stages as st
from omni_recall_tpu_torch.utils.profiling import median_ms

N, BT, G, D, BITS, M = 1 << 20, 1536, 3, 768, 1024, 128
CONFIGS = "1024,4;512,3;512,2;256,2;1024,3;1024,2"
CHAIN = 4  # coarse calls chained in one timed step


def parse_configs(text: str) -> list[tuple[int, int]]:
    return [tuple(int(x) for x in c.split(",")) for c in text.split(";") if c.strip()]


def stage1(n: int, bt: int, configs, d: int = D, bits: int = BITS, device="cuda",
           runs: int = 5) -> list[dict]:
    """The coarse entry's time per (sub, t) over n random unit rows, B = bt,
    keyword weights 0.025 at about 40 of the bits; the error column is zero
    (the tool's operands)."""
    from omni_recall_tpu_torch.ops import scorer

    dev = resolve_device(device)
    index = st.int8_index(n, d, 8, dev)
    emb8, scale, created, valid = index["emb"], index["scale"], index["created"], index["valid"]
    err = torch.zeros_like(scale)
    q, w, bias = st.queries(bt, d, bits, dev, seed=1, kw_density=40.0 / bits)
    records = []
    for sub, t in configs:
        def coarse(qq, sub=sub, t=t):
            return scorer.score_topm_int8_coarse(emb8, scale, err, created, valid, qq, w, bias,
                                                 st.NOW_DAYS, 0, m=M, t=t, sub=sub)

        def chain(coarse=coarse):
            # each call waits on the one before: a nonzero f32 dependency
            c = torch.zeros((bt, 1), device=dev)
            for _ in range(CHAIN):
                vals, _ = coarse(q + 1e-12 * c)
                c = vals[:, :1]
            return c

        rec = {"sub": sub, "t": t, "n": n, "bt": bt, "m": M}
        try:
            coarse(q)
        except ValueError as exc:  # a layout the scan refuses at this shape
            rec["failed"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
            print(f"  sub={sub:5d} t={t}  FAILED: {rec['failed']}", flush=True)
            records.append(rec)
            continue
        before = dict(cuda.LAUNCHES)
        ms = median_ms(chain, dev, runs, device_only=dev.type == "cuda") / CHAIN
        sub_k, t1 = scorer._coarse_shape(n, bt, t, sub, None)
        bound, by = st.bound_ms(*st.total(
            st.query_work(bt, d, bits), st.add_row_work(n), st.coarse_work(n, bt, d, sub_k, t1),
            st.merge_work(bt, n // sub_k, t1, M)))
        rec.update(ms=ms, bound_ms=bound, bound_by=by, qps=bt / ms * 1e3,
                   launches={k: v - before[k] for k, v in cuda.LAUNCHES.items()
                             if v != before[k]})
        print(f"  sub={sub:5d} t={t}  scan+merge {ms:8.3f} ms/batch  bound {bound:7.4f} ms",
              flush=True)
        records.append(rec)
    return records


def stage2(engine, make_requests, now, configs, bt: int, g: int,
           results: dict | None = None) -> list[dict]:
    """The engine at each layout (its options set in place; the caller's
    layout is put back after): pipelined certified batches. ``results`` (if
    given) receives each layout's served hits."""
    opts = engine.options
    saved = (opts.coarse_sub, opts.coarse_t)
    records = []
    try:
        for sub, t in configs:
            opts.coarse_sub, opts.coarse_t = sub, t
            engine._coarse_outcomes = []
            engine._coarse_skip_until = 0
            engine.search_batches_pipelined([make_requests(50, bt)], now=now)  # warm-up
            s0 = dict(engine.stats)
            t0 = time.perf_counter()
            outs = engine.search_batches_pipelined(
                [make_requests(300 + i, bt) for i in range(g)], now=now)
            el = time.perf_counter() - t0
            nq = g * bt
            if sum(len(h) for out in outs for h in out) != nq * 10:
                raise AssertionError(f"layout ({sub}, {t}): a query returned fewer than 10 hits")
            delta = {k: engine.stats[k] - s0[k] for k in engine.stats}
            rec = {"sub": sub, "t": t, "qps": nq / el, "ms_per_batch": el / g * 1e3,
                   "coarse_resolved": delta["coarse_resolved_total"] / nq,
                   "dd_resolved": delta["dd_resolved_total"] / nq,
                   "escalation_rounds": delta["escalation_rounds_total"],
                   "host_fallbacks": delta["host_fallbacks_total"]}
            print(f"  sub={sub:5d} t={t}  {rec['qps']:8.1f} qps  {rec['ms_per_batch']:8.1f} "
                  f"ms/batch  coarse={rec['coarse_resolved']:.4f} dd={rec['dd_resolved']:.4f} "
                  f"esc_rounds={rec['escalation_rounds']} host_fb={rec['host_fallbacks']}",
                  flush=True)
            records.append(rec)
            if results is not None:
                results[(sub, t)] = outs
    finally:
        opts.coarse_sub, opts.coarse_t = saved
        engine._coarse_outcomes = []
        engine._coarse_skip_until = 0
    return records


def main(argv=None) -> dict:
    from omni_recall_tpu_torch.tools.e2e_engine import build_e2e_engine

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N, help="corpus rows")
    ap.add_argument("--bt", type=int, default=BT, help="queries a batch")
    ap.add_argument("--g", type=int, default=G, help="timed batches a layout")
    ap.add_argument("--configs", default=CONFIGS, help='"sub,t;sub,t;..."')
    ap.add_argument("--no-stage1", action="store_true", help="skip the kernel-only stage")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    configs = parse_configs(args.configs)
    out = {"tool": "sweep_serving_layout", "device": device_name(dev), "n": args.n,
           "bt": args.bt, "g": args.g, "d": D, "bits": BITS}
    if not args.no_stage1:
        print(f"== stage 1: kernel scan+merge at n={args.n}, bt={args.bt}, m={M}", flush=True)
        out["stage1"] = stage1(args.n, args.bt, configs, device=dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(f"== stage 2: engine pipelined e2e on the bench corpus (n={args.n})", flush=True)
    engine, make_requests, now, _ = build_e2e_engine(args.n, D, BITS, device=dev)
    out["stage2"] = stage2(engine, make_requests, now, configs, args.bt, args.g)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
