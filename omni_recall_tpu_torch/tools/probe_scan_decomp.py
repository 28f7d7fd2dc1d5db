"""The coarse scan's wrapper split into its stages.

Counterpart of the repository's ``tools/probe_scan_decomp.py``, which times
each stage of ``score_topm_int8_coarse`` at (2^20, 768, B 1536, m 128, t 4,
sub 1024) in chained megasteps:

  B  ``block_topt_int8_coarse`` (K1) alone at seven layouts (sub, t):
     (1024, 4), (512, 4), (512, 2), (1024, 2), (256, 1), (512, 1), (1024, 1)
     (t = 1 is K1's two-reduce mode, K7a)
  A  ``make_add_row`` alone ([1, N] elementwise, with the error term)
  Q  ``prepare_int8_query`` + ``coarse_q_bias`` alone
  M  ``_merge_topm`` alone on the (1024, 4) emit -> top-129
  F  the whole ``score_topm_int8_coarse``

On the card each stage is timed as it is, with CUDA events (device-only) and
the host clock, beside its bound. The index is the tool's: int8 rows uniform
in [-127, 127], constant scales and error terms, created days over a year;
the queries and keyword weights come from ``np.random.default_rng(0)`` as the
tool draws them. Q, then A, then B at (1024, 4), then M is held bitwise
against F (``whole_path_equal``): the split is the wrapper.

``python -m omni_recall_tpu_torch.tools.probe_scan_decomp [--rows N]
[--device cpu]`` (CUDA by default) prints a line a stage and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import scorer
from omni_recall_tpu_torch.tools import device_name
from omni_recall_tpu_torch.tools import stages as st

N, D, BT, M, T, SUB, BITS = 1 << 20, 768, 1536, 128, 4, 1024, 1024
LAYOUTS = ((1024, 4), (512, 4), (512, 2), (1024, 2), (256, 1), (512, 1), (1024, 1))


def tool_index(n: int, d: int, device, seed: int = 0) -> dict:
    """The tool's index (probe_scan_decomp.py:57-63)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "emb1": torch.randint(-127, 128, (n, d), generator=g, device=device, dtype=torch.int8),
        "scale1": torch.full((n,), 1.0 / 127.0 / math.sqrt(d), device=device),
        "err1": torch.full((n,), 8e-3, device=device),
        "created": torch.linspace(0.0, 365.0, n, device=device),
        "valid": torch.ones((n,), dtype=torch.bool, device=device),
    }


def tool_queries(bt: int, d: int, bits: int, device, seed: int = 0):
    """(q, kw, bias) as the tool draws them (:65-69)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bt, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw = (rng.uniform(size=(bt, bits)) < 0.04).astype(np.float32) * 0.025
    return (torch.from_numpy(q).to(device), torch.from_numpy(kw).to(device),
            torch.zeros((bt,), device=device))


def main(n: int = N, d: int = D, bt: int = BT, m: int = M, t: int = T, sub: int = SUB,
         bits: int = BITS, layouts=LAYOUTS, device: str = "cuda", runs: int = 5) -> list[dict]:
    dev = resolve_device(device)
    ix = tool_index(n, d, dev)
    e1, s1, er1, cr, va = (ix[k] for k in ("emb1", "scale1", "err1", "created", "valid"))
    q, kw, bias = tool_queries(bt, d, bits, dev)

    def prep():
        q8, q_scale, eq, err_term = scorer.prepare_int8_query(q, er1)
        return q8, q_scale, err_term, scorer.coarse_q_bias(eq, kw, bias)

    def add_row(err_term):
        return scorer.make_add_row(cr, va, st.NOW_DAYS, 0, err_term=err_term)

    def block_scan(q8, ar, q_scale, q_bias, sub_i, t_i):
        return scorer.block_topt_int8_coarse(e1, q8, ar, s1[None, :], q_scale, q_bias,
                                             t=t_i, sub=sub_i)

    def whole():
        return scorer.score_topm_int8_coarse(e1, s1, er1, cr, va, q, kw, bias, st.NOW_DAYS, 0,
                                             m=m, t=t, sub=sub)

    q8, q_scale, err_term, q_bias = prep()
    ar = add_row(err_term)
    records = []
    for sub_i, t_i in layouts:
        sub_k, t1 = scorer._coarse_shape(n, bt, t_i, sub_i, None)
        records.append(st.time_stage(
            "B", f"B  block_topt sub={sub_i} t={t_i}",
            lambda sub_i=sub_i, t_i=t_i: block_scan(q8, ar, q_scale, q_bias, sub_i, t_i),
            dev, runs, st.coarse_work(n, bt, d, sub_k, t1), sub=sub_i, t=t_i))
    records.append(st.time_stage("A", "A  make_add_row alone", lambda: add_row(err_term), dev,
                                 runs, st.add_row_work(n)))
    records.append(st.time_stage("Q", "Q  prepare_int8_query + coarse_q_bias", prep, dev, runs,
                                 st.query_work(bt, d, bits)))
    vals0, idxs0 = block_scan(q8, ar, q_scale, q_bias, sub, t)
    print(f"emitted shape: {tuple(vals0.shape)}", flush=True)
    sub_k, t1 = scorer._coarse_shape(n, bt, t, sub, None)
    merge_work = st.merge_work(bt, n // sub_k, t1, m)
    records.append(st.time_stage("M", "M  _merge_topm alone",
                                 lambda: scorer._merge_topm(vals0, idxs0, m), dev, runs,
                                 merge_work))
    records.append(st.time_stage(
        "F", "F  score_topm_int8_coarse full", whole, dev, runs,
        st.total(st.query_work(bt, d, bits), st.add_row_work(n),
                 st.coarse_work(n, bt, d, sub_k, t1), merge_work)))

    q8b, q_scale_b, err_term_b, q_bias_b = prep()
    split = scorer._merge_topm(
        *block_scan(q8b, add_row(err_term_b), q_scale_b, q_bias_b, sub, t), m)
    equal = st.all_same(split, whole())
    ms = {r["label"]: r["ms"] for r in records}
    parts = ms["Q  prepare_int8_query + coarse_q_bias"] + ms["A  make_add_row alone"] + \
        ms[f"B  block_topt sub={sub} t={t}"] + ms["M  _merge_topm alone"]
    print(f"\nsum of parts Q+A+B+M = {parts:.3f} ms; F measured = "
          f"{ms['F  score_topm_int8_coarse full']:.3f} ms; split == whole: {equal}", flush=True)
    print(json.dumps({"tool": "probe_scan_decomp", "device": device_name(dev), "n": n, "d": d,
                      "b": bt, "m": m, "t": t, "sub": sub, "runs": runs,
                      "emitted_shape": list(vals0.shape), "sum_of_parts_ms": parts,
                      "whole_path_equal": equal, "records": records}), flush=True)
    if not equal:
        raise AssertionError("probe_scan_decomp: Q, A, B and M differ from the whole wrapper")
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=N)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(n=args.rows, device=args.device)
