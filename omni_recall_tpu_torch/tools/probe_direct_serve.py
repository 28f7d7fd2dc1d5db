"""The serving pipeline's variants at 2^20 x 768, B 1536: the coarse scan,
the refine selection, the direct selection and the device-exact cosine.

Counterpart of the repository's ``tools/probe_direct_serve.py``, which times
in chained megasteps, at each extraction layout (sub, t) in {(1024, 2),
(512, 2), (1024, 1)}:

  S    scan + merge (``score_topm_int8_coarse``, m = 128: K1)
  A    S + ``refine_select_from_scan`` (r = 64, t_out = 32: K3) +
       ``exact_cos_rows`` (K2): the refine path
  B    S + ``direct_select_from_scan`` (t_out = 32, then 16) + K2: the
       direct selection (Engine:DirectSelect)

and, with its ``PROBE_DECOMP`` switch, the split of B's select + DD cost:

  Sm   S at m = 33 and 64
  Bn   B at t_out = 32 without K2
  Bg   B with K2 replaced by the gather of the slice's raw rows alone
  B33  S at m = 33 + the direct selection at 32 + K2

On the card every stage (the split included) is timed as it is, with CUDA
events (device-only) and the host clock, beside its bound, and ``DD`` times
K2 alone on B's slice. The tool's packed-emit variant ``SK`` is S here: K1
takes its packed keys wherever the layout allows (ops/scorer.py
``_packed_mode``); its transposed-key emit (``PROBE_EMIT_T``) is T4's
(tools/probe_keys_emit.py), not a serving kernel, and is left out. The
planes are unit normal rows quantized with the residual plane
(``device_quantize``), the raw f32 rows beside them (about 4.5 GiB at 2^20 x
768 in all), sparse bloom bytes (the AND of two draws), created days over a
year; queries unit normal with keyword weights 0.025 at 40 of 1024 bits.

Held bitwise (``whole_path_equal``): A against S's output refine-selected
and DD'd, B against S's output direct-selected and DD'd, and B33's slice
and cosines against B's at t_out = 32 (the first 32 of a stable co-sort of
the same candidates).

``python -m omni_recall_tpu_torch.tools.probe_direct_serve [--rows N]
[--device cpu]`` (CUDA by default) prints a line a stage and one JSON line.
"""

from __future__ import annotations

import argparse
import json

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import refine, scorer
from omni_recall_tpu_torch.ops.exact_cos import exact_cos_rows
from omni_recall_tpu_torch.tools import device_name
from omni_recall_tpu_torch.tools import stages as st

N, D, BT, BITS, M = 1 << 20, 768, 1536, 1024, 128
LAYOUTS = ((1024, 2), (512, 2), (1024, 1))
R, T_OUTS, SPLIT_MS = 64, (32, 16), (33, 64)


def main(n: int = N, d: int = D, bt: int = BT, bits: int = BITS, m: int = M,
         layouts=LAYOUTS, device: str = "cuda", runs: int = 5) -> list[dict]:
    dev = resolve_device(device)
    w = bits // 8
    ix = st.int8_index(n, d, bits, dev, refine=True, raw=True, sparse_bloom=True)
    e1, s1, er1, e2, s2, er2, bl, cr, va, raw = (ix[k] for k in (
        "emb", "scale", "err", "emb2", "scale2", "err2", "bloom", "created", "valid", "raw"))
    q, kw, bias = st.queries(bt, d, bits, dev, kw_density=40.0 / bits)

    def scan(sub, t, m_=m):
        return scorer.score_topm_int8_coarse(e1, s1, er1, cr, va, q, kw, bias, st.NOW_DAYS, 0,
                                             m=m_, t=t, sub=sub)

    def refine_sel(vals, idxs):
        return refine.refine_select_from_scan(e1, s1, e2, s2, er2, bl, cr, va, q, kw, bias,
                                              st.NOW_DAYS, vals, idxs, t_out=32, r=R)

    def dd(sel):
        # the slice is a column view of the scan's [B, m+1] rows; K2 takes
        # its rows contiguous, as the engine hands them over
        return exact_cos_rows(raw, sel[0].contiguous(), q)

    def path_a(sub, t):
        sel = refine_sel(*scan(sub, t))
        return (*sel, *dd(sel))

    def path_b(sub, t, t_out, m_=m, with_dd=True):
        sel = refine.direct_select_from_scan(*scan(sub, t, m_), t_out)
        return (*sel, *dd(sel)) if with_dd else sel

    def path_bg(sub, t):
        sel = refine.direct_select_from_scan(*scan(sub, t), 32)
        return sel, raw[sel[0].clamp_min(0).reshape(-1).long()]

    records, checks = [], {}
    for sub, t in layouts:
        label = f"(sub={sub}, t={t})"
        sub_k, t1 = scorer._coarse_shape(n, bt, t, sub, None)

        def s_work(m_, sub_k=sub_k, t1=t1):
            return st.total(st.query_work(bt, d, bits), st.add_row_work(n),
                            st.coarse_work(n, bt, d, sub_k, t1),
                            st.merge_work(bt, n // sub_k, t1, m_))

        vals, idxs = scan(sub, t)
        uniq = st.unique_rows(idxs[:, :R])
        stage = lambda name, lab, fn, work, **kw_: records.append(  # noqa: E731
            st.time_stage(name, f"{lab} {label}", fn, dev, runs, work, sub=sub, t=t, **kw_))
        stage("S", "S  scan+merge", lambda: scan(sub, t), s_work(m))
        stage("A", f"A  refine_select(r={R})+DD", lambda: path_a(sub, t), st.total(
            s_work(m), st.refine_work(bt, R, d, w, uniq), st.select_work(bt, R, 33),
            st.dd_work(bt, 32, d)))
        for t_out in T_OUTS:
            stage("B", f"B  direct_select(t_out={t_out})+DD",
                  lambda t_out=t_out: path_b(sub, t, t_out),
                  st.total(s_work(m), st.dd_work(bt, t_out, d)), t_out=t_out)
        sel32 = refine.direct_select_from_scan(vals, idxs, 32)
        stage("DD", "DD exact_cos_rows(t=32) alone (K2)", lambda: dd(sel32),
              st.dd_work(bt, 32, d))
        for m_ in SPLIT_MS:
            stage("Sm", f"Sm scan+merge(m={m_})", lambda m_=m_: scan(sub, t, m_), s_work(m_),
                  m=m_)
        stage("Bn", "Bn direct_select(32), no DD",
              lambda: path_b(sub, t, 32, with_dd=False), s_work(m))
        stage("Bg", "Bg + DD gather only", lambda: path_bg(sub, t),
              st.total(s_work(m), st.gather_work(bt * 32, 4 * d)))
        stage("B33", "B33 merge(m=33)+direct_select(32)+DD",
              lambda: path_b(sub, t, 32, m_=33), st.total(s_work(33), st.dd_work(bt, 32, d)))

        sel_a = refine_sel(vals, idxs)
        b32 = path_b(sub, t, 32)
        checks[label] = {
            "A": st.all_same((*sel_a, *dd(sel_a)), path_a(sub, t)),
            "B": st.all_same((*sel32, *dd(sel32)), b32),
            "B33_slice": st.all_same((b32[0], b32[1], *b32[3:]),
                                     (lambda x: (x[0], x[1], *x[3:]))(path_b(sub, t, 32, 33))),
        }
        del vals, idxs, sel32, sel_a, b32
    equal = all(all(c.values()) for c in checks.values())
    print(json.dumps({"tool": "probe_direct_serve", "device": device_name(dev), "n": n, "d": d,
                      "b": bt, "bits": bits, "m": m, "runs": runs, "checks": checks,
                      "whole_path_equal": equal, "records": records}), flush=True)
    if not equal:
        raise AssertionError(f"probe_direct_serve: a split differs from its path ({checks})")
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=N)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(n=args.rows, device=args.device)
