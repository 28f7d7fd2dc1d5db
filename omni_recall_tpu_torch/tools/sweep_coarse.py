"""K1's coarse entry swept over (batch, block, sub).

Counterpart of the repository's ``tools/sweep_coarse.py``, which times
``block_topt_int8_coarse`` at 2^20 x 768, t = 1, over B in {448, 512, 768,
1024}, block in {1024, 2048} and sub in {512, 1024} (sub <= block), each
scan with its query quantization, q_bias = 0.7 eq + 0.2 and the top-128
merge of its candidates (the tool's ``topk`` merge mode), chained in
megasteps with one readback. On the card each configuration's stages are
timed as they are:

  K1     ``block_topt_int8_coarse`` at t = 1 (K1's two-reduce mode, K7a)
  merge  ``top_k_with_payload`` of its candidates to 128, alone
  scan   query quantization + K1 + the merge: the tool's timed step

each with CUDA events (device-only) and the host clock, beside its bound;
``qps`` = B / scan. The merge of K1's output is held bitwise against the
scan's (``whole_path_equal``). K1 has no row block of its own (its tiles
are 128 rows): ``block`` only caps sub, as it does in the engine's layout,
so the two blocks time the same launch.

``python -m omni_recall_tpu_torch.tools.sweep_coarse [--rows N] [--device cpu]``
(CUDA by default) prints a line a stage and one JSON line.
"""

from __future__ import annotations

import argparse
import json

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import scorer
from omni_recall_tpu_torch.ops.merge import top_k_with_payload
from omni_recall_tpu_torch.tools import device_name
from omni_recall_tpu_torch.tools import stages as st

N, D, TOP = 1 << 20, 768, 128
BATCHES = (448, 512, 768, 1024)
BLOCKS = (1024, 2048)
SUBS = (512, 1024)


def configs(batches=BATCHES, blocks=BLOCKS, subs=SUBS) -> list[tuple[int, int, int]]:
    return [(b, block, sub) for b in batches for block in blocks for sub in subs
            if sub <= block]


def main(n: int = N, d: int = D, grid=None, top: int = TOP, device: str = "cuda",
         runs: int = 5) -> list[dict]:
    dev = resolve_device(device)
    index = st.int8_index(n, d, 8, dev)
    emb8, scale = index["emb"], index["scale"]
    add_row = scorer.make_add_row(index["created"], index["valid"], st.NOW_DAYS, 0)
    records = []
    for b, block, sub in grid or configs():
        q, _, _ = st.queries(b, d, 8, dev, seed=b)

        def k1_of(q8, q_scale, q_bias, block=block, sub=sub):
            return scorer.block_topt_int8_coarse(emb8, q8, add_row, scale[None, :], q_scale,
                                                 q_bias, t=1, sub=sub, block=block)

        def merge(vals, idxs):
            bb, nb, t1 = vals.shape
            return top_k_with_payload(vals[:, :, : t1 - 1].reshape(bb, -1),
                                      idxs[:, :, : t1 - 1].reshape(bb, -1), top)

        def prep(q=q):
            q8, q_scale, eq = scorer.quantize_queries_int8(q)
            return q8, q_scale, scorer.COSINE_WEIGHT * eq + 0.2

        def scan():
            return merge(*k1_of(*prep()))

        ops = prep()
        emitted = k1_of(*ops)
        sub_k, t1 = scorer._coarse_shape(n, b, 1, sub, block)
        k1_work = st.coarse_work(n, b, d, sub_k, t1)
        merge_work = st.merge_work(b, n // sub_k, t1, top)
        tag = f"B={b:4d} block={block:5d} sub={sub:4d}"
        rec = st.time_stage("K1", f"K1 {tag}", lambda: k1_of(*ops), dev, runs, k1_work,
                            b=b, block=block, sub=sub)
        parts = {"merge": st.time_stage("merge", f"merge {tag}", lambda: merge(*emitted), dev,
                                        runs, merge_work),
                 "scan": st.time_stage("scan", f"scan {tag}", scan, dev, runs, st.total(
                     st.query_work(b, d, 0), k1_work, merge_work))}
        rec.update({name: {k: p[k] for k in ("ms", "host_ms", "bound_ms", "bound_by",
                                             "launches")} for name, p in parts.items()})
        rec["qps"] = b / parts["scan"]["ms"] * 1e3
        rec["whole_path_equal"] = st.all_same(merge(*emitted), scan())
        if not rec["whole_path_equal"]:
            raise AssertionError(f"sweep_coarse {tag}: K1 merged differs from the scan")
        records.append(rec)
        del emitted, ops
    print(json.dumps({"tool": "sweep_coarse", "device": device_name(dev), "n": n, "d": d,
                      "top": top, "runs": runs, "records": records}), flush=True)
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=N)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(n=args.rows, device=args.device)
