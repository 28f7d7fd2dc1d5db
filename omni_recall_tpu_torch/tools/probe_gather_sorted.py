"""Does index order change the rate of the refine candidates' row gather?

Counterpart of the repository's ``tools/probe_gather_sorted.py``, which asks
whether SORTING the flat [B*m] candidate rows before the gather (and
un-permuting the gathered slabs after it) beats a gather in random order.
At 2^19 rows, B 1536, m 64, over the refine stage's per-row traffic at the
default configuration (both int8 planes of 768, the bloom plane at 2048
bits: 256 bytes a row, and a [N, 5] f32 sidecar), each timed as it is with
CUDA events (device-only) and the host clock, beside its bound:

  R   the four gathers in random row order
  S   the same gathers with the rows sorted first (sort excluded)
  SF  argsort + the sorted gathers + the un-permute of every slab (the
      real candidate)

The tool runs SF only where S beats R by 15%; here it always runs, and SF's
slabs are held bitwise against R's (``whole_path_equal``: the sort is a pure
permutation). No kernel of the repository: the gathers are PyTorch's
``index_select``.

``python -m omni_recall_tpu_torch.tools.probe_gather_sorted [--rows N]
[--device cpu]`` (CUDA by default) prints a line a stage and one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.tools import device_name
from omni_recall_tpu_torch.tools import stages as st

N, D, W, W5, BT, M = 1 << 19, 768, 256, 5, 1536, 64


def main(n: int = N, d: int = D, w: int = W, bt: int = BT, m: int = M, device: str = "cuda",
         runs: int = 5) -> list[dict]:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    planes = (
        torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8),
        torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8),
        torch.randint(0, 256, (n, w), generator=g, device=dev, dtype=torch.uint8),
        torch.randn((n, W5), generator=g, device=dev),
    )
    bm = bt * m
    rng = np.random.default_rng(0)
    idx_r = torch.from_numpy(rng.integers(0, n, size=(bm,)).astype(np.int64)).to(dev)
    idx_s = torch.sort(idx_r).values

    def gathers(idx):
        return tuple(p.index_select(0, idx) for p in planes)

    def sorted_full():
        order = torch.argsort(idx_r)
        slabs = gathers(idx_r[order])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(bm, device=dev)
        return tuple(s.index_select(0, inv) for s in slabs)

    row_bytes = 2 * d + w + 4 * W5
    work = st.gather_work(bm, row_bytes)
    records = [
        st.time_stage("R", "R : random gather", lambda: gathers(idx_r), dev, runs, work),
        st.time_stage("S", "S : sorted gather", lambda: gathers(idx_s), dev, runs, work),
        # SF also reads and writes every slab once more (the un-permute)
        st.time_stage("SF", "SF: sort+gather+unperm", sorted_full, dev, runs,
                      (2 * work[0] + 16.0 * bm, 0.0, work[2])),
    ]
    for r in records:
        r["gb_per_s"] = bm * row_bytes / r["ms"] / 1e6
    equal = st.all_same(sorted_full(), gathers(idx_r))
    print(json.dumps({"tool": "probe_gather_sorted", "device": device_name(dev), "n": n,
                      "d": d, "w": w, "b": bt, "m": m, "runs": runs,
                      "sorted_over_random": records[1]["ms"] / records[0]["ms"],
                      "whole_path_equal": equal, "records": records}), flush=True)
    if not equal:
        raise AssertionError("probe_gather_sorted: the un-permuted sorted gather differs")
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=N)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(n=args.rows, device=args.device)
