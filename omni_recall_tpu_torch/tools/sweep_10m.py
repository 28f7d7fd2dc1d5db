"""K1 over the compact 10M store, swept over the batch and K1's layouts.

Counterpart of the repository's ``tools/sweep_10m.py``, which builds the
10 x 2^20-row int8 index once and times the coarse scan (K1 + the merge to
the top-m) at several (B, sub, block). The port sweeps K1's own layouts,
(sub, t) in {512, 1024} x {2, 4}, at B in {448, 896, 1536} over the planes
of a compact store (``index/compact.py build_compact_engine``):

  k1_ms    K1 alone on prepared operands (``block_topt_int8_coarse``)
  scan_ms  the engine's coarse entry (``score_topm_int8_coarse``: query
           quantization, the per-row add term, K1 and the merge to m = 128)
  qps      B / scan_ms

each the median of ``runs`` CUDA-event timed calls after a warm-up (host
clock on the CPU). ``sweep(planes, now_days)`` runs on planes already
built (``chip_smoke.py``'s compact path passes its own);
``python -m omni_recall_tpu_torch.tools.sweep_10m [--rows N] [--m M]
[--device cpu] [B,sub,t ...]`` builds the store first. Prints one JSON line a
configuration and a summary line.
"""

from __future__ import annotations

import argparse
import json

import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.tools import device_name, median_ms

BATCHES = (448, 896, 1536)
LAYOUTS = ((512, 2), (512, 4), (1024, 2), (1024, 4))
DEFAULT_CONFIGS = [(b, sub, t) for b in BATCHES for sub, t in LAYOUTS]


def sweep(planes, now_days: float, configs=DEFAULT_CONFIGS, m: int = 128, runs: int = 5,
          seed: int = 7) -> list[dict]:
    """Time each (B, sub, t) over ``planes`` (DeviceArrays of an int8 index:
    emb, scale, err, created, valid, bloom)."""
    from omni_recall_tpu_torch.ops import scorer

    dev = planes.emb.device
    n, d = planes.emb.shape
    bits = 8 * planes.bloom.shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for b, sub, t in configs:
        q = torch.randn((b, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        kw_w = torch.zeros((b, bits), device=dev)
        kw_b = torch.zeros((b,), device=dev)
        q8, q_scale, eq, err_term = scorer.prepare_int8_query(q, planes.err)
        add_row = scorer.make_add_row(planes.created, planes.valid, now_days, 0,
                                      err_term=err_term)
        q_bias = scorer.coarse_q_bias(eq, kw_w, kw_b)
        scale_row = planes.scale[None, :]
        rec = {"b": b, "sub": sub, "t": t, "rows": n, "dim": d, "m": m}
        try:
            rec["k1_ms"] = median_ms(lambda: scorer.block_topt_int8_coarse(  # noqa: B023
                planes.emb, q8, add_row, scale_row, q_scale, q_bias, t=t, sub=sub),
                dev, runs=runs)
            rec["scan_ms"] = median_ms(lambda: scorer.score_topm_int8_coarse(  # noqa: B023
                planes.emb, planes.scale, planes.err, planes.created, planes.valid, q, kw_w,
                kw_b, now_days, 0, m=m, t=t, sub=sub), dev, runs=runs)
            rec["qps"] = b / rec["scan_ms"] * 1e3
        except (ValueError, torch.cuda.OutOfMemoryError) as exc:
            # a layout K1 refuses at this shape, or one the card cannot hold
            rec["failed"] = f"{type(exc).__name__}: {str(exc)[:160]}"
        out.append(rec)
        del q8, add_row, q_bias, q, kw_w
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> list[dict]:
    from omni_recall_tpu_torch.index.compact import build_compact_engine

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*", help="B,sub,t triples")
    ap.add_argument("--rows", type=int, default=10 * (1 << 20))
    ap.add_argument("--m", type=int, default=128, help="candidates the merge keeps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    configs = [tuple(int(x) for x in c.split(",")) for c in args.configs] or DEFAULT_CONFIGS
    engine, _, now, _ = build_compact_engine(args.rows, device=device)
    from omni_recall_tpu_torch.index.device_index import to_days

    records = sweep(engine.device_index.device_arrays(), float(to_days(now)), configs, m=args.m)
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"tool": "sweep_10m", "rows": args.rows, "device": device_name(device),
                      "records": records}), flush=True)
    return records


if __name__ == "__main__":
    main()
