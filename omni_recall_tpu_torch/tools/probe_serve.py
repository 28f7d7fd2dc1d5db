"""T3 and the serving-stage decomposition: the device time of each stage of a
serving batch.

Counterpart of the repository's ``tools/probe_serve.py``. Its kernel is T3
(the ``pl.pallas_call`` at :210, in ``k_body`` :202-233): K3's body
(``_make_refine_kernel_full``) over pre-gathered candidate slabs, which the
port runs as the second kernel of ``csrc/refine.cu`` through
``ops/refine.py refine_slab_tile`` (plain version ``refine_slab_tile_plain``).

``main`` builds the tool's operands (N = 2^20 rows, d = 768, 1024 bloom bits,
B = 1536 queries, m = 128 candidates) and times each stage as the median of
``runs`` calls after a warm-up, with CUDA events on the card:

  S   coarse int8 scan (K1) -> top-(m+1)
  SR  S + refine_select_from_scan at r = 64 (K3) + exact_cos_rows (K2)
  SR  the same without K2
  DD  exact_cos_rows at t = 32 alone (K2)
  G   the four candidate gathers alone (emb1, emb2, bloom, the [N, 5] sidecar)
  K   T3 alone, on the gathered slabs
  T   top_k_with_payload(33) alone
  Q   quantize_queries_int8_residual alone
  R   refine_select_from_scan at r = 64 alone, on S's output (K3)

The tool's SR gathers the candidates and runs the tile kernel; the port's SR
runs K3, which reads each candidate row by index and gathers nothing. So
the tool's closing comparison, "S+G+K+T+Q vs SR", sets two designs side by
side here: S+G+K+T+Q is the TPU's (gather, then T3 over the slabs), S+R is
the port's (K3 by index). Both sums are printed beside the measured SR; R is
this module's stage, not the tool's.

The tool chains each stage in a ``lax.scan`` with carry perturbations so
that XLA cannot hoist it; PyTorch runs eagerly, so each stage's call is
timed as it is. ``python -m omni_recall_tpu_torch.tools.probe_serve`` runs
on the card (``--device cpu`` runs the plain versions, slowly). It prints
the tool's line for each stage, the two sums, then one JSON line with a
record per stage (K's with its bound).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.exact_cos import exact_cos_rows
from omni_recall_tpu_torch.ops.merge import top_k_with_payload
from omni_recall_tpu_torch.ops.refine import (
    mask_dead,
    quantize_queries_int8_residual,
    refine_select_from_scan,
    refine_slab_tile,
    slot_add_term,
    slab_tile_queries,
)
from omni_recall_tpu_torch.ops.scorer import (
    _coarse_layout,
    _pick_block_coarse,
    quantize_kw_weights,
    row_norm,
    score_topm_int8_coarse,
)
from omni_recall_tpu_torch.tools import device_name, median_ms

N, D, BITS, BT, M = 1 << 20, 768, 1024, 1536, 128  # the tool's shapes
R, DD_T, TOP = 64, 32, 33  # SR's refine width, DD's rows, T's k
NOW_DAYS = 365.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15   # dense int8 tensor-core peak
LABELS = {
    "S": "S  scan",
    "SR": "SR scan + refine_select(r=64) + DD",
    "SR_noDD": "SR scan + refine_select(r=64), no DD",
    "DD": "DD exact_cos_rows(t=32) alone",
    "G": "G  gather alone",
    "K": "K  fused refine kernel alone",
    "T": "T  top_k_with_payload(33) alone",
    "Q": "Q  quantize_queries_int8_residual alone",
    "R": "R  refine_select(r=64) alone (K3)",
}


def slab_work(b: int, m: int, d: int, w: int, qg: int) -> tuple[int, float]:
    """(bytes, int8 operations) T3 must move and do: each slab row's two int8
    rows, bloom row and four f32 sidecars read once, each query's two int8
    planes, keyword weights and five f32 terms read once, the [B, qg*m] f32
    tile written once; four int8 dots of d and one keyword dot of 8W for
    every (query, slab row) pair of a tile, 2 operations a product term."""
    ct = qg * m
    moved = b * m * (2 * d + w + 16) + b * (2 * d + 8 * w + 20) + b * ct * 4
    return moved, 2.0 * b * ct * (4 * d + 8 * w)


def slab_bound_ms(b: int, m: int, d: int, w: int, qg: int) -> tuple[float, str]:
    """T3's least time on an H100 at 3.35 TB/s and 1979 T int8 ops/s."""
    moved, ops = slab_work(b, m, d, w, qg)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_slabs(emb1, emb2, bloom, sidecar, rows):
    """The tool's G stage: the candidate rows of emb1, emb2 and bloom and of
    the stacked [N, 5] sidecar (scale1, scale2, err2, created, valid), each
    one gather. Returns (gc1, gc2, gbloom [B*m, .], gsc [5, B*m])."""
    flat = rows.reshape(-1).long()
    return emb1[flat], emb2[flat], bloom[flat], sidecar[flat].T.contiguous()


def stack_sidecar(scale1, scale2, err2, created, valid):
    return torch.stack([scale1, scale2, err2, created, valid.to(torch.float32)], dim=1)


def slab_scales(gsc):
    """T3's s1, s2, ec2 [1, B*m] from the gathered sidecar [5, B*m], each in
    an allocation of its own (the kernel's wrapper takes 16-byte aligned
    operands; a row of gsc is aligned only when B*m % 4 == 0)."""
    return gsc[0:1].clone(), gsc[1:2].clone(), gsc[2:3].clone()


def k3_slab_operands(emb1, scale1, emb2, scale2, err2, bloom, created, valid, q, kw_w8,
                     kw_bias, now_days, rows, vals):
    """T3's fifteen operands (and qg) for K3's candidates, built as the JAX
    K3 wrapper builds them (refine.py _refine_bounds_fused: sentinel rows
    read row 0, ``add`` = fma(0.1, rec, REFINE_EPS) or -1e30 where the slot
    holds no live candidate, ``qn`` with K3's (1 + 1e-6) slack), so that the
    block diagonal of T3's tile is K3's output before its -inf mask."""
    b, m = rows.shape
    safe = rows.clamp_min(0)
    gc1, gc2, gbloom, gsc = gather_slabs(
        emb1, emb2, bloom, stack_sidecar(scale1, scale2, err2, created, valid), safe)
    add = slot_add_term(created, valid, now_days, rows, vals).reshape(1, b * m)
    q1, t1, q2, t2, eq2 = quantize_queries_int8_residual(q)
    qn = (row_norm(q) * (1.0 + 1e-6))[:, None]
    kwb = kw_bias.to(torch.float32).reshape(b, 1)
    return ((q1, q2, t1, t2, eq2, qn, kwb, kw_w8, gc1, gc2, gbloom, *slab_scales(gsc), add),
            slab_tile_queries(m))


def block_diagonal(out: torch.Tensor, m: int, qg: int) -> torch.Tensor:
    """[B, qg*m] tile rows -> [B, m]: query q's own columns [g*m, (g+1)*m),
    g = q % qg, with K3's mask (<= -0.5e30 -> -inf)."""
    b = out.shape[0]
    queries = torch.arange(b, device=out.device)
    return mask_dead(out.reshape(b, qg, m)[queries, queries % qg])


def tool_inputs(n: int, d: int, bits: int, bt: int, device: torch.device, seed: int = 0):
    """The tool's index and queries: int8 rows uniform in [-127, 127] from an
    explicit generator, constant scales and error terms, random bloom bytes,
    created days spread over a year, every row valid, a standard normal raw
    plane; queries and keyword weights from ``np.random.default_rng(seed)``
    as the tool makes them. Returns (index dict, q, kw, rng) with the rng
    where the tool's later draws continue from."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = bits // 8
    scale1 = torch.full((n,), 1.0 / 127.0 / math.sqrt(d), device=device)
    index = {
        "emb1": torch.randint(-127, 128, (n, d), generator=g, device=device, dtype=torch.int8),
        "emb2": torch.randint(-127, 128, (n, d), generator=g, device=device, dtype=torch.int8),
        "scale1": scale1, "scale2": scale1 * 8e-3,
        "err1": torch.full((n,), 8e-3, device=device),
        "err2": torch.full((n,), 6e-5, device=device),
        "bloom": torch.randint(0, 256, (n, w), generator=g, device=device, dtype=torch.uint8),
        "created": torch.linspace(0.0, 365.0, n, device=device),
        "valid": torch.ones((n,), dtype=torch.bool, device=device),
        "raw": torch.randn((n, d), generator=g, device=device),
    }
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bt, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw = (rng.uniform(size=(bt, bits)) < 0.04).astype(np.float32) * 0.025
    return index, torch.from_numpy(q).to(device), torch.from_numpy(kw).to(device), rng


def main(n: int = N, d: int = D, bits: int = BITS, bt: int = BT, m: int = M,
         device: str = "cuda", runs: int = 8) -> dict:
    """Time every stage; print the tool's lines, the two sums and one JSON
    line. Returns {stage: record}; each record has its ms and the launches
    of its timed calls (the warm-up's included), K's also its bound."""
    dev = resolve_device(device)
    ix, q, kw, rng = tool_inputs(n, d, bits, bt, dev)
    w = bits // 8
    bias = torch.zeros((bt,), device=dev)
    blk = _pick_block_coarse(n)
    sub_c, t_c = _coarse_layout(n, m, blk)
    print(f"layout: block={blk} sub={sub_c} t={t_c}", flush=True)
    e1, s1, e2, s2, er2, bl, cr, va, raw = (ix[k] for k in (
        "emb1", "scale1", "emb2", "scale2", "err2", "bloom", "created", "valid", "raw"))

    def scan():
        return score_topm_int8_coarse(e1, s1, ix["err1"], cr, va, q, kw, bias, NOW_DAYS, 0,
                                      m=m, t=t_c, sub=sub_c)

    def select(vals, idxs):
        return refine_select_from_scan(e1, s1, e2, s2, er2, bl, cr, va, q, kw, bias,
                                       NOW_DAYS, vals, idxs, r=R)

    def serve(dd: bool):
        rows, _, _ = select(*scan())
        return exact_cos_rows(raw, rows, q) if dd else rows

    vals, idxs = scan()
    sorted_desc = bool((torch.diff(vals[:, :m], dim=1) <= 1e-12).all())
    rows32 = torch.from_numpy(rng.integers(0, n, size=(bt, DD_T)).astype(np.int32)).to(dev)
    rows_fix = torch.from_numpy(rng.integers(0, n, size=(bt, m)).astype(np.int32)).to(dev)
    sidecar = stack_sidecar(s1, s2, er2, cr, va)
    gc1, gc2, gbloom, gsc = gather_slabs(e1, e2, bl, sidecar, rows_fix)
    q1, t1, q2, t2, eq2 = quantize_queries_int8_residual(q)
    qn = row_norm(q)[:, None]  # the tool's: no slack
    slab_ops = (q1, q2, t1, t2, eq2, qn, bias[:, None], quantize_kw_weights(kw),
                gc1, gc2, gbloom, *slab_scales(gsc), torch.zeros((1, bt * m), device=dev))
    qg = slab_tile_queries(m)
    ubs_fix = torch.from_numpy(rng.uniform(0.3, 0.9, size=(bt, m)).astype(np.float32)).to(dev)
    stages = {
        "S": scan,
        "SR": lambda: serve(True),
        "SR_noDD": lambda: serve(False),
        "DD": lambda: exact_cos_rows(raw, rows32, q),
        "G": lambda: gather_slabs(e1, e2, bl, sidecar, rows_fix),
        "K": lambda: refine_slab_tile(*slab_ops, qg),
        "T": lambda: top_k_with_payload(ubs_fix, rows_fix, TOP),
        "Q": lambda: quantize_queries_int8_residual(q),
        "R": lambda: select(vals, idxs),
    }
    records = {}
    for name, fn in stages.items():
        before = dict(cuda.LAUNCHES)
        ms = median_ms(fn, dev, runs)
        print(f"{LABELS[name]:46s} {ms:9.3f} ms/batch", flush=True)
        records[name] = {"stage": name, "label": LABELS[name], "ms": ms, "launches": {
            k: v - before[k] for k, v in cuda.LAUNCHES.items() if v != before[k]}}
        if name == "S":
            records[name]["sorted_desc"] = sorted_desc
            print(f"scan candidate bounds sorted desc: {sorted_desc}", flush=True)
    k = records["K"]
    k["qg"], k["ct"] = qg, qg * m
    k["bound_ms"], k["bound_by"] = slab_bound_ms(bt, m, d, w, qg)
    ms = {name: r["ms"] for name, r in records.items()}
    tool_sum = ms["S"] + ms["G"] + ms["K"] + ms["T"] + ms["Q"]
    port_sum = ms["S"] + ms["R"]
    print(f"\nsum of parts S+G+K+T+Q = {tool_sum:.2f} ms (gather + T3, the tool's design); "
          f"S+R = {port_sum:.2f} ms (K3 by index, the port's); "
          f"SR measured = {ms['SR_noDD']:.2f} ms without DD, {ms['SR']:.2f} ms with it",
          flush=True)
    print(json.dumps({"tool": "probe_serve", "device": device_name(dev), "n": n, "d": d,
                      "bits": bits, "b": bt, "m": m, "layout": [blk, sub_c, t_c],
                      "runs": runs, "sorted_desc": sorted_desc, "sum_tool_design_ms": tool_sum,
                      "sum_port_design_ms": port_sum, "records": list(records.values())}),
          flush=True)
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
