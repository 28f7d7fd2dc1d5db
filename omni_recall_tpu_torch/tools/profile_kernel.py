"""T1: the kernel variant profiler, K6's body split three ways.

Counterpart of the repository's ``tools/profile_kernel.py`` (the
``pl.pallas_call`` at :26, bodies ``mk_cos_only`` :53, ``mk_cos_kw`` :60 and
``mk_full`` :72). Over bf16 rows ``emb`` [N, d], ``bloom`` u8 [N, W], ``q``
f32 [B, d], ``kw_w`` f32 [B, 8W], ``kw_b`` f32 [B, 1], ``add_row`` f32
[1, N] and blocks of ``c`` rows:

- ``cos``: f32 [N/c, B, 128], entry [i, q, j] the cosine of query q and row
  i·c + j, ``sum_k bf16(q_k) · bf16(e_k)`` in f32;
- ``coskw``: the same layout, holding the hybrid score without K6's eps,
  ``fma(0.7, cos, 0.2 · min(kw + kw_b, 1)) + add_row`` (the contraction
  XLA makes of the tool's graph, found against its interpret-mode body);
- ``full``: f32 [N/c, B, 9], the nine largest scores of each block (eight
  max-and-mask rounds that mask the lowest lane among equals, then the
  ninth maximum).

That is K6's body (``ops/scorer.py`` ``block_topt``) without the eps and
with a plain top-9, so the kernel is K6's own (``csrc/fp_scan.cu``, a
template variant of the same kernel: same wgmma tiles, ring and resident
query operand) and the plain version is K6's (``_bf16_round``, ``_seq_dot``),
held to the kernel by K6's parity rule (``scorer.fp_order_bound``). Every
variant computes all c rows of each block, as the TPU body computes the
whole [B, c] product. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version.

``python -m omni_recall_tpu_torch.tools.profile_kernel [cos|coskw|full|all]``
runs the tool's sweep (N = 2^20, d = 768, B = 128, 1024 bloom bits,
c in 1024, 2048, 4096) on the card (``--device cpu`` for the plain versions)
and prints the tool's line for each variant and c, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.oracle import COSINE_WEIGHT, KEYWORD_WEIGHT
from omni_recall_tpu_torch.ops.scorer import (
    _NEG_INF,
    _bf16_round,
    _bloom_bits,
    _check_cuda_operands,
    _fma32,
    _ptr,
    _require_cpu,
    _seq_dot,
    fp_query_operand,
    fp_query_tile,
)
from omni_recall_tpu_torch.tools import device_name, median_ms

# variant -> csrc/fp_scan.cu Variant, and the tool's name for it
VARIANTS = {"cos": 1, "coskw": 2, "full": 3}
TOOL_NAMES = {"cos": "cos-only", "coskw": "cos+kw", "full": "full t=8"}
WIDE = 128  # rows of a block the cos / coskw variants write
TOP = 9     # values of a block the full variant writes (the tool's t1)
BLOCKS = (1024, 2048, 4096)
N, D, B, BITS = 1 << 20, 768, 128, 1024  # the tool's sweep
QUERY_CHUNK = 64  # queries the plain version scores at a time


def _check_shape(variant: str, n: int, c: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown T1 variant {variant!r}; one of {sorted(VARIANTS)}")
    if c <= 0 or n % c or c % 64 or (variant != "full" and c < WIDE):
        raise ValueError(f"T1 needs N % c == 0, c % 64 == 0 and c >= {WIDE} "
                         f"(full: c >= 64), got N={n}, c={c}")


def profile_scan(variant: str, emb, bloom, q, kw_w, kw_b, add_row, c: int):
    """T1 variant ``variant`` over bf16 rows in blocks of ``c``."""
    if not emb.is_cuda:
        _require_cpu(emb)
        return profile_scan_plain(variant, emb, bloom, q, kw_w, kw_b, add_row, c)
    (n, d), b, w = emb.shape, q.shape[0], bloom.shape[1]
    _check_shape(variant, n, c)
    if d % 8 or c % 128:
        raise ValueError(f"the CUDA T1 probe needs d % 8 == 0 and c % 128 == 0, got d={d}, c={c}")
    f32 = torch.float32
    kw_b, add_row = kw_b.reshape(-1), add_row.reshape(-1)
    _check_cuda_operands(
        emb.device, emb=(emb, torch.bfloat16, (n, d)), bloom=(bloom, torch.uint8, (n, w)),
        q=(q, f32, (b, d)), kw_w=(kw_w, f32, (b, 8 * w)), kw_b=(kw_b, f32, (b,)),
        add_row=(add_row, f32, (n,)),
    )
    full = variant == "full"
    shape = (b, n // c, TOP) if full else (n // c, b, WIDE)
    out = torch.empty(shape, dtype=f32, device=emb.device)
    qkw = fp_query_operand(q, kw_w, w)
    lib = cuda.library("fp_scan")
    rc = lib.omni_fp_scan_probe(
        _ptr(emb), _ptr(bloom), _ptr(qkw), _ptr(kw_b), _ptr(add_row), _ptr(out),
        n, d, w, b, qkw.shape[0], c, VARIANTS[variant], cuda.stream_ptr(emb.device),
    )
    cuda.check(lib, rc, f"profile_kernel[{variant}]")
    cuda.count_launch("profile_kernel")
    return out.transpose(0, 1) if full else out


def query_tile(c: int, variant: str) -> int:
    """Queries one block of the CUDA kernel scores (its wgmma N: 32, 16 or
    8) at block width c and the tool's d and W: the largest whose resident
    query operand and kept scores (c a query for full, 128 for cos and
    coskw) fit in shared memory."""
    return fp_query_tile(VARIANTS[variant], c, D, BITS // 8)


def top_values_plain(s: torch.Tensor, t1: int = TOP):
    """The tool's extraction over [..., c] scores: t1 rounds of the maximum,
    each masking the lowest lane equal to it. Returns (values, lanes)
    [..., t1]."""
    c = s.shape[-1]
    lane = torch.arange(c, device=s.device)
    vals, lanes = [], []
    for _ in range(t1):
        v = s.amax(dim=-1, keepdim=True)
        idx = torch.where(s == v, lane, c).amin(dim=-1, keepdim=True)
        vals.append(v)
        lanes.append(idx)
        s = torch.where(lane == idx, _NEG_INF, s)
    return torch.cat(vals, dim=-1), torch.cat(lanes, dim=-1)


def scores_plain(variant: str, emb, bloom, q, kw_w, kw_b, add_row):
    """[B, R] scores of every given row: the cosine (``cos``) or the T1
    hybrid score, in K6's order of operations."""
    cos = _seq_dot(_bf16_round(q), _bf16_round(emb.to(torch.float32)).T.contiguous())
    if variant == "cos":
        return cos
    bits_t = _bloom_bits(bloom).T.to(torch.float32).contiguous()
    kw = torch.clamp_max(_seq_dot(_bf16_round(kw_w), bits_t) + kw_b.reshape(-1, 1), 1.0)
    return _fma32(COSINE_WEIGHT, cos, KEYWORD_WEIGHT * kw) + add_row.reshape(1, -1)


def profile_scan_plain(variant: str, emb, bloom, q, kw_w, kw_b, add_row, c: int):
    """Plain PyTorch T1: the cos / coskw variants score the first 128 rows
    of each block (the rows they write), full every row."""
    n, b = emb.shape[0], q.shape[0]
    _check_shape(variant, n, c)
    if variant != "full":
        def first(x):
            return x.reshape(n // c, c, *x.shape[1:])[:, :WIDE].reshape(-1, *x.shape[1:])
        emb, bloom = first(emb), first(bloom)
        add_row = first(add_row.reshape(-1))
    outs = []
    for i in range(0, b, QUERY_CHUNK):
        sl = slice(i, i + QUERY_CHUNK)
        s = scores_plain(variant, emb, bloom, q[sl], kw_w[sl], kw_b[sl], add_row)
        bq = s.shape[0]
        if variant == "full":
            outs.append(top_values_plain(s.reshape(bq, n // c, c))[0])
        else:
            outs.append(s.reshape(bq, n // c, WIDE))
    return torch.cat(outs).transpose(0, 1)


def tool_inputs(n: int, device: torch.device, b: int = B, seed: int = 0):
    """The tool's operands: normal bf16 rows and f32 queries, random bloom
    bytes, zero keyword weights, bias and recency terms (the kernel still
    sums the zero weights' terms, as K6 does)."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = BITS // 8
    emb = torch.randn((n, D), generator=g, device=device).to(torch.bfloat16)
    bloom = torch.randint(0, 256, (n, w), generator=g, device=device).to(torch.uint8)
    q = torch.randn((b, D), generator=g, device=device)
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return emb, bloom, q, zeros(b, BITS), zeros(b, 1), zeros(1, n)


def main(which: str = "all", n: int = N, device: str = "cuda", runs: int = 8) -> list[dict]:
    """The tool's sweep: each chosen variant at c = 1024, 2048, 4096 (those
    dividing n), timed as the median of ``runs`` calls after a warm-up.
    Prints the tool's line for each, then one JSON line; returns the
    records."""
    if which != "all" and which not in VARIANTS:
        raise ValueError(f"unknown variant {which!r}: cos, coskw, full or all")
    dev = resolve_device(device)
    operands = tool_inputs(n, dev)
    chosen = list(VARIANTS) if which == "all" else [which]
    records = []
    for c in BLOCKS:
        if n % c:
            continue
        for variant in chosen:
            before = cuda.LAUNCHES["profile_kernel"]
            ms = median_ms(lambda: profile_scan(variant, *operands, c), dev, runs)  # noqa: B023
            qps = B / (ms / 1e3)
            print(f"{TOOL_NAMES[variant]} (c={c}): {ms:.2f} ms/scan -> {qps:.0f} qps",
                  flush=True)
            records.append({
                "variant": variant, "c": c, "ms": ms, "qps": qps,
                "query_tile": query_tile(c, variant) if dev.type == "cuda" else None,
                "launches": cuda.LAUNCHES["profile_kernel"] - before,
            })
    print(json.dumps({"tool": "profile_kernel", "device": device_name(dev), "n": n, "d": D,
                      "b": B, "bits": BITS, "runs": runs, "records": records}), flush=True)
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="all", choices=[*VARIANTS, "all"])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(args.which, device=args.device)
