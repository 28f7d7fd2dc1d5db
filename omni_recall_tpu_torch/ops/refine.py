"""Device-assisted exact rescore: tight sound bounds for scan candidates
(port of omni_recall_tpu/ops/refine.py).

The int8 scan's upper bounds are ~4e-3 loose, so the host float64 rescore
must score ~33 candidates per query before its two-phase prune can cut the
tail. This stage re-scores the top candidate ROWS on the device with bounds
~50x tighter (the JAX module's docstring has the derivation, unchanged):

- **cosine** — two-plane residual int8 (ops/quantize.py
  quantize_rows_int8_residual, ``DeviceIndex(refine=True)``):
  c ~= c1*s1 + c2*s2 and q ~= q1*t1 + q2*t2, so q.c comes from FOUR exact
  integer dot products, plus the residual term
  ``delta = eq2*(1 + ec2) + |q|*ec2``;
- **keyword** — the bloom upper-bound dot of the fused scan,
  ``min(kwd/127 + bias, 1)`` over ceil-quantized weights;
- **recency** — f32 exp over f32 created-days;

    refined_ub = 0.7*(q_hat.c_hat + delta) + 0.2*kw_ub + 0.1*rec + REFINE_EPS

REFINE_EPS covers the f32 combine's rounding in ANY order, the f32 day
rounding of the recency term and the normalized-vs-oracle cosine gap.

The refine kernel (K3) is the hand-written CUDA kernel csrc/refine.cu,
replacing the TPU kernel ``_make_refine_kernel_full`` (launched through
``_refine_bounds_fused``). A CUDA tensor launches it at every width; a CPU
tensor takes ``refine_bounds_plain``, the same function in PyTorch. There
is no fallback from one to the other. The kernel quantizes each query
itself (quantize_queries_int8_residual's operations, bit for bit) and
computes the recency term itself (``recency_term``'s operations; the CUDA
math library's ``expf`` gives ``torch.exp``'s bits on the card, which
chip_smoke.py checks over every row of its 2^20-row index), and it reads
the candidate rows and scan bounds with a row stride, so one launch is all
the CUDA path queues. Both evaluate the f32 combine in the TPU kernel's
order (its per-row scale products last), with the multiply-adds
contracted exactly where XLA's CPU compiler contracts the interpret-mode
kernel (found by comparing against ``_refine_bounds_fused(interpret=True)``):

    cos   = fma(s1, fma(t1, d11, t2*d21), s2*fma(t1, d12, t2*d22))
    delta = fma(qn, ec2, eq2*(1 + ec2))
    kw    = min(fma(kwd, 1/127, kw_bias), 1)
    add   = fma(0.1, rec, REFINE_EPS), or -1e30 where the slot holds no
            live candidate
    out   = fma(0.2, kw, 0.7*(cos + delta)) + add

T3 (``refine_slab_tile``), the tool ``tools/probe_serve.py``'s launch of
the same TPU body, is the second kernel of csrc/refine.cu: it takes
pre-gathered candidate slabs, pre-quantized queries and the add term from
its caller and writes each tile's whole [qg, qg*m] block, in the same
order (``_refined``). No serving path calls it; the probe
``omni_recall_tpu_torch/tools/probe_serve.py`` times it.

The JAX engine on a CPU serves ``refine_ub`` instead (scale products
first); the two orders differ by f32 rounding only, inside REFINE_EPS.

The TPU kernel's shape gate (``_fused_ok``) is a Mosaic limit and is not
carried over; the engine keeps its refine ceiling (``_REFINE_MAX_M``) and
its width rounding ``r = ((r + 7) // 8) * 8``, because ``r`` decides the
certificate bound (``vals_full[:, r]`` in ``compact_select``).
"""

from __future__ import annotations

import torch

from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.merge import top_k_with_payload
from omni_recall_tpu_torch.ops.oracle import (
    COSINE_WEIGHT,
    KEYWORD_WEIGHT,
    RECENCY_HALF_LIFE_DAYS,
    RECENCY_WEIGHT,
)
from omni_recall_tpu_torch.ops.scorer import (
    _bloom_bits,
    _check_cuda_operands,
    _fma32,
    _no_tf32,
    quantize_kw_weights,
    row_norm,
)

_NEG_INF = -1e30  # finite mask value of the add row; mapped to -inf outside

# f32 combine rounding (~1e-6) + normalized-vs-oracle cosine gap (~3e-7)
# + f32 recency-day rounding (~3e-6 on the weighted term) + exp ulp, with
# ~5x headroom (the JAX module's constant)
REFINE_EPS = 3e-5


def _int8_plane(x: torch.Tensor):
    """Symmetric per-row int8 plane (q8, scale [R, 1]). The scale is
    ``absmax * fl32(1/127)``: XLA's jit rewrites the JAX graph's division by
    the constant 127 into that multiply."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8), scale


def quantize_queries_int8_residual(q: torch.Tensor):
    """Two-plane residual int8 query quantization (refine.py
    quantize_queries_int8_residual). Returns (q1 i8[B, d], t1 f32[B, 1],
    q2 i8[B, d], t2 f32[B, 1], eq2 f32[B, 1]) with
    ||q - q1*t1 - q2*t2|| <= eq2. The residuals and the bound take the
    fused multiply-add forms XLA's jit contracts them into, so q1, t1, q2
    and t2 are bitwise the JAX graph's; eq2 may differ in its last bit
    where XLA orders the sum of squares otherwise (sound either way: the
    (1 + 1e-4) / 3e-7 slack covers f32 rounding)."""
    q1, t1 = _int8_plane(q)
    resid = _fma32(-q1.to(torch.float32), t1, q)
    q2, t2 = _int8_plane(resid)
    resid2 = _fma32(-q2.to(torch.float32), t2, resid)
    eq2 = _fma32(row_norm(resid2)[:, None], 1.0 + 1e-4, 3e-7)
    return q1, t1, q2, t2, eq2


def recency_term(created, now_days, rows) -> torch.Tensor:
    """exp(min(created - now, 0) / 30) of each candidate row [B, m], computed
    outside the kernel as JAX computes it (refine.py _refine_bounds_fused);
    K3 evaluates the same operations in f32 inside (csrc/refine.cu). XLA's
    jit form of the division by the half-life is a reciprocal multiply."""
    days = created[rows.clamp_min(0).long()]
    return torch.exp(torch.clamp_max(days - now_days, 0.0) * (1.0 / RECENCY_HALF_LIFE_DAYS))


def kernel_recency(created: torch.Tensor, now_days=None) -> torch.Tensor:
    """K3's recency term of every row [N], evaluated alone by csrc/refine.cu
    (its ``recency``) on the card; with ``now_days`` None, its exp alone
    (``recency_exp``) of every argument in ``created``. chip_smoke.py and
    the card tests hold both bitwise to PyTorch's (``recency_term``,
    ``torch.exp``): the exp on every f32 argument <= 0, the term over whole
    indexes, the condition on which K3 computes the term inside. No serving
    path launches it."""
    if not created.is_cuda:
        raise ValueError(f"kernel_recency needs a CUDA tensor, got {created.device}")
    n = created.shape[0]
    _check_cuda_operands(created.device, created=(created, torch.float32, (n,)))
    out = torch.empty_like(created)
    lib = cuda.library("refine")
    exp_only = now_days is None
    cuda.check(lib, lib.omni_recency(created.data_ptr(), out.data_ptr(),
                                     0.0 if exp_only else float(now_days), n, int(exp_only),
                                     cuda.stream_ptr(created.device)), "recency")
    cuda.count_launch("recency")
    return out


def _refined(d11, d12, d21, d22, kwd, s1, s2, ec2, add, t1, t2, eq2, qn, kw_b):
    """The f32 combine in the kernels' order (module docstring), unmasked:
    fma(0.2, kw, 0.7*(cos + delta)) + add. The per-query operands are
    [B, 1], the others broadcast against them."""
    a = _fma32(t1, d11, t2 * d21)
    b = _fma32(t1, d12, t2 * d22)
    cos = _fma32(s1, a, s2 * b)
    delta = _fma32(qn, ec2, eq2 * (1.0 + ec2))
    kw = torch.clamp_max(_fma32(kwd, 1.0 / 127.0, kw_b), 1.0)
    return _fma32(KEYWORD_WEIGHT, kw, COSINE_WEIGHT * (cos + delta)) + add


def slot_add_term(created, valid, now_days, rows, vals) -> torch.Tensor:
    """The add term of each candidate slot [B, m] as the JAX K3 wrapper
    builds it (refine.py _refine_bounds_fused): fma(0.1, rec, REFINE_EPS)
    (contracted, as in XLA) where the slot holds a live candidate (row >= 0,
    the row valid, the scan bound above -inf), else -1e30."""
    live = (rows >= 0) & valid[rows.clamp_min(0).long()] & (vals > float("-inf"))
    add = _fma32(RECENCY_WEIGHT, recency_term(created, now_days, rows), REFINE_EPS)
    return torch.where(live, add, torch.full_like(add, _NEG_INF))


def mask_dead(out: torch.Tensor) -> torch.Tensor:
    """K3's output mask: entries that carry the -1e30 add term -> -inf."""
    return torch.where(out <= _NEG_INF * 0.5, torch.full_like(out, float("-inf")), out)


def _bdot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact integer dots of each row of a[T, r, K] with each row of
    c[T, s, K] -> f32 [T, r, s]: f32 (f64 once K*127^2 reaches 2^24)
    products and sums of small integers are exact in any order, so this
    batched matmul stands in for the int32 one."""
    k = a.shape[-1]
    dt = torch.float32 if k * 127 * 127 < 2**24 else torch.float64
    with _no_tf32():
        return torch.bmm(a.to(dt), c.to(dt).transpose(1, 2)).to(torch.float32)


def refine_bounds_plain(emb1, scale1, emb2, scale2, err2, bloom, created, valid,
                        q, kw_w8, kw_bias, now_days, rows, vals):
    """Plain PyTorch K3: refined bounds [B, m] for the candidate ``rows``
    (the contract of refine.py _refine_bounds_fused / refine_ub, with
    pre-quantized keyword weights; -inf where the slot is a sentinel
    (row < 0), the row is invalid or the scan bound is -inf)."""
    q1, t1, q2, t2, eq2 = quantize_queries_int8_residual(q)
    qn = (row_norm(q) * (1.0 + 1e-6))[:, None]
    safe = rows.clamp_min(0).long()
    c1, c2 = emb1[safe], emb2[safe]  # [B, m, d]

    def dot(a, c):  # [B, K] . [B, m, K] -> [B, m]
        return _bdot(a[:, None], c)[:, 0]

    kwd = dot(kw_w8, _bloom_bits(bloom[safe].reshape(-1, bloom.shape[1]))
              .reshape(*rows.shape, -1))
    return mask_dead(_refined(
        dot(q1, c1), dot(q1, c2), dot(q2, c1), dot(q2, c2), kwd,
        scale1[safe], scale2[safe], err2[safe],
        slot_add_term(created, valid, now_days, rows, vals), t1, t2, eq2, qn,
        kw_bias.to(torch.float32).reshape(-1, 1)))


def _row_view(name: str, x: torch.Tensor, dtype, shape, device) -> int:
    """The row stride of ``x``, a [B, m] view whose rows may lie apart (a
    column slice of the engine's [B, m + 1] scan output); raises where the
    kernel cannot read it."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name}: {x.dtype}{tuple(x.shape)} on {x.device}, expected "
                         f"{dtype}{shape} on {device}")
    if x.stride(1) != 1 and shape[1] > 1:
        raise ValueError(f"{name} must have unit column stride, got {x.stride()}")
    return x.stride(0) if shape[0] > 1 else shape[1]


def refine_bounds_cuda(emb1, scale1, emb2, scale2, err2, bloom, created, valid,
                       q, kw_w8, kw_bias, now_days, rows, vals):
    """Launch csrc/refine.cu (K3) on the current stream, operands as
    ``refine_bounds_plain`` (``now_days`` a number): the kernel quantizes
    each query, computes the recency term and reads each candidate row
    straight from the index planes by index, so no [B, m, d] gather is
    materialized, and it reads ``rows`` and ``vals`` with their row stride.
    Never synchronizes."""
    n, d = emb1.shape
    b, m = rows.shape
    w = bloom.shape[1]
    dev = emb1.device
    if d % 16:
        raise ValueError(f"the CUDA refine kernel needs d % 16 == 0, got d={d}")
    f32 = torch.float32
    kw_bias = kw_bias.to(f32).reshape(-1)
    _check_cuda_operands(
        dev, emb1=(emb1, torch.int8, (n, d)), emb2=(emb2, torch.int8, (n, d)),
        bloom=(bloom, torch.uint8, (n, w)), scale1=(scale1, f32, (n,)),
        scale2=(scale2, f32, (n,)), err2=(err2, f32, (n,)), created=(created, f32, (n,)),
        valid=(valid, torch.bool, (n,)), q=(q, f32, (b, d)),
        kw_w8=(kw_w8, torch.int8, (b, 8 * w)), kw_bias=(kw_bias, f32, (b,)),
    )
    rows_stride = _row_view("rows", rows, torch.int32, (b, m), dev)
    vals_stride = _row_view("vals", vals, f32, (b, m), dev)
    out = torch.empty((b, m), dtype=f32, device=dev)
    lib = cuda.library("refine")
    rc = lib.omni_refine(
        emb1.data_ptr(), emb2.data_ptr(), bloom.data_ptr(), scale1.data_ptr(),
        scale2.data_ptr(), err2.data_ptr(), valid.data_ptr(), created.data_ptr(),
        q.data_ptr(), kw_w8.data_ptr(), kw_bias.data_ptr(), rows.data_ptr(), vals.data_ptr(),
        out.data_ptr(), float(now_days), n, d, w, b, m, rows_stride, vals_stride,
        cuda.stream_ptr(dev),
    )
    cuda.check(lib, rc, "refine")
    cuda.count_launch("refine")
    return out


# ---- T3: K3's body over pre-gathered slabs (tools/probe_serve.py:210) ----


def slab_tile_queries(m: int) -> int:
    """qg, the queries of one T3 tile (ct = qg * m slab rows): the tool's
    max(1, min(16, 2048 // m))."""
    return max(1, min(16, 2048 // m))


def _slab_shapes(q1, gc1, gbloom, qg: int):
    """(b, d, w, m) of T3's operands; raises where the tool's grid would not
    cover them."""
    b, d = q1.shape
    rows, w = gc1.shape[0], gbloom.shape[1]
    if not 1 <= qg <= 16 or b % qg:
        raise ValueError(f"T3 needs 1 <= qg <= 16 and B % qg == 0, got B={b}, qg={qg}")
    if rows % b or rows == 0:
        raise ValueError(f"T3 needs B*m slab rows, got {rows} for B={b}")
    return b, d, w, rows // b


def refine_slab_tile_plain(q1, q2, t1, t2, eq2, qn, kwb, kw_w8, gc1, gc2, gbloom,
                           s1, s2, ec2, add, qg: int):
    """Plain PyTorch T3: the tool's launch of K3's body over pre-gathered
    slabs. Queries q1, q2 i8 [B, d] with t1, t2, eq2, qn, kwb f32 [B, 1] and
    kw_w8 i8 [B, 8W]; slabs gc1, gc2 i8 [B*m, d], gbloom u8 [B*m, W] and
    s1, s2, ec2, add f32 [1, B*m]. Tile k holds queries [k*qg, (k+1)*qg)
    and slab rows [k*ct, (k+1)*ct), ct = qg*m; every query is scored
    against every slab row of its tile, unmasked: f32 [B, ct]."""
    b, d, w, m = _slab_shapes(q1, gc1, gbloom, qg)
    ct, tiles = qg * m, b // qg

    def tile_dot(a, c):  # [B, K] . [B*m, K] within each tile -> [B, ct]
        return _bdot(a.reshape(tiles, qg, -1), c.reshape(tiles, ct, -1)).reshape(b, ct)

    def per_row(x):  # [1, B*m] -> [B, ct]: the tile's columns for each query
        return x.reshape(tiles, 1, ct).expand(tiles, qg, ct).reshape(b, ct)

    kwd = tile_dot(kw_w8, _bloom_bits(gbloom))
    return _refined(tile_dot(q1, gc1), tile_dot(q1, gc2), tile_dot(q2, gc1), tile_dot(q2, gc2),
                    kwd, per_row(s1), per_row(s2), per_row(ec2), per_row(add),
                    t1, t2, eq2, qn, kwb)


def _refine_slab_cuda(q1, q2, t1, t2, eq2, qn, kwb, kw_w8, gc1, gc2, gbloom,
                      s1, s2, ec2, add, qg: int):
    """Launch csrc/refine.cu's T3 kernel on the current stream; never
    synchronizes."""
    b, d, w, m = _slab_shapes(q1, gc1, gbloom, qg)
    if d % 16:
        raise ValueError(f"the CUDA T3 kernel needs d % 16 == 0, got d={d}")
    f32, i8 = torch.float32, torch.int8
    dev, rows = q1.device, b * m
    per_query = {k: (x, f32, (b, 1)) for k, x in
                 (("t1", t1), ("t2", t2), ("eq2", eq2), ("qn", qn), ("kwb", kwb))}
    per_row = {k: (x, f32, (1, rows)) for k, x in
               (("s1", s1), ("s2", s2), ("ec2", ec2), ("add", add))}
    _check_cuda_operands(
        dev, q1=(q1, i8, (b, d)), q2=(q2, i8, (b, d)), kw_w8=(kw_w8, i8, (b, 8 * w)),
        gc1=(gc1, i8, (rows, d)), gc2=(gc2, i8, (rows, d)),
        gbloom=(gbloom, torch.uint8, (rows, w)), **per_query, **per_row,
    )
    out = torch.empty((b, qg * m), dtype=f32, device=dev)
    lib = cuda.library("refine")
    rc = lib.omni_refine_slab(
        q1.data_ptr(), q2.data_ptr(), t1.data_ptr(), t2.data_ptr(), eq2.data_ptr(),
        qn.data_ptr(), kwb.data_ptr(), kw_w8.data_ptr(), gc1.data_ptr(), gc2.data_ptr(),
        gbloom.data_ptr(), s1.data_ptr(), s2.data_ptr(), ec2.data_ptr(), add.data_ptr(),
        out.data_ptr(), b, d, w, m, qg, cuda.stream_ptr(dev),
    )
    cuda.check(lib, rc, "probe_serve")
    cuda.count_launch("probe_serve")
    return out


def refine_slab_tile(q1, q2, t1, t2, eq2, qn, kwb, kw_w8, gc1, gc2, gbloom,
                     s1, s2, ec2, add, qg: int):
    """T3 (operands as refine_slab_tile_plain): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, and an error for any other
    device."""
    if q1.is_cuda:
        return _refine_slab_cuda(q1, q2, t1, t2, eq2, qn, kwb, kw_w8, gc1, gc2, gbloom,
                                 s1, s2, ec2, add, qg)
    if q1.device.type != "cpu":
        raise ValueError(f"no kernel for device {q1.device}")
    return refine_slab_tile_plain(q1, q2, t1, t2, eq2, qn, kwb, kw_w8, gc1, gc2, gbloom,
                                  s1, s2, ec2, add, qg)


def _refine_dispatch(emb1, scale1, emb2, scale2, err2, bloom, created, valid,
                     q, kw_w8, kw_bias, now_days, rows, vals):
    """Refined bounds [B, m]: K3 for CUDA tensors (any m), the plain
    version for CPU tensors."""
    args = (emb1, scale1, emb2, scale2, err2, bloom, created, valid, q, kw_w8, kw_bias,
            now_days, rows, vals)
    if emb1.is_cuda:
        return refine_bounds_cuda(*args)
    if emb1.device.type != "cpu":
        raise ValueError(f"no kernel for device {emb1.device}")
    return refine_bounds_plain(*args)


def refine_ub_from_scan(emb1, scale1, emb2, scale2, err2, bloom, created, valid,
                        q, kw_weights, kw_bias, now_days, vals_full, idxs_full):
    """Engine entry: the scan/merge output [B, m+1] (entry m is the
    certificate boundary, not a candidate) + f32 keyword weights -> refined
    bounds [B, m], queued after the scan on the same stream."""
    return _refine_dispatch(
        emb1, scale1, emb2, scale2, err2, bloom, created, valid, q,
        quantize_kw_weights(kw_weights), kw_bias, now_days, idxs_full[:, :-1], vals_full[:, :-1],
    )


def refine_select_from_scan(emb1, scale1, emb2, scale2, err2, bloom, created, valid,
                            q, kw_weights, kw_bias, now_days, vals_full, idxs_full,
                            t_out: int = 32, r: int | None = None):
    """Refine the top-``r`` scan candidates and select on device: returns
    (rows [B, k], ubs [B, k], bound [B]), k = min(t_out, r), with

        bound = max(scan boundary,            # rows the scan excluded
                    (r+1)-th scan bound,      # candidates refine skipped
                    (t_out+1)-th refined)     # candidates select dropped

    a sound upper bound on EVERY row not in the slice (refine.py
    refine_select_from_scan)."""
    m = vals_full.shape[1] - 1
    r = m if r is None else max(1, min(r, m))
    refined = _refine_dispatch(
        emb1, scale1, emb2, scale2, err2, bloom, created, valid, q,
        quantize_kw_weights(kw_weights), kw_bias, now_days, idxs_full[:, :r], vals_full[:, :r],
    )
    return compact_select(vals_full, idxs_full, refined, t_out, r)


def compact_select(vals_full, idxs_full, refined, t_out: int, r: int):
    """Co-sort the top-``r`` scan candidates by min(scan bound, refined
    bound) and return the top-t_out slice plus the single certificate
    bound (refine.py compact_select: every dropped row stays covered by one
    of the three max'ed bounds)."""
    b, m1 = vals_full.shape
    m = m1 - 1
    rows = idxs_full[:, :r]
    ubs = torch.minimum(vals_full[:, :r], refined)  # min of sound bounds
    k = min(t_out, r)
    top_v, top_i = top_k_with_payload(ubs, rows, min(t_out + 1, r))
    if top_v.shape[1] > k:
        tail = top_v[:, k]
    else:
        tail = torch.full((b,), float("-inf"), dtype=top_v.dtype, device=top_v.device)
    bound = torch.maximum(vals_full[:, -1], tail)
    if r < m:
        # first refine-skipped candidate: sound over positions r..m-1
        # (sorted descending)
        bound = torch.maximum(bound, vals_full[:, r])
    return top_i[:, :k].contiguous(), top_v[:, :k], bound


def direct_select_from_scan(vals_full: torch.Tensor, idxs_full: torch.Tensor, t_out: int):
    """Top-t_out slice of the scan/merge output (sorted descending by scan
    bound) plus one certificate bound

        bound = max(scan boundary,            # rows the scan excluded
                    (t_out+1)-th scan bound)  # candidates the slice dropped

    so every row not in the slice has a sound upper bound <= ``bound``; the
    engine's certificate check is unchanged. The Engine:DirectSelect fast
    path: no refine, at the price of a bound ~4e-3 looser; also the only
    compact path for an index without residual planes. Returns
    (rows [B, k], ubs [B, k], bound [B]), k = min(t_out, m)."""
    b, m1 = vals_full.shape
    m = m1 - 1
    k = min(t_out, m)
    rows = idxs_full[:, :k]
    ubs = vals_full[:, :k]
    if m > k:
        tail = vals_full[:, k]
    else:
        tail = torch.full((b,), float("-inf"), dtype=vals_full.dtype, device=vals_full.device)
    bound = torch.maximum(vals_full[:, -1], tail)
    return rows, ubs, bound
