"""Hybrid upper-bound scans: CUDA kernels and their plain versions.

Counterpart of omni_recall_tpu/ops/pallas_scorer.py (the fused Pallas TPU
kernels). Four scans, each a hand-written CUDA kernel (csrc/scan.cu,
csrc/fp_scan.cu) with a plain PyTorch version of the same function beside
it, written from the JAX graph:

- K1 ``block_topt_int8_coarse`` — cosine-only scan, keyword capped per query
  (pallas_scorer.py _make_topt_kernel_int8_coarse_keys_t, and the pair emit
  _make_topt_kernel_int8_coarse, K7a). The TPU emit layouts (``emit_keys``
  "t", True or False: transposed keys, B-major keys (K7b), pairs) all
  decode to the same values, so the port has one kernel and no such
  parameter; the config's ``packed_emit`` / ``transposed_emit`` keys select
  nothing here.
- K4 ``block_topt_int8`` — full fused int8 cosine + bloom keyword scan
  (_make_topt_kernel_int8), the certificate-miss rescue scan.
- K5 ``block_topt_kw_only`` — bloom-only scan for queries without an
  embedding (_make_topt_kernel_kw_only).
- K6 ``block_topt`` — the fused scan over f32 or bf16 scan storage
  (_make_topt_kernel / _ub_block): bf16 operands, f32 sums, eps
  PALLAS_CERT_EPS. The TPU sums its dot products in the MXU's order, which
  nothing fixes; the port fixes one (each (row, query) pair sums its
  products in k order, cosine terms then keyword terms, csrc/fp_scan.cu) and
  the plain version follows it, so kernel and plain version agree bit for
  bit. Against the TPU kernel the sums agree to within the rounding of a
  reordered f32 sum (tests/test_torch_scorer.py states the bound).

Each returns the [B, N/sub, t1] (vals f32, idxs i32) contract of the TPU
kernels: per extraction slice of ``sub`` rows the top-(t1-1) entries plus a
bound (the t1-th best; index -2), in the same extraction mode the JAX code
picks for the shape (_extract_topt: packed keys when ``sub`` is a power of
two and t1 >= 3, else value/index two-reduce). The contract depends on
(sub, t) only, so the CUDA tiling is free to differ from the TPU block ``c``;
``c`` still decides the effective ``sub = min(sub, c)`` exactly as on the
TPU, so the same call gives the same contract.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain version. Nothing falls back from one to the other. The plain
versions are public (``*_plain``) so the chip check can hold each kernel
against its plain version on the card.

Exactness contract and soundness notes are the JAX module's (see its
docstrings): int8 dot products are exact integers, keyword weights are
ceil-quantized, the per-row / per-query quantization error is folded into
``add_row`` / ``q_bias`` only via ``prepare_int8_query`` / ``coarse_q_bias``
/ ``quantize_kw_weights``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.merge import top_k_with_payload
from omni_recall_tpu_torch.ops.oracle import (
    COSINE_WEIGHT,
    KEYWORD_WEIGHT,
    RECENCY_HALF_LIFE_DAYS,
    RECENCY_WEIGHT,
)

_NEG_INF = -1e30  # finite mask value inside the scans; mapped to -inf outside
_INT_MIN = -(2**31)
PALLAS_CERT_EPS_INT8 = 4e-3
# the f32/bf16 scan's certificate margin (pallas_scorer.py PALLAS_CERT_EPS:
# both bf16 operands' rounding plus f32 accumulation)
PALLAS_CERT_EPS = 8e-3
# candidates emitted per extraction slice at most (engine PALLAS_BLOCK_T)
PALLAS_BLOCK_T = 8

_MODE_COARSE, _MODE_FUSED, _MODE_KW = 0, 1, 2
_KERNEL_NAME = {_MODE_COARSE: "coarse_scan", _MODE_FUSED: "fused_scan",
                _MODE_KW: "kw_scan"}
# scan storage types of K6 (DeviceIndex scan_dtype f32 / bf16)
FP_DTYPES = (torch.float32, torch.bfloat16)


# ---- block-size picks (pallas_scorer.py _pick_block / _pick_block_coarse) ----


def _pick_block(n: int, itemsize: int = 4) -> int:
    candidates = (2048, 1024, 512, 256, 128) if itemsize <= 2 else (1024, 512, 256, 128)
    for c in candidates:
        if n % c == 0:
            return c
    return 0


def _pick_block_coarse(n: int) -> int:
    for c in (2048, 1024, 512, 256, 128):
        if n % c == 0:
            return c
    return 0


def _coarse_layout(
    n_rows: int, m: int, block: int,
    sub_override: int = 0, t_override: int = 0,
    prefer_shallow: bool = False,
) -> tuple[int, int] | None:
    """The coarse / keyword-only scan's (sub, t) — search/engine.py
    _coarse_layout verbatim (see its docstring for the sweep behind each
    rule): the widest sub-slice whose slices*t still covers ~4m candidates,
    t floored at 4; ``prefer_shallow`` takes (512, 2) at >= 2048 slices."""
    import math

    if prefer_shallow and not sub_override and not t_override:
        sub = min(512, block)
        if sub == 512 and n_rows // sub >= 2048 and m <= (n_rows // sub) * 2:
            return sub, 2

    subs = (sub_override,) if sub_override else (1024, 512, 256, 128, 64, 32)
    for sub_try in subs:
        sub = min(sub_try, block)
        slices = n_rows // sub
        if slices < 1:
            continue
        if t_override:
            t = min(t_override, PALLAS_BLOCK_T, sub - 1)
        else:
            t = min(PALLAS_BLOCK_T, sub - 1, max(4, math.ceil(4 * m / slices)))
        if t >= 1 and m <= slices * t:
            return sub, t
    return None


# ---- query / row operands (soundness-critical: the single source) ----


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum per row of a [R, d] tensor, accumulated in the order XLA's
    CPU reduction uses for rows that are a multiple of 32 wide: 32-element
    blocks summed sequentially, the block sums added in order (a trailing
    partial block element by element). The JAX graphs take these sums with
    ``jnp.sum`` / ``jnp.linalg.norm``; the same order keeps the port's
    values bitwise equal to them where the tests hold the two side by side.
    Any order is sound for the bounds built from them (their (1 + 1e-6) /
    (1 + 1e-4) slack covers f32 rounding)."""
    r, d = x.shape
    full = d - d % 32
    out = torch.zeros(r, dtype=x.dtype, device=x.device)
    if full:
        blocks = x[:, :full].reshape(r, full // 32, 32)
        acc = torch.zeros(r, full // 32, dtype=x.dtype, device=x.device)
        for i in range(32):
            acc = acc + blocks[:, :, i]
        for j in range(full // 32):
            out = out + acc[:, j]
    for i in range(full, d):
        out = out + x[:, i]
    return out


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm per row (``jnp.linalg.norm(x, axis=1)``), summed as row_sum."""
    return torch.sqrt(row_sum(x * x))


def quantize_queries_int8(q: torch.Tensor):
    """Per-query symmetric int8 quantization + sound error-norm bound.
    Returns (q8 i8[B, d], q_scale f32[B, 1], eq f32[B, 1]). The scale is
    ``absmax * fl32(1/127)``: XLA's jit rewrites the JAX graph's division by
    the constant 127 into that multiply (measured), and the serving graphs
    run under jit. The quantization itself divides by the scale
    (``q / safe``), as the JAX graph does; any scale is sound because eq is
    the norm of the actual residual."""
    q_absmax = q.abs().amax(dim=1, keepdim=True)
    q_scale = q_absmax * (1.0 / 127.0)  # XLA's jit form of `q_absmax / 127.0`
    safe = torch.where(q_scale > 0, q_scale, torch.ones_like(q_scale))
    q8 = torch.clamp(torch.round(q / safe), -127, 127).to(torch.int8)
    # the residual as XLA's jit contracts it: fma(-q8, q_scale, q)
    eq = row_norm(_fma32(-q8.to(torch.float32), q_scale, q))[:, None]
    eq = eq * (1.0 + 1e-6)
    return q8, q_scale, eq


def prepare_int8_query(q: torch.Tensor, err_row: torch.Tensor):
    """(q8, q_scale, eq, err_term) with
    err_term = COSINE_WEIGHT * (1 + max(eq)) * err_row — THE single source of
    the int8 certificate's error construction (pallas_scorer.py
    prepare_int8_query)."""
    q8, q_scale, eq = quantize_queries_int8(q)
    err_term = COSINE_WEIGHT * (1.0 + eq.max()) * err_row
    return q8, q_scale, eq, err_term


def coarse_q_bias(eq: torch.Tensor, kw_weights: torch.Tensor, kw_bias: torch.Tensor):
    """Coarse-scan per-query bias: cosine quantization error + the keyword
    cap KEYWORD_WEIGHT * min(1, sum_w + bias)."""
    kw_cap = torch.clamp_max(row_sum(kw_weights) + kw_bias, 1.0)[:, None]
    return _fma32(COSINE_WEIGHT, eq, KEYWORD_WEIGHT * kw_cap)  # XLA's contraction


def quantize_kw_weights(kw_weights: torch.Tensor) -> torch.Tensor:
    """Ceil-quantize keyword weights to int8 (w8/127 >= w: sound)."""
    return torch.clamp(torch.ceil(kw_weights * 127.0), 0, 127).to(torch.int8)


def make_add_row(created, valid, now_days, window_start, row_offset=0,
                 err_term=None) -> torch.Tensor:
    """Per-row additive term [1, N]: 0.1*recency (+ optional per-row error
    bound) for live in-window rows, -1e30 otherwise."""
    n = created.shape[0]
    # XLA's jit rewrites the division by the constant half-life into a
    # multiply by its f32 reciprocal; the port writes that form
    rec = torch.exp(torch.clamp_max(created - now_days, 0.0) * (1.0 / RECENCY_HALF_LIFE_DAYS))
    if err_term is not None:
        live = _fma32(RECENCY_WEIGHT, rec, err_term)  # contracted, as in XLA
    else:
        live = RECENCY_WEIGHT * rec
    rows = torch.arange(n, dtype=torch.int32, device=created.device) + row_offset
    mask = valid & (rows >= window_start)
    return torch.where(mask, live, torch.full_like(live, _NEG_INF))[None, :]


# ---- plain versions (from the JAX graphs) ----


@contextlib.contextmanager
def _no_tf32():
    """f32 matmuls on the card in full f32 for the block (TF32 would round
    the int8 operands' products); the caller's setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer dot products a[M, K] . b[N, K] -> f32[M, N], as the
    TPU's int32 MXU accumulation gives them. f32 (or, for K*127^2 >= 2^24,
    f64) products and partial sums of int8 values are exact integers, in
    any summation order, so this matmul stands in for the int32 one."""
    k = a.shape[1]
    dt = torch.float32 if k * 127 * 127 < 2**24 else torch.float64
    with _no_tf32():
        return (a.to(dt) @ b.to(dt).T).to(torch.float32)


def _bloom_bits(bloom: torch.Tensor) -> torch.Tensor:
    """u8[N, W] -> 0/1 [N, 8W]; column b*W + w is bit b of word w."""
    words = bloom.to(torch.int32)
    return torch.cat([(words >> b) & 1 for b in range(8)], dim=1)


def _packed_mode(sub: int, t1: int) -> bool:
    return sub & (sub - 1) == 0 and sub >= 2 and t1 >= 3


def decode_up(keys: torch.Tensor, sub: int) -> torch.Tensor:
    """Packed keys (any shape) -> f32 upper bounds with the lane bits forced
    to 1 (sound, inflated < sub ulps)."""
    y = keys | (sub - 1)
    return (y ^ ((y >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _decode_keys(keys: torch.Tensor, sub: int):
    """Packed keys [B, slices, t1] -> (vals, idxs) — pallas_scorer.py
    _decode_keys / _decode_keys_t math: ``decode_up`` values, the index is
    the inverted low bits plus the slice's global base, bound entries carry
    -2."""
    b, slices, t1 = keys.shape
    lmask = sub - 1
    vals = decode_up(keys, sub)
    lane = lmask - (keys & lmask)
    base = (torch.arange(slices, dtype=torch.int32, device=keys.device) * sub)[None, :, None]
    idxs = (lane + base).to(torch.int32)
    idxs[:, :, t1 - 1] = -2
    return vals, idxs


def _packed_keys_plain(scores: torch.Tensor, sub: int, t1: int) -> torch.Tensor:
    """The packed-key rounds of _extract_topt over [B, N] scores (sub a
    power of two): per slice the t1 - 1 largest keys, each masking every
    entry equal to it, then the largest left (the bound). Returns the raw
    keys [B, N/sub, t1]."""
    b, n = scores.shape
    s = scores.reshape(b, n // sub, sub)
    lmask = sub - 1
    s_i = s.view(torch.int32)
    key_full = s_i ^ ((s_i >> 31) & 0x7FFFFFFF)
    lane = torch.arange(sub, dtype=torch.int32, device=scores.device)
    keys = (key_full & ~lmask) | (lmask - (lane & lmask))
    cols = []
    for _ in range(t1 - 1):
        kmax = keys.amax(dim=-1, keepdim=True)
        cols.append(kmax)
        keys = torch.where(keys == kmax, torch.full_like(keys, _INT_MIN), keys)
    cols.append(keys.amax(dim=-1, keepdim=True))
    return torch.cat(cols, dim=-1)


def _extract_topt_plain(scores: torch.Tensor, sub: int, t1: int):
    """_extract_topt over [B, N] scores -> (vals, idxs) [B, N/sub, t1]."""
    if _packed_mode(sub, t1):
        return _decode_keys(_packed_keys_plain(scores, sub, t1), sub)
    b, n = scores.shape
    s = scores.reshape(b, n // sub, sub)
    dev = scores.device
    lane = torch.arange(sub, dtype=torch.int32, device=dev)
    base = (torch.arange(n // sub, dtype=torch.int32, device=dev) * sub)[None, :, None]
    vcols, icols = [], []
    for _ in range(t1 - 1):
        v = s.amax(dim=-1, keepdim=True)
        hit = torch.where(s == v, lane, torch.full_like(lane, sub))
        idx = hit.amin(dim=-1, keepdim=True)  # lowest lane among ties
        vcols.append(v)
        icols.append(idx + base)
        s = torch.where(lane == idx, torch.full_like(s, _NEG_INF), s)
    vcols.append(s.amax(dim=-1, keepdim=True))
    icols.append(torch.full((b, n // sub, 1), -2, dtype=torch.int32, device=dev))
    return torch.cat(vcols, dim=-1), torch.cat(icols, dim=-1).to(torch.int32)


def _fma32(a, b, c) -> torch.Tensor:
    """fl32(a * b + c) rounded once, like a hardware fused multiply-add.

    XLA's CPU compiler contracts these multiply-adds of the JAX graphs into
    FMAs (measured: the interpret-mode kernels agree bitwise with nothing
    else), so the port makes the same contractions explicit, here and as
    __fmaf_rn in csrc/scan.cu. Soundness is unaffected: an FMA evaluates
    the same expression with one rounding fewer, inside the certificate's
    f32 slack. Emulated exactly in f64: a*b is exact there, TwoSum gives the
    exact remainder of the sum, and rounding to odd before the final f32
    rounding removes double rounding (Boldo-Melquiond)."""
    # python scalars stay host values (rounded to f32 first, as the JAX
    # graph's weak-typed constants are): creating a device tensor from one
    # would be a synchronizing host-to-device copy
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))
               for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    bits = s.contiguous().view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bits = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def _coarse_scores_plain(emb8, q8, add_row, scale_row, q_scale, q_bias):
    cosd = _int_dot(q8, emb8)  # [B, N]
    return _fma32(cosd * q_scale, scale_row, add_row) + q_bias + PALLAS_CERT_EPS_INT8


def _kw_term_plain(bloom, kw_w8, kw_b):
    kwd = _int_dot(kw_w8, _bloom_bits(bloom))
    return torch.clamp_max(_fma32(kwd, 1.0 / 127.0, kw_b), 1.0)


def _fused_scores_plain(emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, q_scale, q_bias):
    cos = _int_dot(q8, emb8) * q_scale * scale_row
    kw = _kw_term_plain(bloom, kw_w8, kw_b)
    return (_fma32(COSINE_WEIGHT, cos, KEYWORD_WEIGHT * kw) + add_row + q_bias
            + PALLAS_CERT_EPS_INT8)


def _kw_scores_plain(bloom, kw_w8, kw_b, add_row):
    kw = _kw_term_plain(bloom, kw_w8, kw_b)
    return _fma32(KEYWORD_WEIGHT, kw, add_row) + PALLAS_CERT_EPS_INT8


def _by_query_chunks(fn, per_query: tuple, shared: tuple, sub: int, t1: int,
                     chunk: int = 64):
    """Score + extract ``chunk`` queries at a time (the plain versions'
    [B, N] intermediates stay bounded at the serving sizes); ``per_query``
    operands are sliced along dim 0."""
    b = per_query[0].shape[0]
    outs = [
        _extract_topt_plain(
            fn(*(x[i:i + chunk] for x in per_query), *shared), sub, t1)
        for i in range(0, b, chunk)
    ]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# ---- layouts (the TPU block pick decides the effective sub) ----


def _coarse_shape(n: int, b: int, t: int, sub: int, block: int | None):
    c = block if block is not None and n % block == 0 else _pick_block_coarse(n)
    if c == 0:
        raise ValueError(f"row count {n} not divisible by a supported block")
    if b >= 1024 and t > 2 and c > 1024 and n % 1024 == 0 and block is None:
        c = 1024
    sub = min(sub, c)
    return sub, min(t + 1, sub)


def _fused_shape(n: int, b: int, t: int, sub: int):
    c = _pick_block(n, 1)
    if c == 0:
        raise ValueError(f"row count {n} not divisible by a supported block")
    if b >= 1024 and c > 512:
        c = 512
    elif b >= 256 and c > 1024:
        c = 1024
    sub = min(sub, c)
    return sub, min(t + 1, sub)


def _kw_shape(n: int, w: int, t: int, sub: int):
    c = _pick_block(n, 1)
    if c == 0:
        raise ValueError(f"row count {n} not divisible by a supported block")
    if w < 128 and c > 1024:
        c = 1024
    sub = min(sub, c)
    return sub, min(t + 1, sub)


# ---- CUDA launch ----


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _check_cuda_operands(device, **tensors) -> None:
    for name, (x, dtype, shape) in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _scan_cuda(mode: int, n: int, b: int, sub: int, t1: int, *, emb8=None,
               bloom=None, q8=None, kw_w8=None, kw_b=None, add_row,
               scale_row=None, q_scale=None, q_bias=None):
    """Launch csrc/scan.cu for one scan; returns (vals, idxs) [B, N/sub, t1]."""
    dev = add_row.device
    f32, i8 = torch.float32, torch.int8
    ops = {"add_row": (add_row, f32, (n,))}
    d = w = 0
    if mode != _MODE_KW:
        d = emb8.shape[1]
        if d % 16:
            raise ValueError(f"the CUDA scan needs d % 16 == 0, got d={d}")
        ops.update(emb8=(emb8, i8, (n, d)), q8=(q8, i8, (b, d)),
                   scale_row=(scale_row, f32, (n,)), q_scale=(q_scale, f32, (b,)),
                   q_bias=(q_bias, f32, (b,)))
    if mode != _MODE_COARSE:
        w = bloom.shape[1]
        if w % 2:
            raise ValueError(f"the CUDA scan needs an even bloom width, got W={w}")
        ops.update(bloom=(bloom, torch.uint8, (n, w)), kw_w8=(kw_w8, i8, (b, 8 * w)),
                   kw_b=(kw_b, f32, (b,)))
    if sub % 64 and 64 % sub:
        raise ValueError(f"the CUDA scan needs sub % 64 == 0 or 64 % sub == 0, got {sub}")
    if n % max(sub, 64):
        raise ValueError(f"the CUDA scan needs N % max(sub, 64) == 0, got N={n}")
    _check_cuda_operands(dev, **ops)
    vals = torch.empty((b, n // sub, t1), dtype=f32, device=dev)
    idxs = torch.empty((b, n // sub, t1), dtype=torch.int32, device=dev)
    lib = cuda.library("scan")
    rc = lib.omni_scan_topt(
        _ptr(emb8), _ptr(bloom), _ptr(q8), _ptr(kw_w8), _ptr(kw_b), _ptr(add_row),
        _ptr(scale_row), _ptr(q_scale), _ptr(q_bias), _ptr(vals), _ptr(idxs),
        n, d, w, b, sub, t1, mode, int(_packed_mode(sub, t1)), cuda.stream_ptr(dev),
    )
    cuda.check(lib, rc, _KERNEL_NAME[mode])
    pair = mode == _MODE_COARSE and not _packed_mode(sub, t1)
    cuda.count_launch("coarse_pair" if pair else _KERNEL_NAME[mode])
    return vals, idxs


def _require_cpu(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}; tensors must be CUDA or CPU")


# ---- K1: coarse int8 scan ----


def block_topt_int8_coarse_plain(emb8, q8, add_row, scale_row, q_scale, q_bias,
                                 t: int, sub: int = 512, block: int | None = None):
    """Plain PyTorch K1 (pallas_scorer.py block_topt_int8_coarse)."""
    sub, t1 = _coarse_shape(emb8.shape[0], q8.shape[0], t, sub, block)
    q_scale = COSINE_WEIGHT * q_scale
    return _by_query_chunks(
        lambda q8_, qs_, qb_, *rest: _coarse_scores_plain(rest[0], q8_, rest[1], rest[2], qs_, qb_),
        (q8, q_scale, q_bias), (emb8, add_row, scale_row), sub, t1)


def block_topt_int8_coarse(emb8, q8, add_row, scale_row, q_scale, q_bias,
                           t: int, sub: int = 512, block: int | None = None):
    """Coarse (keyword-capped) int8 scan, K1. add_row/scale_row f32[1, N],
    q_scale/q_bias f32[B, 1]."""
    if not emb8.is_cuda:
        _require_cpu(emb8)
        return block_topt_int8_coarse_plain(
            emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, block)
    n, b = emb8.shape[0], q8.shape[0]
    sub, t1 = _coarse_shape(n, b, t, sub, block)
    return _scan_cuda(
        _MODE_COARSE, n, b, sub, t1, emb8=emb8, q8=q8,
        add_row=add_row.reshape(-1), scale_row=scale_row.reshape(-1),
        q_scale=(COSINE_WEIGHT * q_scale).reshape(-1), q_bias=q_bias.reshape(-1),
    )


# ---- K4: full fused int8 scan ----


def block_topt_int8_plain(emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row,
                          q_scale, q_bias, t: int, sub: int = 512):
    """Plain PyTorch K4 (pallas_scorer.py block_topt_int8)."""
    sub, t1 = _fused_shape(emb8.shape[0], q8.shape[0], t, sub)
    return _by_query_chunks(
        lambda q8_, kw_, kb_, qs_, qb_, emb8_, bloom_, ar_, sr_: _fused_scores_plain(
            emb8_, bloom_, q8_, kw_, kb_, ar_, sr_, qs_, qb_),
        (q8, kw_w8, kw_b, q_scale, q_bias), (emb8, bloom, add_row, scale_row), sub, t1)


def block_topt_int8(emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, q_scale,
                    q_bias, t: int, sub: int = 512):
    """Full fused int8 + keyword scan, K4. kw_w8 i8[B, 8W] (ceil-quantized),
    kw_b/q_scale/q_bias f32[B, 1], add_row/scale_row f32[1, N]."""
    if not emb8.is_cuda:
        _require_cpu(emb8)
        return block_topt_int8_plain(emb8, bloom, q8, kw_w8, kw_b, add_row,
                                     scale_row, q_scale, q_bias, t, sub)
    n, b = emb8.shape[0], q8.shape[0]
    sub, t1 = _fused_shape(n, b, t, sub)
    return _scan_cuda(
        _MODE_FUSED, n, b, sub, t1, emb8=emb8, bloom=bloom, q8=q8, kw_w8=kw_w8,
        kw_b=kw_b.reshape(-1), add_row=add_row.reshape(-1),
        scale_row=scale_row.reshape(-1), q_scale=q_scale.reshape(-1),
        q_bias=q_bias.reshape(-1),
    )


# ---- K5: keyword-only scan ----


def block_topt_kw_only_plain(bloom, kw_w8, kw_b, add_row, t: int, sub: int = 512):
    """Plain PyTorch K5 (pallas_scorer.py block_topt_kw_only)."""
    sub, t1 = _kw_shape(bloom.shape[0], bloom.shape[1], t, sub)
    return _by_query_chunks(
        lambda kw_, kb_, bloom_, ar_: _kw_scores_plain(bloom_, kw_, kb_, ar_),
        (kw_w8, kw_b), (bloom, add_row), sub, t1)


def block_topt_kw_only(bloom, kw_w8, kw_b, add_row, t: int, sub: int = 512):
    """Keyword-only scan, K5 (no embedding stream: cosine is exactly 0)."""
    if not bloom.is_cuda:
        _require_cpu(bloom)
        return block_topt_kw_only_plain(bloom, kw_w8, kw_b, add_row, t, sub)
    n, w = bloom.shape
    sub, t1 = _kw_shape(n, w, t, sub)
    return _scan_cuda(
        _MODE_KW, n, kw_w8.shape[0], sub, t1, bloom=bloom, kw_w8=kw_w8,
        kw_b=kw_b.reshape(-1), add_row=add_row.reshape(-1),
    )


# ---- K6: fused f32/bf16 scan ----


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest, ties to even) and widened back to f32 —
    the TPU kernel's ``astype(jnp.bfloat16)`` of each operand."""
    return x.to(torch.bfloat16).to(torch.float32)


def _seq_dot(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a[M, K] . bt[K, N] -> f32[M, N] summed in k order, one product and
    one f32 addition per term (``acc + a_k * b_k``, two roundings): the
    order and the operations of csrc/fp_scan.cu. Columns of ``a`` that are
    zero in every row are skipped: their products are zeros, and adding a
    zero leaves a sum that starts at +0 unchanged."""
    acc = torch.zeros((a.shape[0], bt.shape[1]), dtype=torch.float32, device=a.device)
    for k in torch.nonzero((a != 0).any(dim=0)).flatten().tolist():
        acc = acc + a[:, k:k + 1] * bt[k]
    return acc


def _fp_scores_plain(q, kw_w, kw_b, emb_t, bits_t, add_row):
    """_ub_block with the port's fixed sum order. ``emb_t`` [d, N] and
    ``bits_t`` [8W, N] are the bf16-rounded rows and the 0/1 bloom bits,
    transposed so each term's row operand is contiguous."""
    cos = _seq_dot(_bf16_round(q), emb_t)
    kw = torch.clamp_max(_seq_dot(_bf16_round(kw_w), bits_t) + kw_b, 1.0)
    return (_fma32(COSINE_WEIGHT, cos, KEYWORD_WEIGHT * kw) + add_row
            + PALLAS_CERT_EPS)


def _fp_shape(n: int, dtype: torch.dtype, t: int, sub: int):
    if dtype not in FP_DTYPES:
        raise ValueError(f"K6 scans f32 or bf16 rows, got {dtype}")
    c = _pick_block(n, 2 if dtype == torch.bfloat16 else 4)
    if c == 0:
        raise ValueError(f"row count {n} not divisible by a supported block")
    sub = min(sub, c)
    return sub, min(t + 1, sub)


def block_topt_plain(emb, bloom, q, kw_weights, kw_bias, add_row, t: int,
                     sub: int = 512):
    """Plain PyTorch K6 (pallas_scorer.py block_topt)."""
    sub, t1 = _fp_shape(emb.shape[0], emb.dtype, t, sub)
    emb_t = _bf16_round(emb.to(torch.float32)).T.contiguous()
    bits_t = _bloom_bits(bloom).T.to(torch.float32).contiguous()
    return _by_query_chunks(
        _fp_scores_plain, (q, kw_weights, kw_bias), (emb_t, bits_t, add_row), sub, t1)


def block_topt(emb, bloom, q, kw_weights, kw_bias, add_row, t: int, sub: int = 512):
    """Fused f32/bf16 scan, K6. emb f32|bf16[N, d], bloom u8[N, W], q
    f32[B, d], kw_weights f32[B, 8W], kw_bias f32[B, 1], add_row f32[1, N].
    Returns (vals f32, idxs i32) [B, N/sub, t1]."""
    if not emb.is_cuda:
        _require_cpu(emb)
        return block_topt_plain(emb, bloom, q, kw_weights, kw_bias, add_row, t, sub)
    (n, d), b, w = emb.shape, q.shape[0], bloom.shape[1]
    sub, t1 = _fp_shape(n, emb.dtype, t, sub)
    if d % 4:
        raise ValueError(f"the CUDA K6 scan needs d % 4 == 0, got d={d}")
    if sub % 64 and 64 % sub:
        raise ValueError(f"the CUDA scan needs sub % 64 == 0 or 64 % sub == 0, got {sub}")
    if n % max(sub, 64):
        raise ValueError(f"the CUDA scan needs N % max(sub, 64) == 0, got N={n}")
    f32 = torch.float32
    kw_b, add_row = kw_bias.reshape(-1), add_row.reshape(-1)
    _check_cuda_operands(
        emb.device, emb=(emb, emb.dtype, (n, d)), bloom=(bloom, torch.uint8, (n, w)),
        q=(q, f32, (b, d)), kw_weights=(kw_weights, f32, (b, 8 * w)),
        kw_bias=(kw_b, f32, (b,)), add_row=(add_row, f32, (n,)),
    )
    vals = torch.empty((b, n // sub, t1), dtype=f32, device=emb.device)
    idxs = torch.empty((b, n // sub, t1), dtype=torch.int32, device=emb.device)
    lib = cuda.library("fp_scan")
    rc = lib.omni_fp_scan_topt(
        _ptr(emb), _ptr(bloom), _ptr(q), _ptr(kw_weights), _ptr(kw_b), _ptr(add_row),
        _ptr(vals), _ptr(idxs), n, d, w, b, sub, t1, int(_packed_mode(sub, t1)),
        int(emb.dtype == torch.bfloat16), cuda.stream_ptr(emb.device),
    )
    cuda.check(lib, rc, "fp_scan")
    cuda.count_launch("fp_scan")
    return vals, idxs


# ---- merge + engine entry points ----


def _merge_topm(vals: torch.Tensor, idxs: torch.Tensor, m: int):
    """[B, slices, t1] -> (ub_values[B, m+1], row_indices[B, m+1]); entry m
    is the certificate boundary (index -1)."""
    b, nb, t1 = vals.shape
    t_eff = t1 - 1
    if m > nb * t_eff:
        raise ValueError(f"m={m} exceeds emitted candidates nblocks*t={nb * t_eff}")
    cand_vals = vals[:, :, :t_eff].reshape(b, nb * t_eff)
    cand_idxs = idxs[:, :, :t_eff].reshape(b, nb * t_eff)
    block_bounds = vals[:, :, t_eff]
    k = min(m + 1, nb * t_eff)
    top_v, top_i = top_k_with_payload(cand_vals, cand_idxs, k)
    ninf = float("-inf")
    top_v = top_v.masked_fill(top_v <= _NEG_INF / 2, ninf)
    if k > m:
        boundary_emitted = top_v[:, m]
    else:
        boundary_emitted = torch.full((b,), ninf, dtype=vals.dtype, device=vals.device)
    block_bound_max = block_bounds.masked_fill(block_bounds <= _NEG_INF / 2, ninf).amax(dim=1)
    boundary = torch.maximum(boundary_emitted, block_bound_max)
    out_v = torch.cat([top_v[:, :m], boundary[:, None]], dim=1)
    out_i = torch.cat(
        [top_i[:, :m], torch.full((b, 1), -1, dtype=torch.int32, device=vals.device)], dim=1
    )
    return out_v, out_i


def score_topm_int8_coarse(emb8, scale_row, err_row, created, valid, q, kw_weights,
                           kw_bias, now_days, window_start, m: int, t: int = 8,
                           sub: int = 512):
    """Coarse int8 scan entry (K1 + merge): cosine + recency, keyword
    bounded by 0.2 * min(1, sum(weights) + bias) per query."""
    q8, q_scale, eq, err_term = prepare_int8_query(q, err_row)
    add_row = make_add_row(created, valid, now_days, window_start, err_term=err_term)
    q_bias = coarse_q_bias(eq, kw_weights, kw_bias)
    vals, idxs = block_topt_int8_coarse(
        emb8, q8, add_row, scale_row[None, :], q_scale, q_bias, t=t, sub=sub,
    )
    return _merge_topm(vals, idxs, m)


def score_topm_int8(emb8, scale_row, err_row, bloom, created, valid, q, kw_weights,
                    kw_bias, now_days, window_start, m: int, t: int = 8, sub: int = 512):
    """Full fused int8 scan entry (K4 + merge)."""
    q8, q_scale, eq, err_term = prepare_int8_query(q, err_row)
    add_row = make_add_row(created, valid, now_days, window_start, err_term=err_term)
    q_bias = COSINE_WEIGHT * eq
    kw_w8 = quantize_kw_weights(kw_weights)
    vals, idxs = block_topt_int8(
        emb8, bloom, q8, kw_w8, kw_bias[:, None], add_row, scale_row[None, :],
        q_scale, q_bias, t=t, sub=sub,
    )
    return _merge_topm(vals, idxs, m)


def score_topm_kw_only(bloom, created, valid, kw_weights, kw_bias, now_days,
                       window_start, m: int, t: int = 8, sub: int = 512):
    """Keyword-only scan entry (K5 + merge): no emb read, no quantization
    error term."""
    add_row = make_add_row(created, valid, now_days, window_start)
    kw_w8 = quantize_kw_weights(kw_weights)
    vals, idxs = block_topt_kw_only(bloom, kw_w8, kw_bias[:, None], add_row, t=t, sub=sub)
    return _merge_topm(vals, idxs, m)


def score_topm(emb, bloom, created, valid, q, kw_weights, kw_bias, now_days,
               window_start, m: int, t: int = 8, sub: int = 512):
    """f32/bf16 scan entry (K6 + merge): no quantization error term; the
    bf16 rounding of both operands is inside PALLAS_CERT_EPS."""
    add_row = make_add_row(created, valid, now_days, window_start)
    vals, idxs = block_topt(emb, bloom, q, kw_weights, kw_bias[:, None], add_row,
                            t=t, sub=sub)
    return _merge_topm(vals, idxs, m)
