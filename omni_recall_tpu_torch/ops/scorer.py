"""Hybrid upper-bound scans: CUDA kernels and their plain versions.

Counterpart of omni_recall_tpu/ops/pallas_scorer.py (the fused Pallas TPU
kernels). Four scans, each a hand-written CUDA kernel (csrc/int8_coarse.cu,
csrc/int8_scan.cu, csrc/fp_scan.cu) with a plain PyTorch version of the
same function beside it, written from the JAX graph:

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
  K1, K4 and K5 run on the tensor cores (int8 ``wgmma``; K1 in
  csrc/int8_coarse.cu, its extraction in registers, and for the shapes that
  kernel does not take in its first design in csrc/int8_scan.cu beside K4
  and K5, the keyword weights in ``int8_kw_columns`` order); their int32
  sums are exact in any order, so they match their plain versions bit for
  bit.
- K6 ``block_topt`` — the fused scan over f32 or bf16 scan storage
  (_make_topt_kernel / _ub_block): bf16 operands, f32 sums, eps
  PALLAS_CERT_EPS. The TPU sums its dot products in the MXU's order and the
  card's kernel in its tensor cores' (csrc/fp_scan.cu, wgmma); neither order
  is fixed. The plain version sums in k order (``_seq_dot``). Kernel, plain
  version and TPU kernel agree bit for bit where every partial sum is exact,
  and elsewhere within ``fp_order_bound``, the bound of two f32 sums of the
  same terms in any order with truncating accumulation.

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
from omni_recall_tpu_torch.utils import tracing

_NEG_INF = -1e30  # finite mask value inside the scans; mapped to -inf outside
_INT_MIN = -(2**31)
PALLAS_CERT_EPS_INT8 = 4e-3
# the f32/bf16 scan's certificate margin (pallas_scorer.py PALLAS_CERT_EPS:
# both bf16 operands' rounding plus f32 accumulation)
PALLAS_CERT_EPS = 8e-3
# candidates emitted per extraction slice at most (engine PALLAS_BLOCK_T)
PALLAS_BLOCK_T = 8

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


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA and CUDA's ``sqrtf`` give
    it. PyTorch's vectorized CPU ``sqrt`` is not correctly rounded on every
    instruction set (on AVX-512 hosts about a quarter of the f32 results
    are one ulp off), so on the CPU the root is taken by numpy, whose f32
    ``sqrt`` is the correctly rounded hardware instruction."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.detach().contiguous().numpy()))


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm per row (``jnp.linalg.norm(x, axis=1)``), summed as row_sum."""
    return sqrt32(row_sum(x * x))


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
    __fmaf_rn in the CUDA sources. Soundness is unaffected: an FMA evaluates
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


def _outputs(b: int, n: int, sub: int, t1: int, device):
    return (torch.empty((b, n // sub, t1), dtype=torch.float32, device=device),
            torch.empty((b, n // sub, t1), dtype=torch.int32, device=device))


INT8_TILE_ROWS = 128  # rows of one tile of csrc/int8_scan.cu (kTileRows)
_kw8_columns_cache: dict = {}


def int8_kw_columns(w: int, device=None) -> torch.Tensor:
    """The keyword operand's column order of K4, K5 and T5 in
    csrc/int8_scan.cu. Kernel column 32·ks + c, with ks = 4·v + p, is bit
    plane 2p + c div 16 of bloom byte quad·W'/4 + 4·v + c mod 4 (quad =
    (c mod 16) div 4, W' = W rounded up to 16): the four A bytes a thread
    holds for a row in k-step ks are one bit plane of its v-th word of four
    bloom bytes, so one 32-bit load a row gives four k-steps (T5 first
    stages its transposed bloom into rows in shared memory). Entry: the JAX
    bit column bit·W + byte, or 8W (a zero column) for a byte past W.
    Cached per (W, device)."""
    key = (w, str(device))
    cols = _kw8_columns_cache.get(key)
    if cols is None:
        wp = -(-w // 16) * 16
        kcol = np.arange(8 * wp)
        ks, c = kcol // 32, kcol % 32
        v, p = ks // 4, ks % 4
        byte = (c % 16) // 4 * (wp // 4) + 4 * v + c % 4
        bit = 2 * p + c // 16
        cols = torch.as_tensor(np.where(byte < w, bit * w + byte, 8 * w), device=device)
        _kw8_columns_cache[key] = cols
    return cols


def int8_kw_operand(kw_w8: torch.Tensor, w: int) -> torch.Tensor:
    """The kernel's keyword operand, i8 [B, 8·W']: kw_w8's columns in
    ``int8_kw_columns`` order, zero columns past W."""
    kw = torch.cat([kw_w8, kw_w8.new_zeros((kw_w8.shape[0], 1))], dim=1)
    return kw[:, int8_kw_columns(w, kw_w8.device)]


def int8_query_tile(sub: int, d: int, w: int = 0) -> int:
    """Queries one block of csrc/int8_scan.cu scores (its wgmma N): K4 over
    W bloom bytes, or at ``w`` = 0 K1's first design (scores staged in
    shared memory; the tile T2 and T4 take too), at extraction slices of
    ``sub``. Needs the built library (the card)."""
    return cuda.library("int8_scan").omni_int8_scan_query_tile(sub, d, w)


def coarse_query_tile(sub: int, d: int, t1: int) -> int:
    """Queries one block of K1 scores at extraction slices of ``sub``, t1
    entries a slice and width d: 128 where csrc/int8_coarse.cu takes the
    shape, else the staged design's tile (``int8_query_tile``). Needs the
    built libraries (the card)."""
    qt = cuda.library("int8_coarse").omni_int8_coarse_query_tile(
        d, sub, t1, int(_packed_mode(sub, t1)))
    return qt or int8_query_tile(sub, d)


def _check_int8_shape(n: int, d: int, sub: int) -> None:
    if d % 16:
        raise ValueError(f"the CUDA scan needs d % 16 == 0, got d={d}")
    if sub % INT8_TILE_ROWS and INT8_TILE_ROWS % sub:
        raise ValueError(f"the CUDA scan needs sub % {INT8_TILE_ROWS} == 0 or "
                         f"{INT8_TILE_ROWS} % sub == 0, got {sub}")
    if n % max(sub, INT8_TILE_ROWS):
        raise ValueError(f"the CUDA scan needs N % max(sub, {INT8_TILE_ROWS}) == 0, got N={n}")


def _coarse_cuda(emb8, q8, add_row, scale_row, q_scale, q_bias, t: int, sub: int,
                 block: int | None, staged: bool):
    """Launch K1 (K7a in the two-reduce mode) at the layout ``_coarse_shape``
    gives: csrc/int8_coarse.cu where it takes the shape, else (or given
    ``staged``) the first design in csrc/int8_scan.cu. Returns (vals, idxs)
    [B, N/sub, t1] and the query tile of the kernel that ran."""
    dev = emb8.device
    f32, i8 = torch.float32, torch.int8
    (n, d), b = emb8.shape, q8.shape[0]
    sub, t1 = _coarse_shape(n, b, t, sub, block)
    _check_int8_shape(n, d, sub)
    add_row, scale_row = add_row.reshape(-1), scale_row.reshape(-1)
    q_scale, q_bias = (COSINE_WEIGHT * q_scale).reshape(-1), q_bias.reshape(-1)
    _check_cuda_operands(
        dev, emb8=(emb8, i8, (n, d)), q8=(q8, i8, (b, d)), add_row=(add_row, f32, (n,)),
        scale_row=(scale_row, f32, (n,)), q_scale=(q_scale, f32, (b,)), q_bias=(q_bias, f32, (b,)))
    vals, idxs = _outputs(b, n, sub, t1, dev)
    packed = int(_packed_mode(sub, t1))
    lib = cuda.library("int8_coarse")
    qt = 0 if staged else lib.omni_int8_coarse_query_tile(d, sub, t1, packed)
    ptrs = (_ptr(emb8), _ptr(q8), _ptr(add_row), _ptr(scale_row), _ptr(q_scale), _ptr(q_bias),
            _ptr(vals), _ptr(idxs), n, d, b, sub, t1, packed, cuda.stream_ptr(dev))
    if qt:
        name = "coarse_scan" if packed else "coarse_pair"
        rc = lib.omni_int8_coarse(*ptrs)
    else:
        name = "coarse_staged"
        lib = cuda.library("int8_scan")
        qt = lib.omni_int8_scan_query_tile(sub, d, 0)
        rc = lib.omni_int8_coarse_topt(*ptrs)
    cuda.check(lib, rc, name)
    cuda.count_launch(name)
    return vals, idxs, qt


def _int8_cuda(n: int, b: int, sub: int, t1: int, *, emb8, q8, add_row, scale_row, q_scale,
               q_bias, bloom, kw_w8, kw_b):
    """Launch csrc/int8_scan.cu's K4; returns (vals, idxs) [B, N/sub, t1]."""
    dev = emb8.device
    f32, i8 = torch.float32, torch.int8
    d, w = emb8.shape[1], bloom.shape[1]
    _check_int8_shape(n, d, sub)
    _check_cuda_operands(
        dev, emb8=(emb8, i8, (n, d)), q8=(q8, i8, (b, d)), add_row=(add_row, f32, (n,)),
        scale_row=(scale_row, f32, (n,)), q_scale=(q_scale, f32, (b,)), q_bias=(q_bias, f32, (b,)),
        bloom=(bloom, torch.uint8, (n, w)), kw_w8=(kw_w8, i8, (b, 8 * w)), kw_b=(kw_b, f32, (b,)))
    vals, idxs = _outputs(b, n, sub, t1, dev)
    kw8 = int8_kw_operand(kw_w8, w)
    lib = cuda.library("int8_scan")
    rc = lib.omni_int8_fused_topt(
        _ptr(emb8), _ptr(bloom), _ptr(q8), _ptr(kw8), _ptr(kw_b), _ptr(add_row),
        _ptr(scale_row), _ptr(q_scale), _ptr(q_bias), _ptr(vals), _ptr(idxs),
        n, d, w, b, sub, t1, int(_packed_mode(sub, t1)), cuda.stream_ptr(dev))
    cuda.check(lib, rc, "fused_scan")
    cuda.count_launch("fused_scan")
    return vals, idxs


def int8_kw_query_tile(sub: int, w: int) -> int:
    """Queries one block of K5 (csrc/int8_scan.cu kw_scan_kernel) scores at
    extraction slices of ``sub`` over W bloom bytes. Needs the built library
    (the card)."""
    return cuda.library("int8_scan").omni_int8_kw_query_tile(sub, w)


def _kw_scan_cuda(n: int, b: int, sub: int, t1: int, *, bloom, kw_w8, kw_b, add_row):
    """Launch csrc/int8_scan.cu's keyword-only scan (K5); returns (vals,
    idxs) [B, N/sub, t1]."""
    dev = add_row.device
    w = bloom.shape[1]
    if sub % INT8_TILE_ROWS and INT8_TILE_ROWS % sub:
        raise ValueError(f"the CUDA scan needs sub % {INT8_TILE_ROWS} == 0 or "
                         f"{INT8_TILE_ROWS} % sub == 0, got {sub}")
    if n % max(sub, INT8_TILE_ROWS):
        raise ValueError(f"the CUDA scan needs N % max(sub, {INT8_TILE_ROWS}) == 0, got N={n}")
    _check_cuda_operands(
        dev, add_row=(add_row, torch.float32, (n,)), bloom=(bloom, torch.uint8, (n, w)),
        kw_w8=(kw_w8, torch.int8, (b, 8 * w)), kw_b=(kw_b, torch.float32, (b,)))
    vals, idxs = _outputs(b, n, sub, t1, dev)
    kw8 = int8_kw_operand(kw_w8, w)
    lib = cuda.library("int8_scan")
    rc = lib.omni_int8_kw_topt(
        _ptr(bloom), _ptr(kw8), _ptr(kw_b), _ptr(add_row), _ptr(vals), _ptr(idxs),
        n, w, b, sub, t1, int(_packed_mode(sub, t1)), cuda.stream_ptr(dev),
    )
    cuda.check(lib, rc, "kw_scan")
    cuda.count_launch("kw_scan")
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
    q_scale/q_bias f32[B, 1]. On the card csrc/int8_coarse.cu, or the first
    design in csrc/int8_scan.cu for the shapes it does not take. The
    ``scan.k1`` span (the host's launch) carries the query tile of the
    kernel that ran (0 on the CPU)."""
    with tracing.span(tracing.SCAN_K1) as sp:
        n, d, b = emb8.shape[0], emb8.shape[1], q8.shape[0]
        if not emb8.is_cuda:
            _require_cpu(emb8)
            if sp:
                sp.set(n, d, b, sub, t, 0)
            return block_topt_int8_coarse_plain(
                emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, block)
        vals, idxs, qt = _coarse_cuda(emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub,
                                      block, staged=False)
        if sp:
            sp.set(n, d, b, sub, t, qt)
        return vals, idxs


def block_topt_int8_coarse_staged(emb8, q8, add_row, scale_row, q_scale, q_bias,
                                  t: int, sub: int = 512, block: int | None = None):
    """K1's first design on the card (csrc/int8_scan.cu, scores staged in
    shared memory) at any shape it takes: the yardstick the card's checks
    hold csrc/int8_coarse.cu to, bitwise and in time."""
    vals, idxs, _ = _coarse_cuda(emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, block,
                                 staged=True)
    return vals, idxs


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
    return _int8_cuda(
        n, b, sub, t1, emb8=emb8, q8=q8, add_row=add_row.reshape(-1),
        scale_row=scale_row.reshape(-1), q_scale=q_scale.reshape(-1),
        q_bias=q_bias.reshape(-1), bloom=bloom, kw_w8=kw_w8, kw_b=kw_b.reshape(-1),
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
    return _kw_scan_cuda(
        n, kw_w8.shape[0], sub, t1, bloom=bloom, kw_w8=kw_w8,
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
    plain version's fixed order, which the tensor-core sums of
    csrc/fp_scan.cu meet under the parity rule (``fp_order_bound``; bit for
    bit on ``fp_exact_operands``). Columns of ``a`` that are
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


FP_CHUNK = 64       # K values of one 128-byte swizzle atom (csrc/fp_scan.cu kChunk)
FP_TILE_ROWS = 128  # rows of one tile of the kernel (kTileRows)
_FP_QT_MAX = 32     # its largest query tile: the operand's rows pad to a multiple
_kw_columns_cache: dict = {}


def fp_kw_columns(w: int, device=None) -> torch.Tensor:
    """The keyword operand's column order in csrc/fp_scan.cu. Kernel column
    16·ks + e, with ks = 8·s + p, is bit plane p of bloom byte
    quad·W'/4 + 4·s + o (quad = (e mod 8) div 2, o = 2·(e div 8) + e mod 2,
    W' = W rounded up to 16): one 32-bit load a row gives a thread its A
    fragments for all eight planes. Entry: the JAX bit column p·W + byte, or
    8W (a zero column) for a byte past W. Cached per (W, device)."""
    key = (w, str(device))
    cols = _kw_columns_cache.get(key)
    if cols is None:
        wp = -(-w // 16) * 16
        kcol = np.arange(8 * wp)
        ks, e = kcol // 16, kcol % 16
        s, p = ks // 8, ks % 8
        byte = (e % 8) // 2 * (wp // 4) + 4 * s + 2 * (e // 8) + e % 2
        cols = torch.as_tensor(np.where(byte < w, p * w + byte, 8 * w), device=device)
        _kw_columns_cache[key] = cols
    return cols


def fp_query_operand(q: torch.Tensor, kw_weights: torch.Tensor, w: int) -> torch.Tensor:
    """The kernel's resident operand, bf16 [B', 64·ceil(d/64) + 8·W']: the
    queries, then the keyword weights in ``fp_kw_columns`` order, each
    rounded to bf16 once a batch (nearest, ties to even, as ``_bf16_round``),
    zero-padded; B' is B rounded up to 32."""
    b, d = q.shape
    dp = -(-d // FP_CHUNK) * FP_CHUNK
    cols = fp_kw_columns(w, q.device)
    bp = -(-b // _FP_QT_MAX) * _FP_QT_MAX
    out = torch.zeros((bp, dp + cols.numel()), dtype=torch.bfloat16, device=q.device)
    out[:b, :d] = q
    kw = torch.cat([kw_weights, kw_weights.new_zeros((b, 1))], dim=1)
    out[:b, dp:] = kw[:, cols]
    return out


def fp_query_tile(variant: int, rows: int, d: int, w: int) -> int:
    """Queries one block of csrc/fp_scan.cu scores (its wgmma N): variant 0
    is K6 at extraction slices of ``rows``, 1-3 the T1 variants at blocks of
    ``rows``. Needs the built library (the card)."""
    return cuda.library("fp_scan").omni_fp_scan_query_tile(variant, rows, d, w)


def _check_fp_cuda(n: int, d: int, rows: int) -> None:
    if d % 4:
        raise ValueError(f"the CUDA K6 scan needs d % 4 == 0, got d={d}")
    if rows % FP_TILE_ROWS and FP_TILE_ROWS % rows:
        raise ValueError(f"the CUDA K6 scan needs sub % {FP_TILE_ROWS} == 0 or "
                         f"{FP_TILE_ROWS} % sub == 0, got {rows}")
    if n % max(rows, FP_TILE_ROWS):
        raise ValueError(f"the CUDA K6 scan needs N % max(sub, {FP_TILE_ROWS}) == 0, got N={n}")


def block_topt(emb, bloom, q, kw_weights, kw_bias, add_row, t: int, sub: int = 512):
    """Fused f32/bf16 scan, K6. emb f32|bf16[N, d], bloom u8[N, W], q
    f32[B, d], kw_weights f32[B, 8W], kw_bias f32[B, 1], add_row f32[1, N].
    Returns (vals f32, idxs i32) [B, N/sub, t1]."""
    if not emb.is_cuda:
        _require_cpu(emb)
        return block_topt_plain(emb, bloom, q, kw_weights, kw_bias, add_row, t, sub)
    (n, d), b, w = emb.shape, q.shape[0], bloom.shape[1]
    sub, t1 = _fp_shape(n, emb.dtype, t, sub)
    _check_fp_cuda(n, d, sub)
    f32 = torch.float32
    kw_b, add_row = kw_bias.reshape(-1), add_row.reshape(-1)
    _check_cuda_operands(
        emb.device, emb=(emb, emb.dtype, (n, d)), bloom=(bloom, torch.uint8, (n, w)),
        q=(q, f32, (b, d)), kw_weights=(kw_weights, f32, (b, 8 * w)),
        kw_bias=(kw_b, f32, (b,)), add_row=(add_row, f32, (n,)),
    )
    qkw = fp_query_operand(q, kw_weights, w)
    vals, idxs = _outputs(b, n, sub, t1, emb.device)
    lib = cuda.library("fp_scan")
    rc = lib.omni_fp_scan_topt(
        _ptr(emb), _ptr(bloom), _ptr(qkw), _ptr(kw_b), _ptr(add_row),
        _ptr(vals), _ptr(idxs), n, d, w, b, qkw.shape[0], sub, t1,
        int(_packed_mode(sub, t1)), int(emb.dtype == torch.bfloat16),
        cuda.stream_ptr(emb.device),
    )
    cuda.check(lib, rc, "fp_scan")
    cuda.count_launch("fp_scan")
    return vals, idxs


# ---- the parity rule of the f32/bf16 scans (K6, T1) ----


def _off_grid(g: torch.Generator, shape, exp: int, signed: bool) -> torch.Tensor:
    """f32 values in the upper half of bf16's binade [2^(exp-1), 2^exp):
    (16k + j + o/4)·u with u = 2^(exp-8) that binade's bf16 ulp, k in 9..15,
    j in {0, 1} bf16's last bit, o in -2..2: 0, ±1/4 ulp or ±1/2 ulp (a
    tie). Rounded to bf16 nearest-even they lie on the grid u."""
    dev = g.device
    k = torch.randint(9, 16, shape, generator=g, device=dev)
    j = torch.randint(0, 2, shape, generator=g, device=dev)
    o = torch.randint(-2, 3, shape, generator=g, device=dev)
    x = (16 * k + j + 0.25 * o).to(torch.float32) * 2.0**(exp - 8)
    if signed:
        x = x * (2 * torch.randint(0, 2, shape, generator=g, device=dev) - 1)
    return x


def fp_exact_operands(g: torch.Generator, n: int, d: int, b: int, w: int):
    """The parity rule's part (i) inputs, on ``g``'s device: rows f32
    [n, d] and queries f32 [b, d] with six nonzero entries in (-1, 1), and
    keyword weights f32 [b, 8w] in (2^-6, 2^-5) at min(5%, 51) a query.
    Their bf16 roundings lie on grids of 2^-8 and 2^-13, so every partial
    sum of either dot is exact in f32, whatever the order. The f32 values
    are mostly not bf16's (``_off_grid``: offsets of a quarter and a half
    ulp), so a scan that rounds an operand any other way than nearest-even
    (truncating, ties away) or keeps it wider sums other products."""
    dev = g.device

    def sparse(rows):
        cols = torch.randint(0, d, (rows, 6), generator=g, device=dev)
        return torch.zeros((rows, d), device=dev).scatter_(
            1, cols, _off_grid(g, (rows, 6), 0, signed=True))

    hit = torch.rand((b, 8 * w), generator=g, device=dev) < min(0.05, 51 / (8 * w))
    kw = torch.where(hit, _off_grid(g, (b, 8 * w), -5, signed=False),
                     torch.zeros((), device=dev))
    return sparse(n), sparse(b), kw


def _order_g(n: int) -> float:
    """g(n) = n·2^-23: the relative error of an f32 sum of n terms in any
    order with truncating accumulation, on either side."""
    return n * 2.0**-23


def fp_cos_mass(q: torch.Tensor, rows: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """max over rows of sum_i |bf16(q_i)·bf16(c_i)|, per query: f32 [B],
    raised by d·2^-23 for its own f32 rounding. Rows in chunks (with TF32
    refused), so the [B, N] products never exist at once."""
    qa = _bf16_round(q.to(torch.float32)).abs()
    out = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    with _no_tf32():
        for r0 in range(0, rows.shape[0], chunk):
            ra = _bf16_round(rows[r0:r0 + chunk].to(torch.float32)).abs()
            out = torch.maximum(out, (qa @ ra.T).amax(dim=1))
    return out * (1 + q.shape[1] * 2.0**-23)


def fp_order_bound(values: torch.Tensor, cos_mass: torch.Tensor, kw_weights=None, *,
                   d: int, cos_weight: float = COSINE_WEIGHT, granule: int = 0) -> torch.Tensor:
    """The parity rule's bound on |kernel - plain| for each entry of
    ``values`` [B, ...] (the plain version's output), when the two sum the
    same bf16 products in different orders:

      cos_weight·2g(d)·cos_mass + 0.2·2g(8W)·sum_j|w_j|·(1 + 2^-8)
        + (4 + granule) ulp(value)

    with g(n) = n·2^-23 on each side (``_order_g``), ``cos_mass`` the
    per-query max_r sum_i |q_i c_i| (``fp_cos_mass``), the keyword term only
    when ``kw_weights`` [B, 8W] is given, 4 ulp for the f32 epilogue and
    ``granule`` ulp for the lane bits of packed keys (sub in packed mode,
    else 0)."""
    per_q = cos_weight * 2 * _order_g(d) * cos_mass.to(torch.float64)
    if kw_weights is not None:
        kw_mass = kw_weights.to(torch.float64).abs().sum(dim=1) * (1 + 2.0**-8)
        per_q = per_q + KEYWORD_WEIGHT * 2 * _order_g(kw_weights.shape[1]) * kw_mass
    ulp = torch.from_numpy(np.spacing(np.abs(values.detach().cpu().numpy()))).to(
        device=values.device, dtype=torch.float64)
    return per_q.reshape(-1, *([1] * (values.dim() - 1))) + (4 + granule) * ulp


def fp_order_check(kv, pv, bound, ki=None, pi=None) -> dict:
    """Hold a kernel's output against its plain version under the parity
    rule: every value within ``bound`` (``fp_order_bound``); and, for the
    [B, slices, t1] contract (``ki``, ``pi`` given), the candidate indices
    equal in every clear slice, one whose plain values lie further apart
    than twice the slice's largest bound. Returns max_abs_err, within,
    clear_share (None without indices) and indices_equal_where_clear."""
    diff = (kv.to(torch.float64) - pv.to(torch.float64)).abs()
    out = {"max_abs_err": float(diff.max()), "within": bool((diff <= bound).all()),
           "clear_share": None, "indices_equal_where_clear": None}
    if ki is not None:
        gaps = (pv[..., :-1].to(torch.float64) - pv[..., 1:].to(torch.float64)).abs()
        clear = (gaps > 2 * bound.amax(dim=-1, keepdim=True)).all(dim=-1)
        same = (ki[..., :-1] == pi[..., :-1]).all(dim=-1)
        out["clear_share"] = float(clear.to(torch.float64).mean())
        out["indices_equal_where_clear"] = bool(same[clear].all())
    return out


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
