"""Device-exact cosine: double-float compensated dot over candidate rows.

Port of omni_recall_tpu/ops/exact_cos.py. The DD dot over gathered rows is
the hand-written CUDA kernel csrc/dd_rows.cu (K2, replacing the TPU kernel
_dd_rows_kernel); ``dd_sum_products`` is its plain PyTorch version, written
from the JAX graph, and serves CPU tensors. K2 has two entries over one
fold: ``exact_cos_rows(raw, rows, q_raw)`` reads the candidates from the
raw plane by index (the single-device path), ``dd_rows(q_raw, c)`` takes
rows already gathered (the JAX kernel's interface; the row-sharded path,
parallel/sharded.py, gathers each row on its owner). The host finish
(``finish_cosines``, ``round4_certified``) is a numpy copy.

The certified-exact serving path's remaining host cost is the float64
rescore: per (query, candidate) pair the host streams the row's raw f32
embedding (d*4 bytes) to reproduce the oracle cosine
``np.sum((q * c).astype(f64 pairwise))`` bit-for-bit
(search/engine.py _exact_rescore_rows; reference contract
src/OmniRecall.Api/Services/RecallSearchService.cs:59-75). At d=768 that is
~3 KB/pair — the embedding stream is ~95% of the host rescore's bytes and
pins certified end-to-end throughput to host memory bandwidth
(VERDICT r2 weak #1/#2).

This module moves that stream onto the device. TPUs have no float64, so the
kernel computes the dot in **double-float (compensated) arithmetic**:

- products ``p_i = fl32(q_i * c_i)`` are the EXACT same IEEE-f32 products
  the numpy oracle forms (numpy multiplies in f32, then widens),
- the p_i are summed with a two-float (hi, lo) pairwise tree using Knuth's
  TwoSum (exact error recovery without FMA), giving
  ``|(hi + lo) - sum_true(p)| <= DD_SUM_REL * sum|p_i|``,
- ``sum|p_i|`` itself is returned (f32 tree sum, inflated by its own
  rounding bound) so the host can evaluate the error bound in f64.

The host then finishes in f64 exactly as the oracle does —
``cos = dot / (sqrt(q_norm_sq) * sqrt(row_norm_sq))``, fused with the exact
keyword + recency terms — and certifies, per query, that the oracle's f64
result could not differ visibly:

- the oracle's pairwise-f64 summation deviates from the true sum by
  <= NP_SUM_REL * sum|p_i| (numpy pairwise, blocksize 128, depth <= 12 at
  d <= 8192: (12+2) * 2^-53 < 1.6e-15),
- so |score_dd - score_np| <= margin where
  margin = COSINE_WEIGHT * (DD_SUM_REL + NP_SUM_REL) * sabs_ub / denom
  (+ a 1-ulp f64 slack for the shared combine expression),
- ranking is certified when every adjacent pair in the sorted order is
  separated by more than the two margins (pairs with margin 0 on both
  sides — cosine-free queries, zero rows — are exact and fall through to
  the created/seq tie-break, which both paths apply identically),
- the DTO value is certified when round(score - margin, 4) ==
  round(score + margin, 4) (round is monotone, so every value in the
  interval rounds identically — matching the reference's 4-decimal edge,
  Contracts/RecallSearchResponse round-trip).

Any query failing a certificate escalates to the existing host float64
rescore of its candidate rows (the bit-exact numpy/native path) — identical
semantics, just slower; with margins ~1e-11 the escalation rate is the
probability of two scores landing within ~1e-11 of each other or of a
0.00005 rounding midpoint.

DD_SUM_REL derivation: Knuth TwoSum is exact in IEEE f32 (no fast-math —
PyTorch runs each elementwise op as written, and the CUDA kernel
uses __fadd_rn / __fsub_rn with -fmad=false). At every tree level the
only rounding is the lo-part accumulation (3 f32 adds on values
<= 2u * partial-sum magnitudes). A standard Sum2-style bound for the
pairwise variant is ``|err| <= (log2(n)+2)^2 * u^2 * sum|p|`` with
u = 2^-24; at n = 8192 that is 196 * 3.55e-15 < 7e-13. DD_SUM_REL = 1e-8
keeps four orders of magnitude of headroom (a LOOSER margin only raises
escalations, never unsoundness).
"""

from __future__ import annotations

import numpy as np
import torch

from omni_recall_tpu_torch.ops import cuda

# sound relative bounds on |computed - true| / sum|p_i| (see module docstring)
DD_SUM_REL = 1e-8     # double-float pairwise tree (provable ~7e-13; 4 oom slack)
NP_SUM_REL = 1.6e-15  # numpy pairwise-f64 over exact f32 products, d <= 8192
SABS_REL = 1e-4       # f32 tree-sum rounding on sum|p| itself (d*u ~ 5e-5)
# Device-computed query self-norm (device-resident query pipeline): the
# engine's qn = hi + lo from dd_sum_products(q, q). For a self-dot every
# product is non-negative, so sum|p| == sum p == qn_true and the DD bound
# gives |qn_dd - qn_true| <= DD_SUM_REL * qn_true; the oracle's numpy
# pairwise sum deviates by <= NP_SUM_REL * qn_true. Through the cosine's
# 1/sqrt(qn) the relative effect halves, so
# |cos(qn_dd) - cos(qn_np)| <= 0.5 * (DD_SUM_REL + NP_SUM_REL) / (1 - e)
# * |cos| — QN_DD_REL = 2e-8 keeps ~4x headroom on top of DD_SUM_REL's own
# four orders of magnitude.
QN_DD_REL = 2e-8



def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth TwoSum: s + err == a + b EXACTLY (IEEE, any magnitudes)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _dd_fold(hi: torch.Tensor, lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One pairwise-tree level: fold the last axis in half, pairing
    (i, i + half), with TwoSum + compensated lo accumulation."""
    half = hi.shape[-1] // 2
    s, e = _two_sum(hi[..., :half], hi[..., half:])
    lo_new = e + (lo[..., :half] + lo[..., half:])
    return _two_sum(s, lo_new)


def dd_sum_products(q: torch.Tensor, c: torch.Tensor):
    """Double-float sum of the f32 products q*c over the last axis (plain
    version of K2). Returns (hi, lo, sabs) f32 with
    |(hi + lo) - sum_true(fl32(q_i*c_i))| <= DD_SUM_REL * sabs.

    The JAX graph folds by halving down to 128 lanes and by lane rotation
    below that; position 0 of the rotated fold sees exactly the halving
    tree's operand pairs in the same order, so the plain halving tree here
    gives the same bits."""
    p = q * c  # the same IEEE-f32 products as the host oracle
    d = p.shape[-1]
    pad = 1
    while pad < d:
        pad *= 2
    if pad != d:
        p = torch.nn.functional.pad(p, (0, pad - d))
    hi, lo = p, torch.zeros_like(p)
    while hi.shape[-1] > 1:
        hi, lo = _dd_fold(hi, lo)
    sabs = p.abs().sum(dim=-1)  # f32 reduce; SABS_REL covers its rounding
    return hi[..., 0], lo[..., 0], sabs


def exact_cos_rows_plain(raw: torch.Tensor, rows: torch.Tensor, q_raw: torch.Tensor):
    """Plain K2: gather the candidate rows (rows outside [0, N) read row 0)
    and DD-dot them against the raw query rows."""
    n = raw.shape[0]
    safe = torch.where((rows < 0) | (rows >= n), torch.zeros_like(rows), rows)
    c = raw[safe.long()]  # [B, t, d]
    return dd_sum_products(q_raw[:, None, :], c)


DD_MAX_PAD = 16384  # the widest fold csrc/dd_rows.cu takes: 16 warps of 32 registers


def dd_rows_layout(d: int) -> tuple[int, int, int]:
    """K2's fold layout for rows of d (csrc/dd_rows.cu): (P, G, R) with P
    the padded width (the next power of two), G the warps that fold one
    pair and R the registers a thread holds; thread T of the pair's 32·G
    holds the products T + 32·G·i, i < R."""
    pad = 1 << max(0, d - 1).bit_length()
    g = max(1, pad // 1024)
    return pad, g, max(1, pad // (32 * g))


def _dd_rows_cuda(raw: torch.Tensor, rows: torch.Tensor, q_raw: torch.Tensor):
    """Launch csrc/dd_rows.cu (K2): reads each candidate row straight from
    the raw plane by index, so no [B, t, d] gather is materialized."""
    n, d = raw.shape
    b, t = rows.shape
    dev = raw.device
    for name, x, dtype, shape in (
        ("raw", raw, torch.float32, (n, d)),
        ("rows", rows, torch.int32, (b, t)),
        ("q_raw", q_raw, torch.float32, (b, d)),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: {x.dtype}{tuple(x.shape)} on {x.device}, expected "
                f"{dtype}{shape} on {dev}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pad, _, _ = dd_rows_layout(d)
    if pad > DD_MAX_PAD:
        raise ValueError(
            f"d={d} pads to a fold of {pad} products; the CUDA kernel folds at "
            f"most {DD_MAX_PAD} (16 warps of 32 registers)"
        )
    hi = torch.empty((b, t), dtype=torch.float32, device=dev)
    lo = torch.empty((b, t), dtype=torch.float32, device=dev)
    sabs = torch.empty((b, t), dtype=torch.float32, device=dev)
    lib = cuda.library("dd_rows")
    rc = lib.omni_dd_rows(
        raw.data_ptr(), rows.data_ptr(), q_raw.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), sabs.data_ptr(), n, d, b, t, cuda.stream_ptr(dev),
    )
    cuda.check(lib, rc, "dd_rows")
    cuda.count_launch("dd_rows")
    return hi, lo, sabs


def _dd_rows_gathered_cuda(q_raw: torch.Tensor, c: torch.Tensor):
    """Launch K2's gathered entry (csrc/dd_rows.cu omni_dd_rows_gathered)."""
    b, t, d = c.shape
    dev = c.device
    for name, x, shape in (("q_raw", q_raw, (b, d)), ("c", c, (b, t, d))):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {x.dtype}{tuple(x.shape)} on {x.device}, expected "
                             f"torch.float32{shape} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dd_rows_layout(d)[0] > DD_MAX_PAD:
        raise ValueError(f"d={d}: the CUDA kernel folds at most {DD_MAX_PAD} products")
    hi, lo, sabs = (torch.empty((b, t), dtype=torch.float32, device=dev) for _ in range(3))
    lib = cuda.library("dd_rows")
    rc = lib.omni_dd_rows_gathered(c.data_ptr(), q_raw.data_ptr(), hi.data_ptr(),
                                   lo.data_ptr(), sabs.data_ptr(), d, b, t,
                                   cuda.stream_ptr(dev))
    cuda.check(lib, rc, "dd_rows")
    cuda.count_launch("dd_rows")
    return hi, lo, sabs


def dd_rows(q_raw: torch.Tensor, c: torch.Tensor):
    """(hi, lo, sabs) f32[B, t] of the raw query rows q_raw f32[B, d]
    against gathered candidate rows c f32[B, t, d] (exact_cos.py dd_rows,
    the interface of the JAX kernel). CUDA tensors launch K2's gathered
    entry, which runs the same fold as ``exact_cos_rows``'s by-index entry,
    so on the same rows both give the same bits; CPU tensors take the plain
    version, ``dd_sum_products``."""
    if c.is_cuda:
        return _dd_rows_gathered_cuda(q_raw, c)
    if c.device.type != "cpu":
        raise ValueError(f"no kernel for device {c.device}")
    return dd_sum_products(q_raw[:, None, :], c)


def exact_cos_rows(raw: torch.Tensor, rows: torch.Tensor, q_raw: torch.Tensor):
    """Per-(query, candidate-row) double-float dot against the device raw
    f32 plane.

    raw:   f32[N, d] — bitwise copy of the host raw_emb mirror
    rows:  i32[B, t] — candidate rows (<0 = empty slot; read at row 0,
           masked by the caller via its own row bookkeeping; rows >= N,
           which the engine never passes, also read row 0 — JAX's take
           would fill them — so no launch reads outside the plane)
    q_raw: f32[B, d] — bitwise copy of the host raw query matrix

    Returns (hi, lo, sabs) f32[B, t]. CUDA tensors launch K2; CPU tensors
    take the plain version."""
    if raw.is_cuda:
        return _dd_rows_cuda(raw, rows, q_raw)
    if raw.device.type != "cpu":
        raise ValueError(f"no kernel for device {raw.device}")
    return exact_cos_rows_plain(raw, rows, q_raw)


def self_norm_dd(q_raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-float squared L2 norms of the raw query rows (hi, lo) f32[B]:
    |(hi + lo) - sum_true(fl32(q_i^2))| <= DD_SUM_REL * qn_true."""
    hi, lo, _ = dd_sum_products(q_raw, q_raw)
    return hi, lo


# ---- host-side finalization helpers (numpy; exact f64) ----


def finish_cosines(
    hi: np.ndarray, lo: np.ndarray, sabs: np.ndarray,
    q_norm_sq: np.ndarray, row_norm_sq: np.ndarray,
    qn_rel: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """f64 cosines + sound margins vs the numpy-oracle cosine.

    hi/lo/sabs: f32[P] device outputs for P pairs; q_norm_sq f64[P]
    (owner-expanded), row_norm_sq f64[P]. Returns (cos f64[P],
    margin f64[P]) with |cos - cos_oracle| <= margin, margin == 0.0 exactly
    where the oracle's cosine is forced to 0 (zero norms — both paths guard
    identically).

    ``qn_rel`` (optional f64[P]): per-pair relative uncertainty of
    q_norm_sq vs the oracle's numpy-computed norm — nonzero for
    device-embedded queries whose norm came from self_norm_dd (QN_DD_REL)
    — folded into the margin as qn_rel * |cos| (the true sensitivity is
    0.5 * rel; the 2x slack is deliberate)."""
    dot = hi.astype(np.float64) + lo.astype(np.float64)
    ok = (q_norm_sq > 0.0) & (row_norm_sq > 0.0)
    # same f64 expression the oracle evaluates: sqrt(qn) * sqrt(ns), then
    # divide (engine._exact_rescore_rows numpy branch / native hybrid_rescore)
    denom = np.sqrt(np.where(ok, q_norm_sq, 1.0)) * np.sqrt(
        np.where(ok, row_norm_sq, 1.0)
    )
    cos = np.where(ok, dot / denom, 0.0)
    sabs_ub = sabs.astype(np.float64) * (1.0 + SABS_REL)
    # summation-order deviation, through the shared f64 divide (the divide
    # itself is the same expression both paths evaluate; 2 ulps slack for
    # its rounding interacting with the dot perturbation)
    margin = np.where(
        ok,
        (DD_SUM_REL + NP_SUM_REL) * sabs_ub / denom + 4e-16 * np.abs(cos),
        0.0,
    )
    if qn_rel is not None:
        margin = margin + np.where(ok, qn_rel * np.abs(cos), 0.0)
    return cos, margin


def round4_certified(scores: np.ndarray, margins: np.ndarray) -> np.ndarray:
    """True where the 4-decimal DTO rounding is PROVABLY invariant over
    [score-m, score+m] — for python's builtin ``round``, the function the
    DTO serialization applies (search/service.py round(hit.score, 4),
    mirroring the reference's Math.Round in RecallSearchService.cs:33).

    ``round(x, 4)`` (correctly rounded over the double's exact decimal
    value) can only change output where the real value crosses a decimal
    midpoint (2n+1)/2e4, so it is constant on any interval bounded away
    from every midpoint. The test computes the distance from score*1e4 to
    the nearest half-integer and requires it to exceed the margin plus this
    evaluation's own f64 error:

    - fl(score*1e4) carries <= |g| * 2^-52 absolute error;
    - g - floor(g) is exact (Sterbenz) and the half-integer shift adds
      < 2^-53 relative slop, covered by the 1e-15 constant;
    - the margin scale-up is padded by 1e-4 relative.

    NOTE np.round is NOT usable here: its scale-rint-unscale algorithm is
    documented inexact near the very midpoints this certificate is about,
    so np.round endpoint equality does not transfer to builtin round.
    Non-finite scores (padded -inf cells) certify trivially, as does
    margin == 0 (the two paths' values are then bit-identical, so any
    deterministic rounding of them agrees)."""
    with np.errstate(invalid="ignore"):
        g = scores * 1e4
        d = np.abs((g - np.floor(g)) - 0.5)
        slack = np.abs(g) * 2.3e-16 + margins * 1.0001e4 + 1e-15
        return (d > slack) | (margins == 0.0) | ~np.isfinite(scores)
