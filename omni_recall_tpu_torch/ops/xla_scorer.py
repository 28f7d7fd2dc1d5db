"""Plain-torch batched upper-bound scorer + top-M candidate selection.

Counterpart of omni_recall_tpu/ops/xla_scorer.py, the scan of the reference's
default backend (``Engine:Backend=xla``) over f32 scan storage. The JAX
package computes it outside any Pallas kernel, so the port computes it with
PyTorch's own operations: two f32 matrix products and a top-k. For every
valid chunk row inside the candidate window it gives a *sound upper bound*
of the reference's hybrid score (RecallSearchService.cs:59-67):

    ub = 0.7 * cos + 0.2 * min(1, bits @ w_kw + bias) + 0.1 * recency + eps

- cos is an f32 product of L2-normalized vectors in full f32: the JAX graph
  asks for ``Precision.HIGHEST``. TF32 (10 explicit mantissa bits, relative
  error 2^-11 per product) would be unsound under CERT_EPS, so the products
  refuse to run while PyTorch allows it (``check_tf32_off``); nothing here
  changes that process-wide setting.
- the keyword term uses the bloom upper bound (ops/hashing.py), also in
  full f32,
- recency = exp(min(0, created - now) / 30),
- eps absorbs device-vs-host float divergence so ub >= host-exact score:
  over d = 768 terms and 8W = 1024 bits an f32 sum in any order is within
  0.7 * 768 * 2^-24 + 0.2 * 1024 * 2^-24 * sum(w) (about 5e-5 for weights
  summing to ~1) of the exact value, inside CERT_EPS = 1e-4. cuBLAS fixes
  no summation order, so the twin is held to the JAX scorer within that
  bound, not bit for bit.

Masked rows (invalid or outside the window) get -inf. ``score_topm``
returns the top min(m+1, n) per query: the first m are the candidate set,
the last value is the certificate boundary. At serving size a literal port
would hold [N, 8W] f32 bits (4 GiB at 2^20 x 1024) and two [B, N] f32
matrices; ``score_topm`` scores the rows in slabs instead and keeps a
running top-(m+1). Ties follow ``jax.lax.top_k``: among equal values the
lower row index comes first. The top-k runs on a tie-free int64 key (the
monotone f32 -> i32 key of the score in the high word, the inverted row
index in the low word), so any top-k over it returns the one order.
"""

from __future__ import annotations

import torch

from omni_recall_tpu_torch.ops.oracle import (
    COSINE_WEIGHT,
    KEYWORD_WEIGHT,
    RECENCY_HALF_LIFE_DAYS,
    RECENCY_WEIGHT,
)
from omni_recall_tpu_torch.utils import tracing

CERT_EPS = 1e-4  # certificate float-divergence margin (scores round to 4dp
#                  at the DTO edge, RecallSearchService.cs:51)

# rows scored per slab by score_topm (bounds its [B, slab] and [slab, 8W]
# temporaries)
SLAB_ROWS = 1 << 16
# the products' row granule: slabs start at its multiples (_rows_product)
ROW_ATOM = 128

_LOW32 = 0xFFFFFFFF


def check_tf32_off() -> None:
    """Raise unless f32 matrix products run in full f32 (PyTorch's
    defaults: ``allow_tf32`` False, float32 matmul precision "highest")."""
    allow = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    if allow or precision != "highest":
        raise RuntimeError(
            "the xla scorer's f32 products need full f32 (its certificate "
            "margin CERT_EPS = 1e-4 does not cover TF32 or bf16 rounding), but "
            f"torch.backends.cuda.matmul.allow_tf32={allow} and "
            f"torch.get_float32_matmul_precision()={precision!r}; restore "
            "PyTorch's defaults (False, 'highest')"
        )


def unpack_bloom_bits(bloom_u8: torch.Tensor) -> torch.Tensor:
    """u8[N, W] -> f32[N, W*8] bit expansion; bit pos j = plane (j div W) of
    word (j mod W), i.e. a concat of 8 shift-AND planes (same layout as
    ops/hashing.chunk_signature)."""
    words = bloom_u8.to(torch.int32)
    return torch.cat([(words >> b) & 1 for b in range(8)], dim=-1).to(torch.float32)


def _keys(scores: torch.Tensor, base: int = 0) -> torch.Tensor:
    """Tie-free int64 keys of [B, n] f32 scores whose order is (score
    descending, row ascending): key(score) << 32 | (2^32 - 1 - row)."""
    s = scores.contiguous().view(torch.int32)
    key = s ^ ((s >> 31) & 0x7FFFFFFF)
    rows = torch.arange(base, base + scores.shape[1], dtype=torch.int64,
                        device=scores.device)
    return (key.to(torch.int64) << 32) | (_LOW32 - rows)


def _decode(keys: torch.Tensor):
    """Keys -> (values f32, rows i32)."""
    key = (keys >> 32).to(torch.int32)
    vals = (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)
    rows = (_LOW32 - (keys & _LOW32)).to(torch.int32)
    return vals, rows


def _topk_rows(scores: torch.Tensor, k: int):
    """top-k along the last axis of [B, N] (``jax.lax.top_k`` order: values
    descending, lower index first among equal values)."""
    k = min(k, scores.shape[1])
    return _decode(torch.topk(_keys(scores), k, dim=1).values)


def _rows_product(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """a @ rows.T [B, n], each value independent of n: the rows are padded
    with zero rows to a multiple of ROW_ATOM, so the product is one GEMM of
    [B, d] x [d, n'] whose column count never leaves a remainder. A GEMM
    picks its kernel and its summation order by shape (PyTorch's CPU GEMM
    gives other f32 bits for a 202-row slab than for the same rows among
    4096), and a slab's values would otherwise depend on how the index is
    cut into slabs. Slabs that start at multiples of ROW_ATOM give every
    row the same values, whatever the slab size."""
    n = rows.shape[0]
    pad = -n % ROW_ATOM
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    return (a @ rows.T)[:, :n]


def ub_scores(
    emb: torch.Tensor,         # f32[n, d] L2-normalized (zero rows = no embedding)
    bloom: torch.Tensor,       # u8[n, W]
    created: torch.Tensor,     # f32[n] days since index epoch
    valid: torch.Tensor,       # bool[n]
    q: torch.Tensor,           # f32[B, d] normalized query embeddings (zero = none)
    kw_weights: torch.Tensor,  # f32[B, bits]
    kw_bias: torch.Tensor,     # f32[B]
    now_days,                  # f32 scalar
    window_start,              # first GLOBAL row inside the window
    row_offset: int = 0,       # global row id of local row 0
) -> torch.Tensor:
    """Masked upper-bound scores [B, n] (-inf outside window/invalid)."""
    check_tf32_off()
    n = emb.shape[0]
    cos = _rows_product(q, emb)  # [B, n]
    kw = _rows_product(kw_weights, unpack_bloom_bits(bloom))
    kw = torch.clamp_max(kw + kw_bias[:, None], 1.0)
    rec = torch.exp(torch.clamp_max(created - now_days, 0.0) * (1.0 / RECENCY_HALF_LIFE_DAYS))
    ub = COSINE_WEIGHT * cos + KEYWORD_WEIGHT * kw + RECENCY_WEIGHT * rec[None, :] + CERT_EPS
    rows = torch.arange(n, dtype=torch.int32, device=emb.device) + row_offset
    mask = valid & (rows >= window_start)
    return torch.where(mask[None, :], ub, torch.full_like(ub, float("-inf")))


def score_topm(emb, bloom, created, valid, q, kw_weights, kw_bias, now_days,
               window_start, m: int, slab_rows: int = SLAB_ROWS, row_offset: int = 0):
    """Returns (ub_values[B, k], row_indices i32[B, k]) with k = min(m+1, n);
    entry m (when n > m) is the certificate boundary (max upper bound over
    excluded rows). Rows are scored ``slab_rows`` at a time with a running
    top-k; the result is the one-shot top-k of ``ub_scores``, bit for bit
    (``slab_rows`` is rounded up to a multiple of ROW_ATOM). ``row_offset``
    is the global row of local row 0 (a shard of a row-sharded index): the
    window mask compares global rows, the returned indices are local. The
    ``scan.xla`` span (the host's launches)."""
    with tracing.span(tracing.SCAN_XLA) as sp:
        n = emb.shape[0]
        if sp:
            sp.set(n, emb.shape[1], q.shape[0], bloom.shape[1])
        k = min(m + 1, n)
        slab_rows = -(-max(1, slab_rows) // ROW_ATOM) * ROW_ATOM
        best = None
        for lo in range(0, n, slab_rows):
            hi = min(lo + slab_rows, n)
            ub = ub_scores(emb[lo:hi], bloom[lo:hi], created[lo:hi], valid[lo:hi], q,
                           kw_weights, kw_bias, now_days, window_start, row_offset + lo)
            keys = _keys(ub, lo) if best is None else torch.cat([best, _keys(ub, lo)], dim=1)
            best = torch.topk(keys, min(k, keys.shape[1]), dim=1).values
        return _decode(best)
