"""int8 row quantization with sound error-norm bounds (certificate-safe).

The int8 scan path stores per-row symmetric-quantized embeddings plus an
error-norm BOUND, so the device upper bound can fold in a per-row
correction that provably covers the dequantization error:

    |q.c - (q8.c8)*s_q*s_c| <= ||q||*ec + eq*||c_hat||
                            <= ec*(1+eq) + eq     (unit-norm rows)

where eq/ec are the stored error norms. Keyword weights are CEIL-quantized
(w8/127 >= w), so the quantized keyword term never undershoots.

Error norms are evaluated in f32 with an explicit upward slack — the same
construction (and constants) as the on-device quantizers
(index/device_index.py _device_quantize, ops/refine.py
quantize_queries_int8_residual): the residual elements carry <= u*|x| ~
6e-8 absolute representation error and the f32 norm accumulates
gamma_d ~ d*u ~ 5e-5 relative error, so ``norm * (1 + 1e-4) + 3e-7`` is
always >= the true residual norm. A slightly larger stored bound only
loosens the device upper bound (exactness is preserved via the engine
certificate); it can never understate the error. The earlier exact-f64
implementation cost ~5 full-matrix f64 passes — tens of seconds per
million rows on the burstable host, the dominant cost of snapshot saves.
"""

from __future__ import annotations

import numpy as np


def _err_norm_f32(
    resid: np.ndarray, zero_rows: np.ndarray | None = None
) -> np.ndarray:
    """Sound upper bound on the residual norms (see module docstring).

    ``zero_rows`` marks rows whose ORIGINAL input was identically zero —
    only those get bound 0 (their exact residual is 0 in any arithmetic).
    A nonzero row whose f32-evaluated residual happens to be exactly 0
    (x == f32(q*s) elementwise) still carries an EXACT residual of up to
    u*||x|| ~ 6e-8, so it keeps the 3e-7 absolute floor — dropping it
    understates the true error and the device bound would no longer be a
    sound upper bound for such rows."""
    nrm = np.sqrt(np.einsum("ij,ij->i", resid, resid, dtype=np.float32))
    out = nrm * np.float32(1.0 + 1e-4) + np.float32(3e-7)
    if zero_rows is not None:
        out[zero_rows] = 0.0
    return out.astype(np.float32)


def quantize_rows_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization.

    Returns (q int8[N, d], scale f32[N], err_norm f32[N]) with
    x ~= q * scale[:, None] and err_norm >= ||x - q*scale|| (sound bound,
    ~1e-4 relative slack). Zero rows quantize to zeros with scale 0, err 0.
    """
    x = np.asarray(x, dtype=np.float32)
    absmax = np.abs(x).max(axis=1) if x.size else np.zeros(x.shape[0], np.float32)
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / safe[:, None]), -127, 127).astype(np.int8)
    resid = x - q.astype(np.float32) * scale[:, None]
    return q, scale, _err_norm_f32(resid, zero_rows=scale == 0.0)


def quantize_rows_int8_residual(
    x: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two-plane residual int8 quantization for the device refine stage
    (ops/refine.py): x ~= q1*s1 + q2*s2 with

        err2[i] >= || x[i] - q1[i]*s1[i] - q2[i]*s2[i] ||

    For unit-norm rows at d=768 the first-plane residual is ~8e-3, so err2
    lands around 8e-3/254 ~= 3e-5 — two int8 planes recover the cosine to
    ~f32-level accuracy while keeping the device dot products EXACT integer
    arithmetic (no bf16 rounding to bound).

    Returns (q1 int8[N,d], s1 f32[N], err1 f32[N], q2 int8[N,d], s2 f32[N],
    err2 f32[N]); (q1, s1, err1) are bit-identical to quantize_rows_int8(x)
    so the scan path and the refine path share one first plane.
    """
    x = np.asarray(x, dtype=np.float32)
    q1, s1, err1 = quantize_rows_int8(x)
    resid = x - q1.astype(np.float32) * s1[:, None]
    q2, s2, _ = quantize_rows_int8(resid)
    resid2 = resid - q2.astype(np.float32) * s2[:, None]
    # resid is itself f32-rounded from the true residual (<= u*|x| per
    # element); the extra absolute term in _err_norm_f32 covers it.
    # zero_rows keys off s1 (the ORIGINAL input being zero), not s2: a
    # nonzero x whose first-plane residual quantizes exactly still has a
    # u-level exact residual that needs the floor.
    return q1, s1, err1, q2, s2, _err_norm_f32(resid2, zero_rows=s1 == 0.0)


def ceil_quantize_weights_int8(w: np.ndarray) -> np.ndarray:
    """Ceil-quantize keyword weights to int8 so w8/127 >= w (sound upper
    bound). Weights are in [0, 1] by construction (ops/hashing.py)."""
    return np.clip(np.ceil(np.asarray(w, dtype=np.float64) * 127.0), 0, 127).astype(np.int8)
