"""The orders of K2 (csrc/dd_rows.cu) and K3 (csrc/refine.cu) held to their
plain versions on the CPU, through torch models of how the kernels lay the
work out over lanes, registers and shuffles.

- K2: thread T of a pair's 32·G holds the products T + 32·G·i, i < R
  (``exact_cos.dd_rows_layout``); the fold pairs registers i and i + half
  while half >= 32·G, threads T and T + half through shared memory while
  half >= 32, and lanes L and L + half by shuffle below. The model runs
  those three stages as the kernel does and must give dd_sum_products's hi
  and lo bit for bit (the halving tree's operand pairs in its order); sabs,
  summed per thread and then across threads, within SABS_REL.
- K3: one warp quantizes a query: maxima over lane-strided elements, each
  element's plane and residual, block j's sum of squares by lane j in
  sequence and the block sums by lane 0 in sequence. The model must give
  refine.quantize_queries_int8_residual's planes, scales and eq2 and
  row_norm's qn bit for bit, and so the JAX package's planes and scales (its
  eq2 within 2 ulp: XLA fuses the squares into its blocked sums). The
  keyword dot by eight lanes over 16-byte bloom chunks (or bytes, where
  W % 16 != 0) against the weights reordered word-major must equal the
  plain version's integer dot.

Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.ops import refine as jref
from omni_recall_tpu_torch.ops import exact_cos, refine, scorer

F32 = torch.float32


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# ---- K2 ----


def _two_sum(a, b):
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _dd_fold(h, l, hp, lp):
    """csrc/dd_rows.cu dd_fold: (h, l) folded with its partner (hp, lp)."""
    s, e = _two_sum(h, hp)
    return _two_sum(s, e + (l + lp))


def k2_model(q: torch.Tensor, c: torch.Tensor, adjacent: bool = False):
    """K2's fold as the kernel lays it out: (hi, lo, sabs) over the last axis.
    ``adjacent`` places element T·R + i in register i of thread T instead (a
    layout the kernel does not use)."""
    p = q * c
    d = p.shape[-1]
    pad, g, r = exact_cos.dd_rows_layout(d)
    span = 32 * g
    x = torch.zeros((*p.shape[:-1], r * span), dtype=F32)
    x[..., :d] = p
    # register i of thread T holds element T + span * i: h[..., i, T]
    h = x.reshape(*p.shape[:-1], r, span)
    if adjacent:
        h = x.reshape(*p.shape[:-1], span, r).transpose(-1, -2)
    l = torch.zeros_like(h)
    sabs = torch.zeros((*p.shape[:-1], span), dtype=F32)
    for i in range(r):  # each thread in register order
        sabs = sabs + h[..., i, :].abs()
    half = r // 2
    while half >= 1:  # registers i and i + half of one thread
        h, l = _dd_fold(h[..., :half, :], l[..., :half, :], h[..., half:, :], l[..., half:, :])
        half //= 2
    h, l = h[..., 0, :], l[..., 0, :]
    half = span // 2
    while half >= 32:  # threads T and T + half, through shared memory
        h, l = _dd_fold(h[..., :half], l[..., :half], h[..., half:2 * half], l[..., half:2 * half])
        half //= 2
    for half in (16, 8, 4, 2, 1):  # lanes L and L + half, by shuffle
        if half < pad:
            h, l = _dd_fold(h[..., :half], l[..., :half], h[..., half:2 * half],
                            l[..., half:2 * half])
    return h[..., 0], l[..., 0], sabs.sum(dim=-1)


def _dd_operands(d: int, seed: int):
    """Queries [6, 1, d] and rows [6, 9, d] with a zero row, a zero query,
    rows that cancel and values of mixed magnitude."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((6, 1, d)).astype(np.float32)
    c = rng.standard_normal((6, 9, d)).astype(np.float32)
    c[0, 0] = 0.0                        # a zero row
    q[2] = 0.0                           # a zero query
    c[1, 1] = -c[1, 0]                   # a row that cancels another
    half = d // 2
    c[3, 4, half:2 * half] = -c[3, 4, :half] * q[3, 0, :half] / np.where(
        q[3, 0, half:2 * half] == 0, 1, q[3, 0, half:2 * half])  # products that cancel
    c[4] *= np.float32(2.0) ** rng.integers(-20, 20, size=(9, d)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(c)


@pytest.mark.parametrize("d", [768, 100, 1024, 1, 2048])
def test_k2_lane_register_shuffle_fold_is_the_halving_tree(d):
    q, c = _dd_operands(d, seed=d)
    mh, ml, ms = k2_model(q, c)
    ph, pl, ps = exact_cos.dd_sum_products(q, c)
    assert _same(mh, ph) and _same(ml, pl)
    assert torch.all((ms - ps).abs() <= exact_cos.SABS_REL * ps.abs())
    # the zero row and the zero query give zeros; the cancelling rows sum to
    # what the plain tree gives
    assert float(mh[0, 0]) == 0.0 and torch.all(mh[2] == 0)


def test_k2_model_is_sensitive_to_the_layout():
    """With a thread's registers on adjacent elements the fold pairs other
    operands, and the model departs from the plain tree."""
    q, c = _dd_operands(768, seed=5)
    mh, ml, _ = k2_model(q, c, adjacent=True)
    ph, pl, _ = exact_cos.dd_sum_products(q, c)
    assert not (_same(mh, ph) and _same(ml, pl))


@pytest.mark.parametrize("d, expect", [(1, (1, 1, 1)), (100, (128, 1, 4)),
                                       (768, (1024, 1, 32)), (2048, (2048, 2, 32)),
                                       (3072, (4096, 4, 32)), (16384, (16384, 16, 32))])
def test_k2_layout_matches_the_kernels_instantiations(d, expect):
    """dd_rows.cu launches <R, G> = <1, 1> to P = 32, then R doubles to 32
    at P = 1024, then G doubles to 16 at P = 16384."""
    assert exact_cos.dd_rows_layout(d) == expect


# ---- K3 ----


def _warp_max(partials: torch.Tensor) -> torch.Tensor:
    """[B, 32] lane partials -> [B]: xor-shuffle tree of fmax (exact)."""
    v = partials
    for o in (16, 8, 4, 2, 1):
        v = torch.maximum(v, v[:, torch.arange(32) ^ o])
    return v[:, 0]


def _lane_strided_absmax(x: torch.Tensor) -> torch.Tensor:
    b, d = x.shape
    cols = -(-d // 32) * 32
    pad = torch.zeros((b, cols), dtype=F32)
    pad[:, :d] = x.abs()
    return _warp_max(pad.reshape(b, -1, 32).amax(dim=1))  # lane L: elements L + 32k


def _warp_norm(x: torch.Tensor) -> torch.Tensor:
    """Lane j sums block j's 32 squares in sequence; lane 0 sums the block
    sums in sequence, then the trailing squares one by one."""
    b, d = x.shape
    nb = d // 32
    sq = x * x
    red = torch.zeros((b, nb), dtype=F32)
    for j in range(nb):
        acc = torch.zeros(b, dtype=F32)
        for i in range(32):
            acc = acc + sq[:, 32 * j + i]
        red[:, j] = acc
    total = torch.zeros(b, dtype=F32)
    for j in range(nb):
        total = total + red[:, j]
    for e in range(32 * nb, d):
        total = total + sq[:, e]
    return scorer.sqrt32(total)  # sqrtf: correctly rounded


def _warp_plane(x: torch.Tensor, absmax: torch.Tensor):
    scale = absmax * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    v = torch.clamp(torch.round(x / safe[:, None]), -127.0, 127.0)
    resid = scorer._fma32(-v, scale[:, None], x)
    return v.to(torch.int8), scale, resid


def k3_quantize_model(q: torch.Tensor):
    """K3's warp-0 prologue: (q1, t1, q2, t2, eq2, qn), per-query terms [B]."""
    qn = _warp_norm(q) * (1.0 + 1e-6)
    q1, t1, r1 = _warp_plane(q, _lane_strided_absmax(q))
    q2, t2, r2 = _warp_plane(r1, _lane_strided_absmax(r1))
    eq2 = scorer._fma32(_warp_norm(r2), 1.0 + 1e-4, 3e-7)
    return q1, t1, q2, t2, eq2, qn


def _queries(d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((7, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[2] = 0.0  # the keyword-only query
    q[4] *= np.float32(1e-6)  # another exponent
    q[5, : d // 2] = 0.0
    return q


@pytest.mark.parametrize("d", [768, 16, 1040])
def test_k3_warp_quantization_is_the_plain_one(d):
    q = _queries(d, seed=d)
    tq = torch.from_numpy(q)
    m1, mt1, m2, mt2, meq2, mqn = k3_quantize_model(tq)
    p1, pt1, p2, pt2, peq2 = refine.quantize_queries_int8_residual(tq)
    assert torch.equal(m1, p1) and torch.equal(m2, p2)
    assert _same(mt1, pt1[:, 0]) and _same(mt2, pt2[:, 0]) and _same(meq2, peq2[:, 0])
    assert _same(mqn, scorer.row_norm(tq) * (1.0 + 1e-6))
    assert _same(_warp_norm(tq), scorer.sqrt32(scorer.row_sum(tq * tq)))
    assert float(mt1[2]) == 0.0 and float(meq2[2]) == np.float32(3e-7)
    # and through them the JAX package's, under jit as its refine graphs run
    j = [np.asarray(v) for v in jax.jit(jref.quantize_queries_int8_residual)(jnp.asarray(q))]
    assert np.array_equal(j[0], m1.numpy()) and np.array_equal(j[2], m2.numpy())
    assert np.array_equal(j[1][:, 0].view(np.int32), mt1.numpy().view(np.int32))
    assert np.array_equal(j[3][:, 0].view(np.int32), mt2.numpy().view(np.int32))
    ulps = np.abs(j[4][:, 0].view(np.int32).astype(np.int64) - meq2.numpy().view(np.int32))
    assert np.all(ulps <= 2)


def _kw_offset(wd):
    return 8 * wd + 8 * (wd >> 4)


def k3_keyword_model(kw_w8: np.ndarray, bloom: np.ndarray) -> np.ndarray:
    """K3's keyword dot [B, m]: the weights reordered word-major with eight
    bytes of padding a 16 words (kw_offset), eight lanes a candidate over
    16-byte bloom chunks (part, part + 8, ...) or, where W % 16 != 0, bytes,
    each byte's two nibbles expanded against its eight weights, the lanes'
    sums added after."""
    b, m, w = bloom.shape
    skw = np.zeros((b, _kw_offset(w)), dtype=np.int64)
    for wd in range(w):
        for k in range(8):
            skw[:, _kw_offset(wd) + k] = kw_w8[:, k * w + wd]
    words_of = ([[16 * ch + i for ch in range(part, w // 16, 8) for i in range(16)]
                 for part in range(8)] if w % 16 == 0
                else [list(range(part, w, 8)) for part in range(8)])
    assert sorted(sum(words_of, [])) == list(range(w))
    out = np.zeros((b, m), dtype=np.int64)
    for words in words_of:
        for wd in words:
            byte = bloom[:, :, wd].astype(np.int64)
            bits = (byte[..., None] >> np.arange(8)) & 1  # [B, m, 8]
            out += np.einsum("bmk,bk->bm", bits, skw[:, _kw_offset(wd):_kw_offset(wd) + 8])
    return out


@pytest.mark.parametrize("w", [128, 125, 256])
def test_k3_keyword_dot_layout_is_the_plain_dot(w):
    rng = np.random.default_rng(w)
    b, m = 3, 5
    kw = np.where(rng.random((b, 8 * w)) < 0.2, rng.integers(1, 128, (b, 8 * w)), 0)
    bloom = rng.integers(0, 256, (b, m, w), dtype=np.uint8)
    want = refine._bdot(torch.from_numpy(kw.astype(np.int8))[:, None],
                        scorer._bloom_bits(torch.from_numpy(bloom.reshape(-1, w)))
                        .reshape(b, m, -1))[:, 0]
    assert np.array_equal(k3_keyword_model(kw, bloom), want.numpy().astype(np.int64))


KTIE = np.float32(1.0 / 1024)  # csrc/refine.cu kTie


def _kernel_rint(x: np.ndarray, safe: np.ndarray):
    """warp_plane's rounding of x / safe: rint(x * fl32(1/safe)) unless that
    product lies within kTie of a tie k + 1/2 or is not finite, and there
    rint of the exact quotient. Returns (v, flagged)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = np.float32(1.0) / safe  # correctly rounded, as __frcp_rn
        qa = x * inv
        tie = np.abs((qa - np.floor(qa)) - np.float32(0.5))
        flagged = ~((tie >= KTIE) & (np.abs(qa) <= np.float32(128.0)))
        return np.where(flagged, np.rint(x / safe), np.rint(qa)), flagged


def _ties(d: int, rng) -> np.ndarray:
    """Rows on the grid (k + 1/2)·s, so that x / safe falls on or next to ties."""
    rows = []
    for s in (np.float32(2.0 ** -10), np.float32(0.0123), np.float32(3.1e-20)):
        k = rng.integers(-127, 127, d).astype(np.float32)
        row = (k + np.float32(0.5)) * s
        row[0] = np.float32(127.0) * s
        rows.append(row.astype(np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3_reciprocal_quotient_rounds_as_the_division(seed):
    """Both planes of quantize_queries_int8_residual, with warp_plane's
    rounding in place of the division, give the plain planes bit for bit;
    the tie rows take the exact path."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((64, 768)).astype(np.float32)
    q *= (np.float32(10.0) ** rng.uniform(-30, 30, (64, 1))).astype(np.float32)
    q = np.concatenate([q, _ties(768, rng), np.zeros((1, 768), np.float32)])
    x = q
    planes, flagged_rows = [], 0
    for plane in range(2):
        absmax = np.abs(x).max(axis=1, keepdims=True)
        scale = absmax * np.float32(1.0 / 127.0)
        safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
        got, flagged = _kernel_rint(x, safe)
        assert np.array_equal(got, np.rint(x / safe))
        if plane == 0:
            flagged_rows = int(flagged[64:67].any(axis=1).sum())
        v = np.clip(got, -127, 127).astype(np.float32)
        planes.append(v.astype(np.int8))
        x = scorer._fma32(torch.from_numpy(-v), torch.from_numpy(scale),
                          torch.from_numpy(x)).numpy()
    assert flagged_rows == 3
    p1, _, p2, _, _ = refine.quantize_queries_int8_residual(torch.from_numpy(q))
    assert np.array_equal(planes[0], p1.numpy()) and np.array_equal(planes[1], p2.numpy())
