"""The port's int8 scans (omni_recall_tpu_torch/ops/scorer.py) against the
JAX package's Pallas kernels run in interpret mode on the CPU.

Inputs are made with numpy from a seed and fed to both. On the CPU the
port's wrappers take their plain PyTorch versions (the CUDA kernels run only
on the card, where chip_smoke.py holds them against the same plain
versions). Everything is compared bitwise, except make_add_row: its
recency term is an exp, and XLA's CPU exp and PyTorch's differ by an ulp on
some inputs (both within 2 ulp of the true value), so it is held to 4 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.ops import merge as jmerge
from omni_recall_tpu.ops import pallas_scorer as jps
from omni_recall_tpu_torch.ops import merge as tmerge
from omni_recall_tpu_torch.ops import scorer as tps

N, D, B, W = 4096, 64, 16, 16


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8)
    )


def _operands(seed: int, n: int = N, d: int = D, b: int = B, w: int = W):
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(-127, 128, size=(n, d), dtype=np.int8)
    q8 = rng.integers(-127, 128, size=(b, d), dtype=np.int8)
    bloom = rng.integers(0, 256, size=(n, w), dtype=np.uint8)
    kw_w8 = np.where(rng.random((b, 8 * w)) < 0.1,
                     rng.integers(0, 128, size=(b, 8 * w)), 0).astype(np.int8)
    kw_b = (rng.random((b, 1)) * 0.05).astype(np.float32)
    add_row = (rng.random((1, n)) * 0.1).astype(np.float32)
    add_row[0, rng.random(n) < 0.1] = np.float32(-1e30)
    scale_row = (rng.random((1, n)) * 0.01 + 1e-3).astype(np.float32)
    q_scale = (rng.random((b, 1)) * 0.01 + 1e-3).astype(np.float32)
    q_bias = (rng.random((b, 1)) * 0.01).astype(np.float32)
    # a few exact score ties inside slices: duplicate rows
    emb8[7] = emb8[3]
    bloom[7] = bloom[3]
    add_row[0, 7] = add_row[0, 3]
    scale_row[0, 7] = scale_row[0, 3]
    return dict(emb8=emb8, q8=q8, bloom=bloom, kw_w8=kw_w8, kw_b=kw_b,
                add_row=add_row, scale_row=scale_row, q_scale=q_scale,
                q_bias=q_bias)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("t, emit", [(2, "t"), (2, False), (1, "t"), (1, False)])
def test_coarse_scan_matches_pallas(t, emit):
    """K1: t=2 -> t1=3 at a power-of-two sub (packed keys; emit "t" is the
    transposed key emit, False the pair kernel), t=1 -> t1=2 (two-reduce)."""
    o = _operands(1)
    args = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    jv, ji = jps.block_topt_int8_coarse(
        *map(jnp.asarray, args), t=t, sub=512, interpret=True, emit_keys=emit)
    tv, ti = tps.block_topt_int8_coarse(*map(_t, args), t=t, sub=512)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(ji, ti.numpy())


@pytest.mark.parametrize("t", [2, 4, 1])
def test_fused_scan_matches_pallas(t):
    """K4 in both extraction modes (t1 >= 3 packed, t1 = 2 two-reduce)."""
    o = _operands(2)
    keys = ("emb8", "bloom", "q8", "kw_w8", "kw_b", "add_row", "scale_row",
            "q_scale", "q_bias")
    jv, ji = jps.block_topt_int8(*(jnp.asarray(o[k]) for k in keys),
                                 t=t, sub=256, interpret=True)
    tv, ti = tps.block_topt_int8(*(_t(o[k]) for k in keys), t=t, sub=256)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(ji, ti.numpy())


@pytest.mark.parametrize("t", [3, 1])
def test_kw_only_scan_matches_pallas(t):
    o = _operands(3)
    keys = ("bloom", "kw_w8", "kw_b", "add_row")
    jv, ji = jps.block_topt_kw_only(*(jnp.asarray(o[k]) for k in keys),
                                    t=t, sub=512, interpret=True)
    tv, ti = tps.block_topt_kw_only(*(_t(o[k]) for k in keys), t=t, sub=512)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(ji, ti.numpy())


def test_score_topm_int8_merge_matches_pallas():
    """K4 + merge through the engine entry, from unquantized operands."""
    rng = np.random.default_rng(4)
    n, d, b, bits = 2048, 128, 8, 256
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb8 = np.clip(np.rint(emb * 127 / np.abs(emb).max(1, keepdims=True)), -127, 127).astype(np.int8)
    scale = (np.abs(emb).max(1) / 127).astype(np.float32)
    err = (rng.random(n) * 1e-3).astype(np.float32)
    bloom = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    created = np.sort((rng.random(n) * 100).astype(np.float32))
    valid = rng.random(n) > 0.1
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw = np.where(rng.random((b, bits)) < 0.05, rng.random((b, bits)) * 0.1, 0).astype(np.float32)
    kw_b = (rng.random(b) * 0.05).astype(np.float32)
    arrs = (emb8, scale, err, bloom, created, valid, q, kw, kw_b)
    jv, ji = jps.score_topm_int8(*map(jnp.asarray, arrs), jnp.float32(60.0),
                                 jnp.int32(0), m=16, t=4, sub=256, interpret=True)
    tv, ti = tps.score_topm_int8(*map(_t, arrs), torch.tensor(60.0), 0,
                                 m=16, t=4, sub=256)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(ji, ti.numpy())


def test_query_prep_ops_match_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((24, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = 0.0  # zero query: scale 0, safe divisor 1
    err_row = (rng.random(512) * 1e-3).astype(np.float32)
    # under jit, as the serving graphs (score_topm_*) run it
    j = jax.jit(jps.prepare_int8_query)(jnp.asarray(q), jnp.asarray(err_row))
    t = tps.prepare_int8_query(_t(q), _t(err_row))
    for a, b in zip(j, t):
        assert _bits_equal(a, b.numpy())
    kw = np.where(rng.random((24, 256)) < 0.1, rng.random((24, 256)), 0).astype(np.float32)
    kw_b = (rng.random(24) * 0.05).astype(np.float32)
    eq = np.asarray(j[2])
    assert _bits_equal(
        jax.jit(jps.coarse_q_bias)(jnp.asarray(eq), jnp.asarray(kw), jnp.asarray(kw_b)),
        tps.coarse_q_bias(_t(eq), _t(kw), _t(kw_b)).numpy(),
    )
    assert _bits_equal(
        jps.quantize_kw_weights(jnp.asarray(kw)), tps.quantize_kw_weights(_t(kw)).numpy()
    )


def test_make_add_row_matches_jax():
    rng = np.random.default_rng(6)
    n = 4096
    created = np.sort((rng.random(n) * 400).astype(np.float32))
    valid = rng.random(n) > 0.2
    err_term = (rng.random(n) * 1e-3).astype(np.float32)
    for err in (None, err_term):
        j = np.asarray(jax.jit(jps.make_add_row)(
            jnp.asarray(created), jnp.asarray(valid), jnp.float32(390.5), jnp.int32(100),
            err_term=None if err is None else jnp.asarray(err)))
        t = tps.make_add_row(
            _t(created), _t(valid), torch.tensor(390.5), 100,
            err_term=None if err is None else _t(err)).numpy()
        assert j.shape == t.shape and j.dtype == t.dtype
        masked = j <= -1e29
        assert np.array_equal(masked, t <= -1e29)
        assert np.array_equal(j[masked], t[masked])
        ulp = np.spacing(np.abs(j[~masked]))
        assert np.all(np.abs(j[~masked] - t[~masked]) <= 4 * ulp)


def test_merge_ties_lowest_position_wins():
    vals = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.9]], dtype=np.float32)
    payload = np.array([[10, 11, 12, 13, 14, 15]], dtype=np.int32)
    jv, jp = jmerge.top_k_with_payload(jnp.asarray(vals), jnp.asarray(payload), 5)
    tv, tp = tmerge.top_k_with_payload(_t(vals), _t(payload), 5)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(jp, tp.numpy())
    assert tp.tolist() == [[11, 13, 15, 10, 12]]


def test_merge_topm_with_masked_slices_matches_jax():
    rng = np.random.default_rng(7)
    vals = rng.random((4, 32, 3)).astype(np.float32)
    vals[:, :5] = -1e30
    vals[1, :, :] = np.round(vals[1], 1)  # many ties
    idxs = rng.integers(0, 1 << 15, size=(4, 32, 3)).astype(np.int32)
    idxs[:, :, 2] = -2
    jv, ji = jps._merge_topm(jnp.asarray(vals), jnp.asarray(idxs), 20)
    tv, ti = tps._merge_topm(_t(vals), _t(idxs), 20)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(ji, ti.numpy())


# ---- K6: the fused f32/bf16 scan ----
#
# The TPU kernel sums its dot products in XLA's order; the port fixes k order
# (ops/scorer.py). On exactly-summable inputs (entries multiples of 2^-4 with
# few nonzeros, keyword weights multiples of 2^-6) every order gives the same
# sums, and there the port is held to the interpret-mode kernel bit for bit.
# Elsewhere the scores are held to the shape bound of a reordered f32 sum,
#   0.7 * g(d) * max_row sum_i |q_i c_i| + 0.2 * g(8W) * sum_j w_j, g(n) = n 2^-24,
# plus 4 ulp for the epilogue and, in packed mode, the decode's granularity
# of sub ulps; indices are held equal in every slice whose emitted values lie
# further apart than twice that bound.

FP_N, FP_D, FP_B, FP_W = 4096, 256, 16, 32
FP_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _fp_operands(seed: int, exact: bool):
    rng = np.random.default_rng(seed)
    n, d, b, w = FP_N, FP_D, FP_B, FP_W

    def sparse(rows):
        x = np.zeros((rows, d), np.float32)
        for r in range(rows):
            x[r, rng.choice(d, 6, replace=False)] = rng.integers(-16, 17, 6) * 2.0**-4
        return x

    if exact:
        emb, q = sparse(n), sparse(b)
        kw = np.where(rng.random((b, 8 * w)) < 0.05,
                      rng.integers(0, 20, (b, 8 * w)) * 2.0**-6, 0).astype(np.float32)
    else:
        emb = rng.standard_normal((n, d)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        q = rng.standard_normal((b, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        kw = np.where(rng.random((b, 8 * w)) < 0.05, rng.random((b, 8 * w)) * 0.1,
                      0).astype(np.float32)
        kw[2] *= 20.0  # a query whose keyword term clamps at 1
    emb[9], emb[11] = emb[4], emb[4]  # exact ties inside a slice
    bloom = rng.integers(0, 256, size=(n, w), dtype=np.uint8)
    bloom[9], bloom[11] = bloom[4], bloom[4]
    kw_b = (rng.random((b, 1)) * 0.05).astype(np.float32)
    add_row = (rng.random((1, n)) * 0.1).astype(np.float32)
    add_row[0, rng.random(n) < 0.1] = np.float32(-1e30)
    add_row[0, 9] = add_row[0, 11] = add_row[0, 4]
    return emb, bloom, q, kw, kw_b, add_row


def _k6_pair(dtype, arrs, t, sub):
    jdt, tdt = FP_DTYPES[dtype]
    emb, *rest = arrs
    jv, ji = jps.block_topt(jnp.asarray(emb).astype(jdt), *map(jnp.asarray, rest),
                            t=t, sub=sub, interpret=True)
    tv, ti = tps.block_topt(torch.from_numpy(emb).to(tdt), *map(_t, rest), t=t, sub=sub)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sub, t", [(512, 4), (256, 2), (512, 1)])
def test_k6_matches_pallas_bitwise_on_exactly_summable_inputs(dtype, sub, t):
    """Packed keys (sub 512, t 4: the engine's layout at m = 128; sub 256,
    t1 = 3) and the two-reduce mode (t1 = 2), on f32 and bf16 storage."""
    jv, ji, tv, ti = _k6_pair(dtype, _fp_operands(10, exact=True), t, sub)
    assert _bits_equal(jv, tv)
    assert _bits_equal(ji, ti)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sub, t", [(512, 4), (512, 1)])
def test_k6_matches_pallas_within_the_sum_order_bound(dtype, sub, t):
    arrs = _fp_operands(11, exact=False)
    jv, ji, tv, ti = _k6_pair(dtype, arrs, t, sub)
    assert jv.shape == tv.shape and ji.shape == ti.shape
    emb, _, q, kw = arrs[:4]
    jdt = FP_DTYPES[dtype][0]
    eh = np.asarray(jnp.asarray(emb).astype(jdt).astype(jnp.float32), np.float64)
    qh = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    g = lambda n: n * 2.0**-24  # noqa: E731
    per_q = (0.7 * g(FP_D) * (np.abs(qh) @ np.abs(eh).T).max(axis=1)
             + 0.2 * g(8 * FP_W) * kw.sum(axis=1) * (1 + 2.0**-8))
    spacing = np.spacing(np.abs(jv).astype(np.float32))
    granule = sub if tps._packed_mode(sub, min(t + 1, sub)) else 1
    bound = per_q[:, None, None] + (4 + granule) * spacing
    assert np.all(np.abs(jv - tv) <= bound)
    gaps = np.abs(np.diff(jv.astype(np.float64), axis=2))
    clear = (gaps > 2 * bound[:, :, 1:]).all(axis=2)
    assert clear.mean() > 0.75  # the comparison is not vacuous
    assert np.array_equal(ji[clear], ti[clear])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k6_bounds_are_sound(dtype):
    """Every emitted value, and every slice bound, is >= the float64 hybrid
    score (0.7 cos + 0.2 min(1, kw + bias) + add_row, from the unrounded
    operands) of each row it stands for."""
    emb, bloom, q, kw, kw_b, add_row = arrs = _fp_operands(12, exact=False)
    sub, t = 512, 4
    _, tdt = FP_DTYPES[dtype]
    vals, idxs = tps.block_topt(torch.from_numpy(emb).to(tdt), *map(_t, arrs[1:]),
                                t=t, sub=sub)
    vals, idxs = vals.numpy().astype(np.float64), idxs.numpy()
    bits = np.concatenate([(bloom.astype(np.int32) >> k) & 1 for k in range(8)], axis=1)
    cos = q.astype(np.float64) @ emb.astype(np.float64).T
    kwd = np.minimum(kw.astype(np.float64) @ bits.T.astype(np.float64) + kw_b, 1.0)
    exact = 0.7 * cos + 0.2 * kwd + add_row.astype(np.float64)
    live = add_row[0] > -1e29
    rows = np.arange(FP_N).reshape(-1, sub)
    for qi in range(FP_B):
        for sl in range(FP_N // sub):
            emitted = idxs[qi, sl, :t]
            assert np.all(vals[qi, sl, :t] >= exact[qi, emitted])
            rest = np.setdiff1d(rows[sl][live[rows[sl]]], emitted)
            if rest.size:
                assert vals[qi, sl, t] >= exact[qi, rest].max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k6_score_topm_matches_pallas(dtype):
    """K6 + merge through the engine entry (make_add_row, the merged
    boundary) on exactly-summable inputs."""
    emb, bloom, q, kw, kw_b, _ = _fp_operands(13, exact=True)
    rng = np.random.default_rng(13)
    created = np.sort((rng.random(FP_N) * 100).astype(np.float32))
    valid = rng.random(FP_N) > 0.1
    jdt, tdt = FP_DTYPES[dtype]
    arrs = (bloom, created, valid, q, kw, kw_b[:, 0])
    jv, ji = jps.score_topm(jnp.asarray(emb).astype(jdt), *map(jnp.asarray, arrs),
                            jnp.float32(60.0), jnp.int32(0), m=16, t=4, sub=512,
                            interpret=True)
    tv, ti = tps.score_topm(torch.from_numpy(emb).to(tdt), *map(_t, arrs),
                            torch.tensor(60.0), 0, m=16, t=4, sub=512)
    assert _bits_equal(jv, tv.numpy())
    assert _bits_equal(ji, ti.numpy())
