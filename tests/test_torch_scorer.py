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
