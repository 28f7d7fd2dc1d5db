"""The port's plain-torch xla scorer (omni_recall_tpu_torch/ops/xla_scorer.py)
against the JAX package's ops/xla_scorer.py on the CPU.

Inputs are made with numpy from a seed and fed to both. Both compute the
scores with f32 matrix products whose summation order neither fixes, so
scores are held to the shape bound of a reordered f32 sum,

    |d ub| <= 0.7 * g(d) * max_row sum_i |q_i c_i| + 0.2 * g(8W) * sum_j w_j
              + 4 ulp(ub)   (the recency exp and the epilogue's additions)

with g(n) = n * 2^-24, and indices equal wherever a value is further than
twice that bound from its neighbours in the top-k. Exact ties (duplicate
rows) must come out lowest row first, as ``jax.lax.top_k`` orders them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.ops import xla_scorer as jxs
from omni_recall_tpu_torch.ops import xla_scorer as txs

N, D, B, W = 4096, 256, 16, 32
NOW = 90.0
WINDOW = 100


def _inputs(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[5] = 0.0  # a chunk without an embedding
    bloom = rng.integers(0, 256, size=(n, W), dtype=np.uint8)
    created = np.sort((rng.random(n) * 100).astype(np.float32))
    valid = rng.random(n) > 0.1
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = 0.0  # a query without an embedding
    kw = np.where(rng.random((B, 8 * W)) < 0.05, rng.random((B, 8 * W)) * 0.1,
                  0).astype(np.float32)
    kw_b = (rng.random(B) * 0.05).astype(np.float32)
    # duplicate rows: exact score ties inside the window
    for src, dup in ((200, 201), (200, 203), (1000, 1002)):
        if dup < n:
            emb[dup], bloom[dup], created[dup] = emb[src], bloom[src], created[src]
            valid[src] = valid[dup] = True
    return emb, bloom, created, valid, q, kw, kw_b


def _bound(emb, q, kw, ub):
    """Per-query shape bound on |ub_port - ub_jax| (module docstring)."""
    g = lambda n: n * 2.0**-24  # noqa: E731
    cos_abs = np.abs(q.astype(np.float64)) @ np.abs(emb.astype(np.float64)).T
    per_q = 0.7 * g(D) * cos_abs.max(axis=1) + 0.2 * g(8 * W) * kw.sum(axis=1)
    return per_q[:, None] + 4 * np.spacing(np.abs(np.where(np.isfinite(ub), ub, 0)))


def _jax(fn, arrs, *rest, **kw):
    return fn(*map(jnp.asarray, arrs), *rest, **kw)


def _torch(fn, arrs, *rest, **kw):
    return fn(*map(torch.from_numpy, arrs), *rest, **kw)


def test_unpack_bloom_bits_matches_jax():
    bloom = np.random.default_rng(0).integers(0, 256, size=(64, W), dtype=np.uint8)
    want = np.asarray(jxs.unpack_bloom_bits(jnp.asarray(bloom)))
    assert np.array_equal(want, txs.unpack_bloom_bits(torch.from_numpy(bloom)).numpy())


def test_ub_scores_match_jax_within_the_sum_order_bound():
    arrs = _inputs(1)
    j = np.asarray(_jax(jxs.ub_scores, arrs, jnp.float32(NOW), jnp.int32(WINDOW)))
    t = _torch(txs.ub_scores, arrs, NOW, WINDOW).numpy()
    assert j.shape == t.shape == (B, N) and t.dtype == np.float32
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t))
    bound = _bound(arrs[0], arrs[4], arrs[5], j)
    assert np.all(np.abs(j[fin] - t[fin]) <= bound[fin])


@pytest.mark.parametrize("m", [32, 200])
def test_score_topm_matches_jax(m):
    arrs = _inputs(2)
    jv, ji = map(np.asarray, _jax(jxs.score_topm, arrs, jnp.float32(NOW), jnp.int32(WINDOW),
                                  m=m))
    tv, ti = _torch(txs.score_topm, arrs, NOW, WINDOW, m=m, slab_rows=1024)
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.shape == ti.shape == jv.shape == (B, m + 1)
    assert ti.dtype == np.int32
    bound = _bound(arrs[0], arrs[4], arrs[5], jv)
    assert np.all(np.abs(jv - tv) <= bound)
    # indices equal outside near-ties: a value further than twice the bound
    # from both of its neighbours holds its position in both orders
    gap = np.full(jv.shape, np.inf)
    diffs = np.abs(np.diff(jv.astype(np.float64), axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diffs)
    gap[:, :-1] = np.minimum(gap[:, :-1], diffs)
    clear = gap > 2 * bound
    assert clear.mean() > 0.75  # the comparison is not vacuous
    assert np.array_equal(ji[clear], ti[clear])


def test_duplicate_rows_come_lowest_index_first():
    """Rows 200, 201, 203 are one vector, one signature and one date: their
    scores tie exactly in every order of summation, and both top-ks list them
    lowest row first."""
    arrs = _inputs(3)
    emb, q = arrs[0], arrs[4].copy()
    q[0] = emb[200]  # row 200 and its duplicates lead query 0
    arrs = (*arrs[:4], q, *arrs[5:])
    _, ji = _jax(jxs.score_topm, arrs, jnp.float32(NOW), jnp.int32(0), m=8)
    tv, ti = _torch(txs.score_topm, arrs, NOW, 0, m=8, slab_rows=202)
    assert list(np.asarray(ji)[0, :3]) == list(ti.numpy()[0, :3]) == [200, 201, 203]
    assert tv[0, 0] == tv[0, 1] == tv[0, 2]


@pytest.mark.parametrize("slab_rows", [128, 202, 1000, 1 << 16])
def test_slabbed_topk_equals_one_shot_topk(slab_rows):
    arrs = _inputs(4)
    ub = _torch(txs.ub_scores, arrs, NOW, WINDOW)
    want_v, want_i = txs._topk_rows(ub, 65)
    got_v, got_i = _torch(txs.score_topm, arrs, NOW, WINDOW, m=64, slab_rows=slab_rows)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


def test_topk_rows_matches_jax_blocked_and_tied():
    """``_topk_rows`` against JAX's, over rows past its blocked threshold
    (two-stage reduction) with many exact ties."""
    rng = np.random.default_rng(5)
    scores = np.round(rng.random((3, 4 * 16384)), 2).astype(np.float32)
    scores[1, ::7] = -np.inf
    jv, ji = jxs._topk_rows(jnp.asarray(scores), 40)
    tv, ti = txs._topk_rows(torch.from_numpy(scores), 40)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())


def test_masked_and_out_of_window_rows_are_neg_inf():
    arrs = _inputs(6)
    valid = arrs[3]
    ub = _torch(txs.ub_scores, arrs, NOW, WINDOW).numpy()
    rows = np.arange(N)
    masked = ~valid | (rows < WINDOW)
    assert np.all(np.isneginf(ub[:, masked]))
    assert np.all(np.isfinite(ub[:, ~masked]))
    tv, ti = _torch(txs.score_topm, arrs, NOW, WINDOW, m=64, slab_rows=512)
    assert not masked[ti.numpy()].any()


def test_output_width_when_rows_are_fewer_than_m_plus_one():
    arrs = _inputs(7, n=48)
    jv, ji = _jax(jxs.score_topm, arrs, jnp.float32(NOW), jnp.int32(0), m=64)
    tv, ti = _torch(txs.score_topm, arrs, NOW, 0, m=64, slab_rows=16)
    assert tuple(tv.shape) == tuple(ti.shape) == np.asarray(jv).shape == (B, 48)
    fin = np.isfinite(np.asarray(jv))
    assert np.array_equal(fin, np.isfinite(tv.numpy()))
    assert np.array_equal(np.sort(np.asarray(ji), axis=1), np.sort(ti.numpy(), axis=1))


def test_products_refuse_tf32(monkeypatch):
    """TF32 would break the CERT_EPS margin: the scorer raises rather than
    flip the process-wide setting."""
    arrs = _inputs(8, n=64)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        _torch(txs.score_topm, arrs, NOW, 0, m=8)
    monkeypatch.undo()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            _torch(txs.ub_scores, arrs, NOW, 0)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert _torch(txs.ub_scores, arrs, NOW, 0).shape == (B, 64)
