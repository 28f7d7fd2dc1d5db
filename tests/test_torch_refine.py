"""The port's refine stage (ops/refine.py: K3's plain version, the residual
query quantizer, the device quantizer's residual plane and the compact
selection) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Which JAX
order each comparison uses:

- ``refine._refine_bounds_fused(interpret=True)`` is the TPU kernel in
  interpret mode; the port's plain version follows its f32 order. They
  differ only where XLA's ``exp`` and PyTorch's differ by an ulp in the
  recency term: held to 1e-6.
- ``refine.refine_ub`` (what the JAX engine serves on a CPU) combines the
  scale products first: held to the same 1e-6, the reorder tolerance of
  tests/test_refine.py with headroom (REFINE_EPS budgets 3e-5 for it).

Integer planes and dot products are bitwise; error bounds derived from f32
norms (eq2, err2) within 2 ulp: XLA fuses the squares into its blocked sums.
"""

from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.index import device_index as jdi
from omni_recall_tpu.ops import refine as jref
from omni_recall_tpu.ops.pallas_scorer import quantize_kw_weights as j_kw8
from omni_recall_tpu.ops.quantize import quantize_rows_int8_residual
from omni_recall_tpu_torch.index import device_index as tdi
from omni_recall_tpu_torch.ops import hashing, oracle
from omni_recall_tpu_torch.ops import refine as tref
from omni_recall_tpu_torch.ops import scorer as tscorer

N, D, BITS, B = 4096, 256, 256, 16
W = BITS // 8
NOW_DAYS = 365.0


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def _inputs(m: int, seed: int = 0):
    """Index planes + a batch of candidates, with sentinel slots (row -1),
    invalid rows, -inf scan bounds and a zero (keyword-only) query."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[7] = 0.0
    q1, s1, _, q2, s2, err2 = quantize_rows_int8_residual(emb)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = 0.0
    rows = rng.integers(0, N, size=(B, m)).astype(np.int32)
    rows[0, 0] = -1
    rows[5, m // 2] = -1
    rows[2, 1 % m] = 7
    vals = rng.standard_normal((B, m)).astype(np.float32)
    vals[1, m - 1] = -np.inf
    vals[4, 0] = -np.inf
    return dict(
        emb1=q1, scale1=s1, emb2=q2, scale2=s2, err2=err2,
        bloom=rng.integers(0, 256, size=(N, W), dtype=np.uint8),
        created=rng.uniform(0, 400, N).astype(np.float32),
        valid=rng.random(N) > 0.15,
        q=q,
        kw_w=np.where(rng.random((B, BITS)) < 0.1,
                      rng.uniform(0, 0.3, (B, BITS)), 0.0).astype(np.float32),
        kw_bias=rng.uniform(0, 0.1, B).astype(np.float32),
        rows=rows, vals=vals,
    )


_ORDER = ("emb1", "scale1", "emb2", "scale2", "err2", "bloom", "created", "valid",
          "q", "kw_w8", "kw_bias", "now", "rows", "vals")


def _jax_args(x):
    a = {k: jnp.asarray(v) for k, v in x.items() if k != "kw_w"}
    a["kw_w8"] = j_kw8(jnp.asarray(x["kw_w"]))
    a["now"] = jnp.float32(NOW_DAYS)
    return [a[k] for k in _ORDER]


def _torch_args(x):
    a = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items() if k != "kw_w"}
    a["kw_w8"] = tref.quantize_kw_weights(torch.from_numpy(x["kw_w"]))
    a["now"] = float(np.float32(NOW_DAYS))
    return [a[k] for k in _ORDER]


def _close(t, j, tol=1e-6):
    t, j = np.asarray(t), np.asarray(j)
    assert np.array_equal(np.isfinite(t), np.isfinite(j))
    assert np.array_equal(t == -np.inf, j == -np.inf)
    fin = np.isfinite(j)
    assert np.max(np.abs(t[fin] - j[fin])) <= tol


def test_query_residual_quantization_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = 0.0
    # under jit, as the JAX refine graphs run it
    j = [np.asarray(v) for v in jax.jit(jref.quantize_queries_int8_residual)(jnp.asarray(q))]
    t = [v.numpy() for v in tref.quantize_queries_int8_residual(torch.from_numpy(q))]
    for name, jv, tv in zip(("q1", "t1", "q2", "t2"), j, t):
        assert jv.dtype == tv.dtype and np.array_equal(jv, tv), name
    assert np.all(_ulps(j[4], t[4]) <= 2)


@pytest.mark.parametrize("d", [768, 256])
def test_device_quantize_residual_planes_match_jax(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((300, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[3] = 0.0
    j = jdi._device_quantize_keep(jnp.asarray(x), True)
    t = tdi.device_quantize(torch.from_numpy(x), refine=True, slab_rows=128)
    for name in ("emb", "scale", "emb2", "scale2"):
        assert np.array_equal(np.asarray(j[name]), t[name].numpy()), name
    for name in ("err", "err2"):
        assert np.all(_ulps(j[name], t[name].numpy()) <= 2), name


@pytest.mark.parametrize("m", [8, 64, 2048])
def test_plain_k3_matches_interpret_mode_kernel(m):
    x = _inputs(m, seed=m)
    want = jref._refine_bounds_fused(*_jax_args(x), interpret=True)
    got = tref.refine_bounds_plain(*_torch_args(x))
    _close(got.numpy(), want)
    assert np.isneginf(got.numpy()[0, 0]) and np.isneginf(got.numpy()[1, m - 1])


@pytest.mark.parametrize("m", [8, 64])
def test_plain_k3_matches_refine_ub(m):
    x = _inputs(m, seed=100 + m)
    _close(tref.refine_bounds_plain(*_torch_args(x)).numpy(), jref.refine_ub(*_jax_args(x)))


def test_dispatch_takes_the_plain_version_on_cpu():
    x = _inputs(64, seed=5)
    args = _torch_args(x)
    assert torch.equal(tref._refine_dispatch(*args), tref.refine_bounds_plain(*args))


@pytest.mark.parametrize("allow", [True, False])
def test_plain_versions_leave_the_tf32_setting_as_found(allow, monkeypatch):
    """The plain K3 and the plain scans turn TF32 off only for their own
    matmuls; the process-wide setting is the caller's afterwards."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", allow)
    tref.refine_bounds_plain(*_torch_args(_inputs(8, seed=6)))
    assert torch.backends.cuda.matmul.allow_tf32 is allow
    a = torch.ones(2, 4, dtype=torch.int8)
    assert torch.equal(tscorer._int_dot(a, a), torch.full((2, 2), 4.0))
    assert torch.backends.cuda.matmul.allow_tf32 is allow


def test_refined_bounds_are_sound():
    """Every refined bound >= the float64 hybrid score of its row, over a
    clustered corpus with real contents, bloom signatures and query terms."""
    rng = np.random.default_rng(9)
    n, d, b, m = 1024, 128, 12, 64
    centers = rng.standard_normal((16, d)).astype(np.float32)
    assign = rng.integers(0, 16, n)
    emb = centers[assign] + 0.4 * rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    contents = [f"topic w{assign[i]}q item {i % 11}" for i in range(n)]
    epoch = datetime(2024, 1, 1, tzinfo=timezone.utc)
    created = [epoch + timedelta(days=float(i) / 5.0, seconds=int(i) * 37) for i in range(n)]
    now = epoch + timedelta(days=240.0)
    q1, s1, _, q2, s2, err2 = quantize_rows_int8_residual(emb)
    bloom = hashing.chunk_signatures_batch([c.lower() for c in contents], BITS, 4, 2)
    queries = [f"w{int(rng.integers(16))}q item" for _ in range(b)]
    qv = centers[rng.integers(0, 16, b)] + 0.3 * rng.standard_normal((b, d)).astype(np.float32)
    qv = (qv / np.linalg.norm(qv, axis=1, keepdims=True)).astype(np.float32)
    weights, biases = hashing.query_bit_weights_batch(
        [oracle.query_terms(s) for s in queries], BITS, 4, 2)
    rows = rng.integers(0, n, size=(b, m)).astype(np.int32)
    days = np.array([(c - epoch).total_seconds() / 86400.0 for c in created], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    refined = tref.refine_bounds_plain(
        t(q1), t(s1), t(q2), t(s2), t(err2), t(bloom), t(days), t(np.ones(n, bool)),
        t(qv), tref.quantize_kw_weights(t(weights.astype(np.float32))),
        t(biases.astype(np.float32)), float(np.float32((now - epoch).total_seconds() / 86400.0)),
        t(rows), t(np.zeros((b, m), np.float32)),
    ).numpy()
    for i in range(b):
        for j in range(m):
            r = int(rows[i, j])
            exact = oracle.score_chunk(queries[i], qv[i], emb[r], contents[r], created[r], now)
            assert refined[i, j] >= exact, (i, r, refined[i, j], exact)


@pytest.mark.parametrize("t_out, r", [(32, 64), (32, 40), (16, 128), (200, 128), (8, 9)])
def test_compact_select_matches_jax(t_out, r):
    rng = np.random.default_rng(t_out + r)
    m = 128
    vals = -np.sort(-rng.standard_normal((B, m + 1)).astype(np.float32), axis=1)
    vals[:, -1] = rng.standard_normal(B).astype(np.float32) - 3.0
    vals[2, 100:] = -np.inf
    idxs = rng.integers(0, N, (B, m + 1)).astype(np.int32)
    idxs[:, -1] = -1
    refined = (vals[:, :r] - rng.uniform(0, 0.5, (B, r))).astype(np.float32)
    refined[0, :3] = refined[0, 3]  # ties keep the scan order
    refined[1, 5] = -np.inf
    j = jref.compact_select(jnp.asarray(vals), jnp.asarray(idxs), jnp.asarray(refined), t_out, r)
    t = tref.compact_select(torch.from_numpy(vals), torch.from_numpy(idxs),
                            torch.from_numpy(refined), t_out, r)
    for jv, tv in zip(j, t):
        assert np.array_equal(np.asarray(jv), tv.numpy())


def test_refine_select_from_scan_is_compact_select_of_the_plain_bounds():
    x = _inputs(64, seed=3)
    a = _torch_args(x)
    vals = torch.cat([a[13].sort(dim=1, descending=True).values,
                      torch.full((B, 1), -2.0)], dim=1)
    idxs = torch.cat([a[12], torch.full((B, 1), -1, dtype=torch.int32)], dim=1)
    kw_w = torch.from_numpy(x["kw_w"])
    sel = tref.refine_select_from_scan(*a[:9], kw_w, a[10], a[11], vals, idxs, t_out=32, r=40)
    refined = tref.refine_bounds_plain(*a[:12], idxs[:, :40].contiguous(),
                                       vals[:, :40].contiguous())
    want = tref.compact_select(vals, idxs, refined, 32, 40)
    for s, w in zip(sel, want):
        assert torch.equal(s, w)
    full = tref.refine_ub_from_scan(*a[:9], kw_w, a[10], a[11], vals, idxs)
    assert torch.equal(full[:, :40], refined)
