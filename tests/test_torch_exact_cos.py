"""The port's double-float cosine (omni_recall_tpu_torch/ops/exact_cos.py)
against the JAX graph (omni_recall_tpu/ops/exact_cos.py) on the CPU.

hi and lo must be bitwise equal: both evaluate the same TwoSum halving tree
with the same IEEE f32 operations. sabs is an f32 sum of |p| whose order
differs between the two; it is held to SABS_REL, the bound the certificate
already allows for any summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.ops import exact_cos as jec
from omni_recall_tpu_torch.ops import exact_cos as tec


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _sabs_ok(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.all(np.abs(a - b) <= tec.SABS_REL * np.abs(a))


@pytest.mark.parametrize("d", [768, 100, 128])
def test_dd_sum_products_matches_jax(d):
    rng = np.random.default_rng(d)
    q = rng.standard_normal((6, d)).astype(np.float32)
    c = rng.standard_normal((6, 9, d)).astype(np.float32)
    c[0, 0] = 0.0          # zero row
    c[1, 1] = -c[1, 0]     # cancellation
    jh, jl, js = jec.dd_sum_products(jnp.asarray(q)[:, None, :], jnp.asarray(c))
    th, tl, ts = tec.dd_sum_products(torch.from_numpy(q)[:, None, :], torch.from_numpy(c))
    assert _eq(jh, th.numpy()) and _eq(jl, tl.numpy())
    assert _sabs_ok(js, ts.numpy())


@pytest.mark.parametrize("d", [768, 100])
def test_exact_cos_rows_matches_jax_including_empty_slots(d):
    rng = np.random.default_rng(d + 1)
    raw = rng.standard_normal((300, d)).astype(np.float32)
    q = rng.standard_normal((5, d)).astype(np.float32)
    rows = rng.integers(-1, 300, size=(5, 12)).astype(np.int32)
    rows[:, 0] = -1  # empty slots read row 0
    j = jec.exact_cos_rows(jnp.asarray(raw), jnp.asarray(rows), jnp.asarray(q))
    t = tec.exact_cos_rows(torch.from_numpy(raw), torch.from_numpy(rows), torch.from_numpy(q))
    assert _eq(j[0], t[0].numpy()) and _eq(j[1], t[1].numpy())
    assert _sabs_ok(j[2], t[2].numpy())
    # the empty slot equals a read of row 0
    assert _eq(t[0][:, 0].numpy(),
               tec.exact_cos_rows(torch.from_numpy(raw), torch.zeros_like(torch.from_numpy(rows)),
                                  torch.from_numpy(q))[0][:, 0].numpy())


@pytest.mark.parametrize("d", [768, 100])
def test_dd_rows_over_gathered_rows_matches_jax_and_the_by_index_entry(d):
    """``dd_rows(q_raw, c)``, K2's second entry (rows already gathered, the
    sharded path's owner gather): hi and lo bitwise the JAX ``dd_rows``,
    sabs within SABS_REL, and on the same rows every output bitwise the
    by-index entry's."""
    rng = np.random.default_rng(d + 7)
    raw = rng.standard_normal((200, d)).astype(np.float32)
    raw[3] = 0.0                # a zero row
    raw[4] = -raw[5]            # cancellation against row 5
    q = rng.standard_normal((4, d)).astype(np.float32)
    rows = rng.integers(0, 200, size=(4, 10)).astype(np.int32)
    rows[0, :3] = (3, 4, 5)
    c = raw[rows]               # [B, t, d]
    jh, jl, js = jec.dd_rows(jnp.asarray(q), jnp.asarray(c))
    th, tl, ts = tec.dd_rows(torch.from_numpy(q), torch.from_numpy(c))
    assert th.shape == (4, 10)
    assert _eq(jh, th.numpy()) and _eq(jl, tl.numpy())
    assert _sabs_ok(js, ts.numpy())
    bh, bl, bs = tec.exact_cos_rows(torch.from_numpy(raw), torch.from_numpy(rows),
                                    torch.from_numpy(q))
    assert _eq(bh.numpy(), th.numpy()) and _eq(bl.numpy(), tl.numpy())
    assert _eq(bs.numpy(), ts.numpy())


def test_self_norm_dd_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((7, 768)).astype(np.float32)
    q[2] = 0.0
    jh, jl = jec.self_norm_dd(jnp.asarray(q))
    th, tl = tec.self_norm_dd(torch.from_numpy(q))
    assert _eq(jh, th.numpy()) and _eq(jl, tl.numpy())


def test_dd_error_within_certified_bound():
    """|(hi + lo) - exact sum| <= DD_SUM_REL * sabs against an f64 ground truth."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((4, 768)).astype(np.float32)
    c = rng.standard_normal((4, 16, 768)).astype(np.float32)
    hi, lo, sabs = tec.dd_sum_products(torch.from_numpy(q)[:, None, :], torch.from_numpy(c))
    p = (q[:, None, :] * c).astype(np.float64)  # exact f32 products, widened
    exact = p.sum(-1)
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64) - exact)
    assert np.all(err <= tec.DD_SUM_REL * sabs.numpy().astype(np.float64))


def test_host_finish_helpers_are_the_jax_ones():
    """finish_cosines and round4_certified are numpy copies: same values."""
    rng = np.random.default_rng(5)
    hi = rng.standard_normal(50).astype(np.float32)
    lo = (rng.standard_normal(50) * 1e-8).astype(np.float32)
    sabs = np.abs(rng.standard_normal(50)).astype(np.float32) * 10
    qn = rng.random(50) + 0.5
    rn = rng.random(50) + 0.5
    rn[3] = 0.0
    jc, jm = jec.finish_cosines(hi, lo, sabs, qn, rn)
    tc, tm = tec.finish_cosines(hi, lo, sabs, qn, rn)
    assert np.array_equal(jc, tc) and np.array_equal(jm, tm)
    scores = rng.random(50)
    scores[0] = 0.12345  # a rounding midpoint neighbourhood
    assert np.array_equal(jec.round4_certified(scores, jm), tec.round4_certified(scores, tm))
