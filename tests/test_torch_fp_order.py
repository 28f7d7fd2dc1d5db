"""K6's parity rule does not rest on one summation order.

The card's K6 and T1 (csrc/fp_scan.cu) sum their bf16 products on the
tensor cores, whose order and rounding inside a k-step PTX does not fix. The
plain version (ops/scorer.py ``_seq_dot``) sums in k order, one rounding a
term. Here the plain scan runs again under a second order, as one wgmma
k-step may take it: k-groups of 16 products, each group summed exactly and
then added to the f32 accumulator rounded toward zero. That order is held
to ``_seq_dot``'s by the rule the card tests and chip_smoke.py apply to the
kernel: bit for bit on exactly-summable inputs, within
``scorer.fp_order_bound`` elsewhere, with equal indices in every slice whose
values lie further apart than twice the bound, and such slices over 75%.
"""

import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.ops import scorer as tps

N, D, B, W = 4096, 256, 16, 32


def _rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    r = x.to(torch.float32)
    over = r.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _kgroup_dot(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a[M, K] . bt[K, N] in k-groups of 16: each group's products summed in
    float64 (exact for these bf16 products), then added to the f32
    accumulator and rounded toward zero."""
    acc = torch.zeros((a.shape[0], bt.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        grp = a[:, k0:k0 + 16].double() @ bt[k0:k0 + 16].double()
        acc = _rz32(acc.double() + grp)
    return acc


def _operands(seed: int, exact: bool):
    """``exact``: scorer.fp_exact_operands, the card's part (i) recipe;
    otherwise unit rows and queries and sparse keyword weights in [0, 0.1),
    as tests/test_torch_scorer.py's K6 cases."""
    rng = np.random.default_rng(seed)
    if exact:
        emb, q, kw = (x.numpy() for x in tps.fp_exact_operands(
            torch.Generator().manual_seed(seed), N, D, B, W))
    else:
        emb = rng.standard_normal((N, D)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        q = rng.standard_normal((B, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        kw = np.where(rng.random((B, 8 * W)) < 0.05, rng.random((B, 8 * W)) * 0.1,
                      0).astype(np.float32)
        kw[2] *= 20.0  # a query whose keyword term clamps at 1
    bloom = rng.integers(0, 256, size=(N, W), dtype=np.uint8)
    kw_b = (rng.random((B, 1)) * 0.05).astype(np.float32)
    add_row = (rng.random((1, N)) * 0.1).astype(np.float32)
    add_row[0, rng.random(N) < 0.1] = np.float32(-1e30)
    return tuple(torch.from_numpy(x) for x in (emb, bloom, q, kw, kw_b, add_row))


def _both_orders(monkeypatch, dtype, arrs, t, sub):
    emb, *rest = arrs
    emb = emb.to(dtype)
    seq = tps.block_topt_plain(emb, *rest, t=t, sub=sub)
    with monkeypatch.context() as mp:
        mp.setattr(tps, "_seq_dot", _kgroup_dot)
        grouped = tps.block_topt_plain(emb, *rest, t=t, sub=sub)
    return seq, grouped


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sub, t", [(512, 4), (512, 1), (256, 2)])
def test_kgroup_order_is_bitwise_on_exactly_summable_inputs(monkeypatch, dtype, sub, t):
    (sv, si), (gv, gi) = _both_orders(monkeypatch, dtype, _operands(20, True), t, sub)
    assert _same(sv, gv) and _same(si, gi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sub, t", [(512, 4), (512, 1)])
def test_kgroup_order_is_within_the_bound(monkeypatch, dtype, sub, t):
    """Packed keys (t1 = 5: granule sub ulps) and the two-reduce mode
    (t1 = 2)."""
    arrs = _operands(21, False)
    emb, _, q, kw = arrs[:4]
    (sv, si), (gv, gi) = _both_orders(monkeypatch, dtype, arrs, t, sub)
    t1 = min(t + 1, sub)
    bound = tps.fp_order_bound(
        sv, tps.fp_cos_mass(q, emb.to(dtype)), kw, d=D,
        granule=sub if tps._packed_mode(sub, t1) else 0)
    got = tps.fp_order_check(gv, sv, bound, gi, si)
    assert got["within"], got
    assert got["indices_equal_where_clear"], got
    assert got["clear_share"] > 0.75, got


def test_kgroup_order_scores_differ_within_the_bound(monkeypatch):
    """The raw scores (before the extraction's granule) of the two orders
    differ on random inputs, and stay within the bound with no granule."""
    emb, bloom, q, kw, kw_b, add_row = _operands(22, False)
    emb_t = tps._bf16_round(emb).T.contiguous()
    bits_t = tps._bloom_bits(bloom).T.to(torch.float32).contiguous()
    seq = tps._fp_scores_plain(q, kw, kw_b, emb_t, bits_t, add_row)
    with monkeypatch.context() as mp:
        mp.setattr(tps, "_seq_dot", _kgroup_dot)
        grouped = tps._fp_scores_plain(q, kw, kw_b, emb_t, bits_t, add_row)
    bound = tps.fp_order_bound(seq, tps.fp_cos_mass(q, emb), kw, d=D)
    got = tps.fp_order_check(grouped, seq, bound)
    assert got["within"] and got["max_abs_err"] > 0, got


def _rounded_otherwise(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x rounded to bf16 toward zero or with ties away from zero, or kept
    at TF32's width (10 fraction bits, nearest-even)."""
    v = x.to(torch.float32).view(torch.int32)
    if mode == "toward_zero":
        v = v & -0x10000
    elif mode == "ties_away":
        v = (v + 0x8000) & -0x10000
    else:
        v = (v + 0xFFF + ((v >> 13) & 1)) & -0x2000
    return v.view(torch.float32)


@pytest.mark.parametrize("operand", ["rows", "queries", "keyword_weights"])
@pytest.mark.parametrize("mode", ["toward_zero", "ties_away", "tf32_width"])
def test_exact_inputs_pin_the_bf16_rounding(monkeypatch, operand, mode):
    """Part (i)'s inputs (scorer.fp_exact_operands) hold values bf16 does
    not: a scan that rounds any one operand other than nearest-even, or
    keeps it wider, emits other values, so the bitwise check on the card
    fails on a kernel that does (the wrapper's queries and keyword weights,
    the producer's f32 rows)."""
    arrs = _operands(20, True)
    want = tps.block_topt_plain(*arrs, t=4, sub=512)
    target = {"rows": arrs[0], "queries": arrs[2], "keyword_weights": arrs[3]}[operand]
    nearest = tps._bf16_round
    monkeypatch.setattr(tps, "_bf16_round", lambda x: _rounded_otherwise(x, mode)
                        if x.data_ptr() == target.data_ptr() else nearest(x))
    got = tps.block_topt_plain(*arrs, t=4, sub=512)
    assert not torch.equal(got[0], want[0])


def test_bound_terms():
    """The bound's terms, by hand: 0.7·2g(d)·mass + 0.2·2g(8W)·sum|w|·(1 + 2^-8)
    + (4 + granule) ulp, with g(n) = n·2^-23."""
    values = torch.tensor([[0.75, -1.5]], dtype=torch.float32)
    kw = torch.tensor([[0.5, -0.25, 0.0, 0.25]])
    got = tps.fp_order_bound(values, torch.tensor([0.5]), kw, d=8, granule=4)
    per_q = 0.7 * 2 * 8 * 2.0**-23 * 0.5 + 0.2 * 2 * 4 * 2.0**-23 * 1.0 * (1 + 2.0**-8)
    want = per_q + 8 * torch.tensor([[2.0**-24, 2.0**-23]], dtype=torch.float64)
    assert torch.allclose(got, want, rtol=1e-12, atol=0)
    cos_only = tps.fp_order_bound(values, torch.tensor([0.5]), d=8, cos_weight=1.0)
    assert torch.allclose(cos_only[0, 0], torch.tensor(2 * 8 * 2.0**-23 * 0.5 + 4 * 2.0**-24,
                                                       dtype=torch.float64))


@pytest.mark.parametrize("w", [16, 24, 128])
def test_kw_columns_match_the_kernels_register_fragments(w):
    """csrc/fp_scan.cu builds the keyword dot's A fragments in registers: in
    step s a thread of quad lane q reads one 32-bit word of each of its rows
    r0 = lane / 4 and r1 = r0 + 8, bytes q·W'/4 + 4s + 0..3 (0 past W), and
    plane p's four registers hold bytes (0, 1) and (2, 3) of r0 and r1 as
    bf16 0/1 pairs, the wgmma A layout (row r0 columns 2q, 2q+1; r1 the
    same; then columns 2q+8, 2q+9). That matrix times the wrapper's
    operand (``fp_query_operand``, columns in ``fp_kw_columns`` order) must
    be the plain keyword dot, bit for bit (sums of exact 2^-6 multiples)."""
    rng = np.random.default_rng(w)
    bloom = rng.integers(0, 256, size=(64, w), dtype=np.uint8)
    kw = (rng.integers(0, 20, size=(3, 8 * w)) * 2.0**-6).astype(np.float32)
    wp = -(-w // 16) * 16
    padded = np.zeros((64, wp), np.uint8)
    padded[:, :w] = bloom
    a = np.zeros((64, 8 * wp), np.float32)
    lane = np.arange(128)
    r0 = (lane // 32) * 16 + (lane % 32) // 4
    q = lane % 4
    for s in range(wp // 16):
        byte = q * (wp // 4) + 4 * s
        for p in range(8):
            col = (8 * s + p) * 16 + 2 * q
            for rows, c, o in ((r0, 0, 0), (r0 + 8, 0, 0), (r0, 8, 2), (r0 + 8, 8, 2)):
                for h in range(2):
                    a[rows, col + c + h] = (padded[rows, byte + o + h] >> p) & 1
    operand = tps.fp_query_operand(torch.zeros(3, 64), torch.from_numpy(kw), w)
    got = torch.from_numpy(a) @ operand[:, 64:].float().T
    want = tps._bloom_bits(torch.from_numpy(bloom)).float() @ torch.from_numpy(kw).T
    assert torch.equal(got[:, :3], want)
