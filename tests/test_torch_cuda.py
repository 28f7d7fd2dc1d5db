"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: on a machine without a card every test here skips (the
decision is taken in a fixture, so every worker collects the same tests).
Run on the card with ``python -m pytest -m cuda --noconftest
tests/test_torch_cuda.py``. Bitwise, except K2's sabs (any summation
order, held to SABS_REL).
"""

import pytest
import torch

from omni_recall_tpu_torch.index.device_index import device_quantize
from omni_recall_tpu_torch.ops import cuda, exact_cos, refine, scorer

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _operands(dev, n, d, b, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    def rf(shape, scale=1.0, offset=0.0):
        return torch.rand(shape, generator=g, device=dev) * scale + offset

    add_row = rf((1, n), 0.1)
    add_row[0, :5] = -1e30
    return dict(
        emb8=ri(-127, 128, (n, d), torch.int8), q8=ri(-127, 128, (b, d), torch.int8),
        bloom=ri(0, 256, (n, w), torch.uint8),
        kw_w8=torch.where(rf((b, 8 * w)) < 0.1, ri(0, 128, (b, 8 * w), torch.int8),
                          torch.zeros((), dtype=torch.int8, device=dev)),
        kw_b=rf((b, 1), 0.05), add_row=add_row, scale_row=rf((1, n), 0.01, 1e-3),
        q_scale=rf((b, 1), 0.01, 1e-3), q_bias=rf((b, 1), 0.01),
    )


@pytest.mark.parametrize("sub, t, d", [(512, 2, 768), (512, 1, 768), (1024, 2, 768),
                                       (64, 3, 768), (32, 2, 768), (1024, 4, 1024),
                                       (512, 2, 384), (2048, 2, 768)])
def test_coarse_scan_kernel(dev, sub, t, d):
    """sub=2048 needs the 16-query shared-memory tile."""
    o = _operands(dev, 8192, d, 40, 128)
    args = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    # the two-reduce (pair) extraction mode counts as K7a
    key = ("coarse_scan" if scorer._packed_mode(*scorer._coarse_shape(8192, 40, t, sub, None))
           else "coarse_pair")
    before = cuda.LAUNCHES[key]
    kv, ki = scorer.block_topt_int8_coarse(*args, t=t, sub=sub)
    pv, pi = scorer.block_topt_int8_coarse_plain(*args, t=t, sub=sub)
    assert cuda.LAUNCHES[key] == before + 1
    assert _same(kv, pv) and _same(ki, pi)


@pytest.mark.parametrize("sub, t, w", [(512, 4, 128), (512, 1, 128), (256, 2, 128),
                                       (512, 4, 256)])
def test_fused_scan_kernel(dev, sub, t, w):
    """w=256 (2048 bloom bits, the server default) needs the 16-query
    shared-memory tile."""
    o = _operands(dev, 8192, 768, 448, w, seed=1)
    keys = ("emb8", "bloom", "q8", "kw_w8", "kw_b", "add_row", "scale_row", "q_scale", "q_bias")
    kv, ki = scorer.block_topt_int8(*(o[k] for k in keys), t=t, sub=sub)
    pv, pi = scorer.block_topt_int8_plain(*(o[k] for k in keys), t=t, sub=sub)
    assert _same(kv, pv) and _same(ki, pi)


@pytest.mark.parametrize("w", [128, 16, 256])
def test_kw_scan_kernel(dev, w):
    """w=256 at sub 1024 needs the 16-query shared-memory tile."""
    o = _operands(dev, 8192, 64, 37, w, seed=2)
    keys = ("bloom", "kw_w8", "kw_b", "add_row")
    kv, ki = scorer.block_topt_kw_only(*(o[k] for k in keys), t=4, sub=1024)
    pv, pi = scorer.block_topt_kw_only_plain(*(o[k] for k in keys), t=4, sub=1024)
    assert _same(kv, pv) and _same(ki, pi)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub, t, d", [(512, 4, 768), (512, 1, 768), (256, 2, 100),
                                       (1024, 4, 768)])
def test_fp_scan_kernel(dev, dtype, sub, t, d):
    """K6 on bf16 and f32 storage, packed (t1 >= 3) and two-reduce (t1 = 2)
    extraction; bf16 at sub 1024 takes the 32-query tile, f32 rows cap the
    block at 1024."""
    g = torch.Generator(device=dev).manual_seed(5)
    n, b, w = 8192, 45, 128
    emb = torch.randn((n, d), generator=g, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    q = torch.randn((b, d), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    o = _operands(dev, n, 16, b, w, seed=6)
    kw = torch.where(torch.rand((b, 8 * w), generator=g, device=dev) < 0.05,
                     torch.rand((b, 8 * w), generator=g, device=dev) * 0.1,
                     torch.zeros((), device=dev))
    args = (emb.to(dtype), o["bloom"], q, kw, o["kw_b"], o["add_row"])
    before = cuda.LAUNCHES["fp_scan"]
    kv, ki = scorer.block_topt(*args, t=t, sub=sub)
    pv, pi = scorer.block_topt_plain(*args, t=t, sub=sub)
    assert cuda.LAUNCHES["fp_scan"] == before + 1
    assert _same(kv, pv) and _same(ki, pi)


@pytest.mark.parametrize("d", [768, 100])
def test_dd_rows_kernel(dev, d):
    g = torch.Generator(device=dev).manual_seed(3)
    raw = torch.randn((5000, d), generator=g, device=dev)
    q = torch.randn((37, d), generator=g, device=dev)
    rows = torch.randint(-1, 5000, (37, 32), generator=g, device=dev).to(torch.int32)
    h, lo, s = exact_cos.exact_cos_rows(raw, rows, q)
    ph, plo, ps = exact_cos.exact_cos_rows_plain(raw, rows, q)
    assert _same(h, ph) and _same(lo, plo)
    assert float(((s - ps).abs() / ps.abs()).max()) <= exact_cos.SABS_REL


def _refine_inputs(dev, n, d, b, m, w, seed):
    """Index planes + candidates at the chip shapes, with sentinel slots,
    invalid rows and -inf scan bounds."""
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((n, d), generator=g, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    planes = device_quantize(emb, refine=True)
    q = torch.randn((b, d), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    rows = torch.randint(-1, n, (b, m), generator=g, device=dev).to(torch.int32)
    vals = torch.randn((b, m), generator=g, device=dev)
    vals[torch.rand((b, m), generator=g, device=dev) < 0.02] = float("-inf")
    kw = torch.where(torch.rand((b, 8 * w), generator=g, device=dev) < 0.05,
                     torch.rand((b, 8 * w), generator=g, device=dev) * 0.3,
                     torch.zeros((), device=dev))
    return (planes["emb"], planes["scale"], planes["emb2"], planes["scale2"], planes["err2"],
            torch.randint(0, 256, (n, w), generator=g, device=dev).to(torch.uint8),
            torch.rand((n,), generator=g, device=dev) * 400,
            torch.rand((n,), generator=g, device=dev) > 0.1,
            q, refine.quantize_kw_weights(kw), torch.rand((b,), generator=g, device=dev) * 0.1,
            365.0, rows, vals)


@pytest.mark.parametrize("b, m", [(448, 64), (64, 2048)])
def test_refine_kernel(dev, b, m):
    """K3 at the select stage's and the rescue stage's shapes (d = 768,
    1024 bloom bits), bitwise against its plain version."""
    args = _refine_inputs(dev, 1 << 16, 768, b, m, 128, seed=b + m)
    before = cuda.LAUNCHES["refine"]
    got = refine._refine_dispatch(*args)
    want = refine.refine_bounds_plain(*args)
    assert cuda.LAUNCHES["refine"] == before + 1
    assert _same(got, want)
    assert bool(torch.isneginf(got).any()) and bool(torch.isfinite(got).any())


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    o = _operands(dev, 4096, 72, 8, 16)  # d % 16 != 0
    args = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    with pytest.raises(ValueError, match="d % 16"):
        scorer.block_topt_int8_coarse(*args, t=2, sub=512)
    with pytest.raises(ValueError, match="d % 4"):
        scorer.block_topt(torch.zeros((4096, 70), device=dev), o["bloom"],
                          torch.zeros((8, 70), device=dev), torch.zeros((8, 128), device=dev),
                          o["kw_b"], o["add_row"], t=4)
    raw = torch.zeros((10, 1 << 15), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        exact_cos.exact_cos_rows(raw, torch.zeros((1, 1), dtype=torch.int32, device=dev),
                                 torch.zeros((1, 1 << 15), device=dev))
    args = list(_refine_inputs(dev, 4096, 768, 8, 16, 128, seed=4))
    args[12] = args[12].to(torch.int64)  # rows must be int32
    with pytest.raises(ValueError, match="rows"):
        refine._refine_dispatch(*args)
