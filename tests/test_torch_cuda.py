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
from omni_recall_tpu_torch.ops.oracle import COSINE_WEIGHT
from omni_recall_tpu_torch.tools import (
    probe_keys_emit,
    probe_pipe,
    profile_bloomT,
    profile_kernel,
)

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


@pytest.mark.parametrize("variant", list(profile_kernel.VARIANTS))
@pytest.mark.parametrize("c, b", [(1024, 45), (2048, 45), (4096, 128), (1024, 8)])
def test_profile_kernel_t1(dev, variant, c, b):
    """T1's three variants over bf16 rows at each of the tool's blocks (query
    tiles 32, 16 and 8), with batches that are not a multiple of the tile,
    and serving-like sparse keyword weights."""
    g = torch.Generator(device=dev).manual_seed(7)
    n, d, w = 8192, 768, 128
    emb = torch.randn((n, d), generator=g, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    q = torch.randn((b, d), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    kw = torch.where(torch.rand((b, 8 * w), generator=g, device=dev) < 0.03,
                     torch.rand((b, 8 * w), generator=g, device=dev) * 0.1,
                     torch.zeros((), device=dev))
    o = _operands(dev, n, 16, b, w, seed=8)
    args = (emb.to(torch.bfloat16), o["bloom"], q, kw, o["kw_b"], o["add_row"])
    before = cuda.LAUNCHES["profile_kernel"]
    got = profile_kernel.profile_scan(variant, *args, c)
    want = profile_kernel.profile_scan_plain(variant, *args, c)
    assert cuda.LAUNCHES["profile_kernel"] == before + 1
    assert _same(got, want)
    assert profile_kernel.query_tile(c) == {1024: 32, 2048: 16, 4096: 8}[c]


@pytest.mark.parametrize("bits", [512, 1024])
@pytest.mark.parametrize("b", [45, 448])
def test_profile_bloom_t5(dev, bits, b):
    """T5 on both bloom layouts (W = 64 and 128), bitwise against its plain
    version and each against the other."""
    g = torch.Generator(device=dev).manual_seed(9)
    n, d, w = 8192, 768, bits // 8

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    emb8, q8, kw8 = ri(-127, 127, (n, d), torch.int8), ri(-127, 127, (b, d), torch.int8), \
        ri(0, 2, (b, bits), torch.int8)
    bloom = ri(0, 256, (n, w), torch.uint8)
    add = torch.rand((1, n), generator=g, device=dev) * 0.1
    before = cuda.LAUNCHES["profile_bloomT"]
    row = profile_bloomT.bloom_scan(emb8, bloom, q8, kw8, add, False)
    cols = profile_bloomT.bloom_scan(emb8, bloom.T.contiguous(), q8, kw8, add, True)
    assert cuda.LAUNCHES["profile_bloomT"] == before + 2
    want = profile_bloomT.bloom_scan_plain(emb8, bloom, q8, kw8, add, False)
    assert _same(row, want) and _same(cols, want)


@pytest.mark.parametrize("sub, t, s", [(1024, 2, 16), (512, 4, 16), (512, 4, 3),
                                       (1024, 1, 5), (256, 2, 1)])
@pytest.mark.parametrize("b", [8, 45, 128, 448])
def test_probe_pipe_t2(dev, sub, t, s, b):
    """T2 at both query tiles (32 at sub 512 and 256, 16 at sub 1024), packed
    and two-reduce extraction, blocks of S slices where S does not divide
    the slice count, ragged batches; three launches of each, every one
    bitwise against its plain version and against K1's kernel."""
    n = 8192
    o = _operands(dev, n, 768, b, 128, seed=10)
    args = (o["emb8"], o["q8"], o["add_row"], o["scale_row"], COSINE_WEIGHT * o["q_scale"],
            o["q_bias"])
    before = cuda.LAUNCHES["probe_pipe"]
    got = [probe_pipe.pipe_scan(*args, t, sub, sub, slices_per_block=s) for _ in range(3)]
    assert cuda.LAUNCHES["probe_pipe"] == before + 3
    want_v, want_i = probe_pipe.pipe_scan_plain(*args, t, sub, sub)
    k1_v, k1_i = scorer.block_topt_int8_coarse(
        *(o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")),
        t=t, sub=sub, block=sub)
    for v, i in got:
        assert _same(v, want_v) and _same(i, want_i)
        assert _same(v.transpose(0, 1).reshape(k1_v.shape), k1_v)
        assert _same(i.transpose(0, 1).reshape(k1_i.shape), k1_i)
    assert probe_pipe.query_tile(768, sub) == (16 if sub == 1024 else 32)


def _keys_operands(dev, n, d, b, seed):
    """T4's operands: random bits read as int8 (-128 occurs), every fifth
    row a repeat of the one before (equal scores), random scales."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def bits(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev).to(torch.uint8).view(
            torch.int8)

    emb8, q8 = bits((n, d)), bits((b, d))
    scale = torch.rand((1, n), generator=g, device=dev) * 1e-3 + 1e-5
    twins = torch.arange(0, n - 1, 5, device=dev)
    emb8[twins + 1] = emb8[twins]
    scale[0, twins + 1] = scale[0, twins]
    return emb8, q8, scale, torch.rand((b, 1), generator=g, device=dev) * 1e-2 + 1e-4


@pytest.mark.parametrize("emit", list(probe_keys_emit.EMITS))
@pytest.mark.parametrize("c, sub, t1", [(1024, 1024, 3), (1024, 512, 3), (2048, 256, 5),
                                        (128, 2, 2), (256, 1, 1)])
@pytest.mark.parametrize("b", [8, 45, 128, 448])
def test_probe_keys_emit_t4(dev, emit, c, sub, t1, b):
    """T4's three emits at the tool's layout, blocks of several slices and
    slices of two rows and of one (keys that are whole scores), ragged
    batches: bitwise against the plain version; P3 decoded against pair's
    values."""
    arrs = _keys_operands(dev, 8192, 768, b, seed=11)
    before = cuda.LAUNCHES["probe_keys_emit"]
    got = probe_keys_emit.keys_scan(*arrs, c, sub, t1, emit)
    assert cuda.LAUNCHES["probe_keys_emit"] == before + 1
    want = probe_keys_emit.keys_scan_plain(*arrs, c, sub, t1, emit)
    if emit == "pair":
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    else:
        assert _same(got, want)
    if emit == "p3":
        vals, _ = probe_keys_emit.keys_scan(*arrs, c, sub, t1, "pair")
        assert _same(probe_keys_emit.decode_up(got, sub), vals)


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
