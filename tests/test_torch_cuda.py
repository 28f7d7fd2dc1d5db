"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: on a machine without a card every test here skips (the
decision is taken in a fixture, so every worker collects the same tests).
Run on the card with ``python -m pytest -m cuda --noconftest
tests/test_torch_cuda.py``. Bitwise, except K2's sabs (any summation
order, held to SABS_REL) and K6 and T1 on inputs whose partial sums are not
exact: their tensor-core sums are held to the parity rule's bound
(ops/scorer.py fp_order_bound), bitwise on exactly-summable inputs. K1,
K4, K5 and T5 sum int8 products in int32 on the tensor cores, exact in any
order: bitwise.
"""

import pytest
import torch

from omni_recall_tpu_torch.index.device_index import device_quantize
from omni_recall_tpu_torch.ops import cuda, exact_cos, refine, scorer
from omni_recall_tpu_torch.ops.oracle import COSINE_WEIGHT
from omni_recall_tpu_torch.tools import (
    probe_keys_emit,
    probe_pipe,
    probe_serve,
    profile_bloomT,
    profile_kernel,
    ptxas_report,
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


def _operands(dev, n, d, b, w, seed=0, kw_nonzero=0):
    """Scan operands. ``kw_nonzero``: about that many nonzero keyword weights
    a query, each 1 to 8, so that the keyword term mostly stays below its
    clamp at 1 (the default, 10% of the weights at up to 127, clamps every
    query's term, and the keyword dot's value goes unseen)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    def rf(shape, scale=1.0, offset=0.0):
        return torch.rand(shape, generator=g, device=dev) * scale + offset

    add_row = rf((1, n), 0.1)
    add_row[0, :5] = -1e30
    o = dict(
        emb8=ri(-127, 128, (n, d), torch.int8), q8=ri(-127, 128, (b, d), torch.int8),
        bloom=ri(0, 256, (n, w), torch.uint8),
        kw_w8=torch.where(rf((b, 8 * w)) < 0.1, ri(0, 128, (b, 8 * w), torch.int8),
                          torch.zeros((), dtype=torch.int8, device=dev)),
        kw_b=rf((b, 1), 0.05), add_row=add_row, scale_row=rf((1, n), 0.01, 1e-3),
        q_scale=rf((b, 1), 0.01, 1e-3), q_bias=rf((b, 1), 0.01),
    )
    if kw_nonzero:
        o["kw_w8"] = torch.where(rf((b, 8 * w)) < kw_nonzero / (8 * w),
                                 ri(1, 9, (b, 8 * w), torch.int8),
                                 torch.zeros((), dtype=torch.int8, device=dev))
    return o


# K1's query tile at sub (d = 768): its [QT][sub] f32 scores bind
K1_TILE = {32: 32, 64: 32, 512: 32, 1024: 32, 2048: 16}


@pytest.mark.parametrize("sub, t, d", [(512, 2, 768), (512, 1, 768), (1024, 2, 768),
                                       (64, 3, 768), (32, 2, 768), (1024, 4, 1024),
                                       (512, 2, 384), (2048, 2, 768), (1024, 1, 768)])
def test_coarse_scan_kernel(dev, sub, t, d):
    """sub=2048 needs the 16-query shared-memory tile; (1024, t 1) is the
    two-reduce (pair) mode at the serving slice."""
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
    if d == 768:
        assert scorer.int8_query_tile(sub, d) == K1_TILE[sub]


@pytest.mark.parametrize("sub, t", [(1024, 2), (1024, 1)])
@pytest.mark.parametrize("b", [1, 45, 448])
def test_coarse_scan_batches(dev, sub, t, b):
    """K1 in both modes at the serving slice over one query, a partial query
    tile and the serving batch (448 = 14 tiles of 32; 1 and 45 leave rows of
    the last tile past the batch)."""
    o = _operands(dev, 16384, 768, b, 128, seed=3)
    args = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    kv, ki = scorer.block_topt_int8_coarse(*args, t=t, sub=sub)
    pv, pi = scorer.block_topt_int8_coarse_plain(*args, t=t, sub=sub)
    assert _same(kv, pv) and _same(ki, pi)


@pytest.mark.parametrize("sub, t, w", [(512, 4, 128), (512, 1, 128), (256, 2, 128),
                                       (512, 4, 256)])
def test_fused_scan_kernel(dev, sub, t, w):
    """w=256 (2048 bloom bits, the server default) takes 16 keyword
    operand chunks beside the queries' six, and a thread reads its bloom
    words of a row in two batches of eight."""
    o = _operands(dev, 8192, 768, 448, w, seed=1)
    keys = ("emb8", "bloom", "q8", "kw_w8", "kw_b", "add_row", "scale_row", "q_scale", "q_bias")
    before = cuda.LAUNCHES["fused_scan"]
    kv, ki = scorer.block_topt_int8(*(o[k] for k in keys), t=t, sub=sub)
    pv, pi = scorer.block_topt_int8_plain(*(o[k] for k in keys), t=t, sub=sub)
    assert cuda.LAUNCHES["fused_scan"] == before + 1
    assert _same(kv, pv) and _same(ki, pi)
    assert scorer.int8_query_tile(sub, 768, w) == 32


@pytest.mark.parametrize("w", [128, 24])
@pytest.mark.parametrize("b", [1, 45, 448])
def test_fused_scan_batches(dev, w, b):
    """K4 at the rescue layout over one query, a partial query tile and 448
    queries, at 1024 bloom bits and at W = 24 (bloom words past W read as
    0; byte loads), with keyword weights light enough to leave the keyword
    term below its clamp."""
    o = _operands(dev, 8192, 768, b, w, seed=4, kw_nonzero=24)
    keys = ("emb8", "bloom", "q8", "kw_w8", "kw_b", "add_row", "scale_row", "q_scale", "q_bias")
    kv, ki = scorer.block_topt_int8(*(o[k] for k in keys), t=4, sub=512)
    pv, pi = scorer.block_topt_int8_plain(*(o[k] for k in keys), t=4, sub=512)
    assert _same(kv, pv) and _same(ki, pi)


# the kernel instantiations of csrc/int8_scan.cu, by a part of their names:
# K1 / K7a, K4, T5, T4 (each at query tiles 32, 16, 8), T2 (32, 16, 8) and K5
# (tiles 64 to 8)
INT8_KERNELS = {"CoarseArgs": 3, "FusedArgs": 3, "ProbeArgs": 3, "KeysArgs": 3,
                "int8_pipe_kernel": 3, "kw_scan_kernel": 4}


def test_int8_scan_sass_holds_igmma(dev):
    """Every kernel of csrc/int8_scan.cu runs its dots on the tensor cores
    (IGMMA, the SASS of an integer wgmma) and takes its resident operand (K5)
    or its rows (K1, K4, T5, T4, T2) by TMA (UTMALDG) in the built library."""
    cuda.library("int8_scan")
    lib = cuda.BUILD_DIR / "libint8_scan.so"
    counts = ptxas_report.sass_counts(lib)
    assert counts["IGMMA"] > 0 and counts["UTMALDG"] > 0, counts
    by_kernel = ptxas_report.sass_counts_by_function(lib)
    for part, instantiations in INT8_KERNELS.items():
        mine = {k: v for k, v in by_kernel.items() if part in k}
        assert len(mine) == instantiations, (part, sorted(mine))
        assert all(v["IGMMA"] > 0 and v["UTMALDG"] > 0 for v in mine.values()), (part, mine)


def test_scan_library_holds_only_the_probes(dev):
    """csrc/scan.cu is retired: no library of that name is built, and the
    int8_scan library exports T2's and T4's entry points."""
    assert "scan" not in cuda.SOURCES
    assert not (cuda.CSRC / "scan.cu").exists()
    lib = cuda.library("int8_scan")
    assert hasattr(lib, "omni_int8_pipe_topt") and hasattr(lib, "omni_int8_keys_emit")
    assert hasattr(lib, "omni_int8_pipe_tile")


# K5's default query tile at W bloom bytes and slices of sub: 64 where its
# keyword weights and [64][sub + 4] f32 scores fit
KW_TILE = {(16, 512): 64, (128, 512): 64, (256, 512): 32, (16, 1024): 32, (128, 1024): 32,
           (256, 1024): 32}


@pytest.mark.parametrize("sub", [512, 1024])
@pytest.mark.parametrize("w", [16, 128, 256])
@pytest.mark.parametrize("b", [1, 45, 448])
def test_kw_scan_kernel(dev, sub, w, b):
    """K5 over one query, a partial query tile and the serving batch, at
    narrow, serving (1024 bits) and the server's default (2048 bits) bloom
    widths, at both slices the engine's layouts give it; the keyword weights
    leave the keyword term below its clamp."""
    o = _operands(dev, 8192, 16, b, w, seed=2, kw_nonzero=24)
    keys = ("bloom", "kw_w8", "kw_b", "add_row")
    before = cuda.LAUNCHES["kw_scan"]
    kv, ki = scorer.block_topt_kw_only(*(o[k] for k in keys), t=4, sub=sub)
    pv, pi = scorer.block_topt_kw_only_plain(*(o[k] for k in keys), t=4, sub=sub)
    assert cuda.LAUNCHES["kw_scan"] == before + 1
    assert _same(kv, pv) and _same(ki, pi)
    assert scorer.int8_kw_query_tile(sub, w) == KW_TILE[(w, sub)]


@pytest.mark.parametrize("sub, t, w, qt", [(1024, 1, 128, 32), (256, 2, 128, 64),
                                           (128, 4, 24, 64), (64, 4, 128, 64), (32, 2, 16, 64),
                                           (1024, 4, 512, 16), (1024, 4, 1296, 8)])
def test_kw_scan_layouts(dev, sub, t, w, qt):
    """K5 in the two-reduce mode, at slices below 128 rows (several slices a
    128-row group), at W = 24 (bloom bytes past W read as 0), and at bloom
    widths whose keyword weights leave room for a 16- or an 8-query tile
    only."""
    o = _operands(dev, 8192, 16, 45, w, seed=12, kw_nonzero=24)
    keys = ("bloom", "kw_w8", "kw_b", "add_row")
    kv, ki = scorer.block_topt_kw_only(*(o[k] for k in keys), t=t, sub=sub)
    pv, pi = scorer.block_topt_kw_only_plain(*(o[k] for k in keys), t=t, sub=sub)
    assert _same(kv, pv) and _same(ki, pi)
    assert scorer.int8_kw_query_tile(sub, w) == qt


def _fp_inputs(dev, n, d, b, w, seed, exact):
    """K6 / T1 operands. ``exact``: scorer.fp_exact_operands, whose partial
    sums are exact in f32 whatever the order, while its f32 values are
    mostly not bf16's (the bitwise check pins the rounding of every
    operand). Rows 9 and 11 repeat row 4 (ties inside a slice). Otherwise
    unit rows and queries and keyword weights in [0, 0.1) at min(5%, 51) a
    query, one query's scaled so its keyword term clamps at 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        emb, q, kw = scorer.fp_exact_operands(g, n, d, b, w)
    else:
        # about 51 nonzero keyword weights a query, whatever the width: a
        # query's terms hash to as many bits in a wider bloom
        hit = torch.rand((b, 8 * w), generator=g, device=dev) < min(0.05, 51 / (8 * w))
        emb = torch.randn((n, d), generator=g, device=dev)
        emb /= emb.norm(dim=1, keepdim=True)
        q = torch.randn((b, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        kw = torch.where(hit, torch.rand((b, 8 * w), generator=g, device=dev) * 0.1,
                         torch.zeros((), device=dev))
        kw[min(2, b - 1)] *= 20.0
    o = _operands(dev, n, 16, b, w, seed=seed + 1)
    bloom, add_row = o["bloom"], o["add_row"]
    for r in (9, 11):  # exact score ties inside a slice
        emb[r], bloom[r], add_row[0, r] = emb[4], bloom[4], add_row[0, 4]
    return emb, bloom, q, kw, o["kw_b"], add_row


def _fp_rule(kv, pv, q, rows, kw, d, granule=0, ki=None, pi=None, cos_weight=COSINE_WEIGHT):
    """The parity rule's part (ii) (ops/scorer.py fp_order_bound): values
    within the bound; with indices, equal in every clear slice, and at least
    half the slices clear so the index check is not vacuous (chip_smoke.py
    holds the serving shape to the 75% the rule states)."""
    bound = scorer.fp_order_bound(pv, scorer.fp_cos_mass(q, rows), kw, d=d,
                                  cos_weight=cos_weight, granule=granule)
    got = scorer.fp_order_check(kv, pv, bound, ki, pi)
    assert got["within"], got
    if ki is not None:
        assert got["indices_equal_where_clear"] and got["clear_share"] >= 0.5, got
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub, t, d, w, b", [(512, 4, 768, 128, 45), (512, 1, 768, 128, 45),
                                             (256, 2, 100, 128, 45), (1024, 4, 768, 128, 45),
                                             (512, 4, 768, 32, 45), (512, 4, 256, 16, 1),
                                             (128, 4, 768, 24, 33), (512, 4, 768, 256, 45),
                                             (512, 4, 256, 272, 20)])
def test_fp_scan_kernel(dev, dtype, sub, t, d, w, b):
    """K6 on bf16 and f32 storage (bf16 rows with d % 8 == 4 take the
    producer's loads, not TMA), packed (t1 >= 3) and two-reduce (t1 = 2)
    extraction, bloom widths a multiple of 16 and not (W = 24), the server's
    default W = 256 (16-query tile) and W = 272 (bloom words past the first
    256 bytes load in a second block), one query: bitwise on
    exactly-summable inputs, within the order bound elsewhere."""
    n = 8192
    args = _fp_inputs(dev, n, d, b, w, seed=5, exact=True)
    args = (args[0].to(dtype), *args[1:])
    before = cuda.LAUNCHES["fp_scan"]
    kv, ki = scorer.block_topt(*args, t=t, sub=sub)
    pv, pi = scorer.block_topt_plain(*args, t=t, sub=sub)
    assert cuda.LAUNCHES["fp_scan"] == before + 1
    assert _same(kv, pv) and _same(ki, pi)

    emb, bloom, q, kw, kw_b, add_row = _fp_inputs(dev, n, d, b, w, seed=6, exact=False)
    args = (emb.to(dtype), bloom, q, kw, kw_b, add_row)
    kv, ki = scorer.block_topt(*args, t=t, sub=sub)
    pv, pi = scorer.block_topt_plain(*args, t=t, sub=sub)
    t1 = pv.shape[-1]
    _fp_rule(kv, pv, q, args[0], kw, d, sub if scorer._packed_mode(sub, t1) else 0, ki, pi)


# T1's query tile at d = 768, W = 128: cos and coskw keep 128 scores a query,
# full keeps c
T1_TILE = {"cos": {1024: 32, 2048: 32, 4096: 32}, "coskw": {1024: 32, 2048: 32, 4096: 32},
           "full": {1024: 16, 2048: 8, 4096: 8}}


@pytest.mark.parametrize("variant", list(profile_kernel.VARIANTS))
@pytest.mark.parametrize("c, b", [(1024, 45), (2048, 45), (4096, 128), (1024, 8)])
def test_profile_kernel_t1(dev, variant, c, b):
    """T1's three variants over bf16 rows at each of the tool's blocks, with
    batches that are not a multiple of the tile: bitwise on exactly-summable
    inputs, within the order bound elsewhere (T1-cos: the cosine itself)."""
    n, d, w = 8192, 768, 128
    args = _fp_inputs(dev, n, d, b, w, seed=7, exact=True)
    args = (args[0].to(torch.bfloat16), *args[1:])
    before = cuda.LAUNCHES["profile_kernel"]
    got = profile_kernel.profile_scan(variant, *args, c)
    want = profile_kernel.profile_scan_plain(variant, *args, c)
    assert cuda.LAUNCHES["profile_kernel"] == before + 1
    assert _same(got, want)
    assert profile_kernel.query_tile(c, variant) == T1_TILE[variant][c]

    emb, bloom, q, kw, kw_b, add_row = _fp_inputs(dev, n, d, b, w, seed=8, exact=False)
    args = (emb.to(torch.bfloat16), bloom, q, kw, kw_b, add_row)
    got = profile_kernel.profile_scan(variant, *args, c)
    want = profile_kernel.profile_scan_plain(variant, *args, c)
    cos_only = variant == "cos"
    _fp_rule(got.transpose(0, 1), want.transpose(0, 1), q, args[0], None if cos_only else kw,
             d, cos_weight=1.0 if cos_only else COSINE_WEIGHT)


def test_fp_scan_sass_holds_hgmma(dev):
    """K6 and T1's dots run on the tensor cores (HGMMA, the SASS of wgmma)
    and the bf16 rows arrive by TMA (UTMALDG) in the built library."""
    cuda.library("fp_scan")
    counts = ptxas_report.sass_counts(cuda.BUILD_DIR / "libfp_scan.so")
    assert counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, counts


@pytest.mark.parametrize("bits", [512, 1024])
@pytest.mark.parametrize("b", [1, 45, 448])
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


# T2's query tile at sub (d = 768): two [QT][max(sub, 128) + 4] f32 slots bind
T2_TILE = {64: 32, 256: 32, 384: 32, 512: 32, 1024: 16, 2048: 8}


@pytest.mark.parametrize("sub, t, groups", [(1024, 2, None), (512, 4, None), (512, 4, 3),
                                            (1024, 1, 5), (256, 2, 1), (384, 3, 2),
                                            (512, 40, None), (64, 3, 3), (2048, 2, None)])
@pytest.mark.parametrize("b", [8, 45, 128, 448])
def test_probe_pipe_t2(dev, sub, t, groups, b):
    """T2 at each query tile (32 at sub 512 and below, 16 at sub 1024, 8 at
    2048), packed and two-reduce extraction (t = 1; sub 384, not a power of
    two), t1 > 32 (the shared-memory rounds), two slices a group (sub 64),
    blocks of G groups where G does not divide the groups (the last block
    walks the rest), a single group a block (fill and drain only), ragged
    batches; three launches of each, every one bitwise against its plain
    version and against K1's kernel."""
    n = 12288 if sub == 384 else 8192
    o = _operands(dev, n, 768, b, 128, seed=10)
    args = (o["emb8"], o["q8"], o["add_row"], o["scale_row"], COSINE_WEIGHT * o["q_scale"],
            o["q_bias"])
    before = cuda.LAUNCHES["probe_pipe"]
    got = [probe_pipe.pipe_scan(*args, t, sub, sub, groups=groups) for _ in range(3)]
    assert cuda.LAUNCHES["probe_pipe"] == before + 3
    want_v, want_i = probe_pipe.pipe_scan_plain(*args, t, sub, sub)
    k1_v, k1_i = scorer.block_topt_int8_coarse(
        *(o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")),
        t=t, sub=sub, block=sub)
    for v, i in got:
        assert _same(v, want_v) and _same(i, want_i)
        assert _same(v.transpose(0, 1).reshape(k1_v.shape), k1_v)
        assert _same(i.transpose(0, 1).reshape(k1_i.shape), k1_i)
    assert probe_pipe.query_tile(768, sub) == T2_TILE[sub]


def test_probe_pipe_t2_rejects_what_k1s_tiles_do_not_take(dev):
    """The first CUDA T2 took sub % 64 == 0; the tensor-core kernel takes
    K1's slices, and the wrapper raises on the rest before any launch."""
    o = _operands(dev, 6144, 768, 8, 16)
    args = (o["emb8"], o["q8"], o["add_row"], o["scale_row"], o["q_scale"], o["q_bias"])
    before = cuda.LAUNCHES["probe_pipe"]
    with pytest.raises(ValueError, match="sub % 128 == 0 or 128 % sub == 0"):
        probe_pipe.pipe_scan(*args, 2, 192, 192)
    with pytest.raises(ValueError, match="groups >= 1"):
        probe_pipe.pipe_scan(*args, 2, 512, 512, groups=0)
    assert cuda.LAUNCHES["probe_pipe"] == before


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
                                        (128, 2, 2), (256, 1, 1), (1024, 512, 40),
                                        (2048, 2048, 3), (4096, 4096, 4)])
@pytest.mark.parametrize("b", [8, 45, 128, 448])
def test_probe_keys_emit_t4(dev, emit, c, sub, t1, b):
    """T4's three emits at the tool's layout, blocks of several slices and
    slices of two rows and of one (keys that are whole scores, several
    slices a 128-row group), t1 > 32 (the shared-memory rounds), each query
    tile K1's tiles take (32 up to sub 1024, 16 at 2048, 8 at 4096), ragged
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
    assert scorer.int8_query_tile(sub, 768) == {2048: 16, 4096: 8}.get(sub, 32)


@pytest.mark.parametrize("d", [768, 100, 1, 2048, 3072])
def test_dd_rows_kernel(dev, d):
    """K2 against its plain version, at one warp a pair (d <= 1024) and at
    two and four (2048, 3072), with a zero row (read by the empty slots), a
    zero query and a row whose products cancel pairwise."""
    g = torch.Generator(device=dev).manual_seed(3)
    raw = torch.randn((5000, d), generator=g, device=dev)
    q = torch.randn((37, d), generator=g, device=dev)
    rows = torch.randint(-1, 5000, (37, 32), generator=g, device=dev).to(torch.int32)
    raw[0] = 0.0
    q[1] = 0.0
    half = d // 2
    q[5, half:2 * half] = q[5, :half]
    raw[9, half:2 * half] = -raw[9, :half]
    rows[5, 3] = 9
    h, lo, s = exact_cos.exact_cos_rows(raw, rows, q)
    ph, plo, ps = exact_cos.exact_cos_rows_plain(raw, rows, q)
    assert _same(h, ph) and _same(lo, plo)
    nonzero = ps != 0
    assert bool(torch.equal(s[~nonzero], ps[~nonzero]))
    assert float(((s - ps).abs()[nonzero] / ps[nonzero]).max()) <= exact_cos.SABS_REL
    assert bool((h[1] == 0).all()) and bool((h[rows < 0] == 0).all())


@pytest.mark.parametrize("d", [1, 100, 768, 2048, 3072])
def test_dd_rows_gathered_entry(dev, d):
    """K2's gathered entry (``dd_rows(q_raw, c)``, the sharded path's)
    against its plain version, and bitwise the by-index entry on the same
    rows: one fold, two entries."""
    g = torch.Generator(device=dev).manual_seed(4)
    raw = torch.randn((3000, d), generator=g, device=dev)
    q = torch.randn((29, d), generator=g, device=dev)
    rows = torch.randint(-1, 3000, (29, 33), generator=g, device=dev).to(torch.int32)
    raw[0] = 0.0
    q[2] = 0.0
    c = raw[torch.where(rows < 0, 0, rows).long()]
    h, lo, s = exact_cos.dd_rows(q, c)
    ph, plo, ps = exact_cos.dd_sum_products(q[:, None, :], c)
    assert _same(h, ph) and _same(lo, plo)
    nonzero = ps != 0
    assert float(((s - ps).abs()[nonzero] / ps[nonzero]).max()) <= exact_cos.SABS_REL
    for x, y in zip((h, lo, s), exact_cos.exact_cos_rows(raw, rows, q)):
        assert _same(x, y)


def test_sharded_scorer_on_the_card(dev):
    """tools.sharded_check on the card: one shard bitwise the unsharded
    kernels, four shards of the card with top-m values, boundary and
    refine_select_dd bitwise."""
    from omni_recall_tpu_torch.parallel.mesh import shards_mesh
    from omni_recall_tpu_torch.tools import sharded_check

    inp = sharded_check.make_inputs(1 << 16, 256, 512, 64, dev)
    for shards in (1, 4):
        line = sharded_check.op_parity(shards_mesh(devices=[dev] * shards), inp["dev"], inp,
                                       m=64, t=8, sub=512)
        assert line["ok"], line


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
    # rows and scan bounds as the engine passes them: column slices of its
    # [B, m + 1] scan output, read with their row stride, one launch
    rows, vals = args[12], args[13]
    wide = [torch.cat([x, x[:, :1]], dim=1)[:, :m] for x in (rows, vals)]
    assert not wide[0].is_contiguous()
    strided = refine._refine_dispatch(*args[:12], *wide)
    assert cuda.LAUNCHES["refine"] == before + 2
    assert _same(strided, want)


@pytest.mark.parametrize("d, w", [(1024, 128), (16, 125), (1040, 256), (768, 4)])
def test_refine_kernel_widths(dev, d, w):
    """K3 where rows are wider than a lane's loads ahead (d > 768), the bloom
    wider than one 16-byte chunk a lane (W = 256) or read by bytes
    (W % 16 != 0), and d = 16 (no full 32-element block)."""
    args = _refine_inputs(dev, 4096, d, 24, 100, w, seed=d + w)
    assert _same(refine._refine_dispatch(*args), refine.refine_bounds_plain(*args))


def test_kernel_recency_is_torch_exp(dev):
    """K3's recency term (its expf) against recency_term over 2^20 created
    days: uniform in [0, 400) and on the serve corpus's grid at now = 365,
    and over ten years before a serving day (now = 1020, about 2026-10)
    and a month after it."""
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(11)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    for days, now in ((torch.rand((n,), generator=g, device=dev) * 400.0, 365.0),
                      (torch.linspace(0.0, 365.0, n, device=dev), 365.0),
                      (torch.rand((n,), generator=g, device=dev) * 3680.0 - 2630.0, 1020.0)):
        before = cuda.LAUNCHES["recency"]
        got = refine.kernel_recency(days, now)
        assert cuda.LAUNCHES["recency"] == before + 1
        assert _same(got, refine.recency_term(days, now, rows))


def test_kernel_recency_exp_is_torch_exp_on_every_argument(dev):
    """K3's expf alone against torch.exp on every f32 from -0 down to -inf
    (the recency term's arguments), in chunks of 2^27 bit patterns."""
    neg_zero, neg_inf, chunk = -(1 << 31), -(1 << 23), 1 << 27
    for start in range(neg_zero, neg_inf + 1, chunk):
        x = torch.arange(start, min(start + chunk, neg_inf + 1), dtype=torch.int32,
                         device=dev).view(torch.float32)
        assert _same(refine.kernel_recency(x), torch.exp(x)), start


@pytest.mark.parametrize("m", [16, 64, 128, 512])
@pytest.mark.parametrize("b", [16, 48, 448])
def test_probe_serve_t3(dev, b, m):
    """T3 over K3's candidates (8192-row planes, d = 768, 1024 bloom bits) at
    qg 16 (m <= 128) and qg 4 (m = 512): three launches, each bitwise
    against its plain version, and its block diagonal against K3's kernel."""
    args = _refine_inputs(dev, 8192, 768, b, m, 128, seed=b + m)
    ops, qg = probe_serve.k3_slab_operands(*args)
    before = cuda.LAUNCHES["probe_serve"]
    got = [refine.refine_slab_tile(*ops, qg) for _ in range(3)]
    assert cuda.LAUNCHES["probe_serve"] == before + 3
    want = refine.refine_slab_tile_plain(*ops, qg)
    assert want.shape == (b, qg * m) and qg == (4 if m == 512 else 16)
    for out in got:
        assert _same(out, want)
    assert _same(probe_serve.block_diagonal(got[0], m, qg), refine._refine_dispatch(*args))


def test_probe_serve_t3_rejects_what_the_kernel_does_not_take(dev):
    args = _refine_inputs(dev, 4096, 768, 16, 64, 128, seed=12)
    ops, qg = probe_serve.k3_slab_operands(*args)
    narrow = list(ops)
    narrow[0], narrow[1], narrow[8], narrow[9] = (x[:, :72].contiguous() for x in (
        ops[0], ops[1], ops[8], ops[9]))
    with pytest.raises(ValueError, match="d % 16"):
        refine.refine_slab_tile(*narrow, qg)
    wide = list(ops)
    wide[7] = torch.zeros((16, 2048), dtype=torch.int8, device=dev)  # kw_w8 must be [B, 8W]
    with pytest.raises(ValueError, match="kw_w8"):
        refine.refine_slab_tile(*wide, qg)
    with pytest.raises(ValueError, match="B % qg"):
        refine.refine_slab_tile(*ops, 32)
    with pytest.raises(ValueError, match="no kernel"):
        refine.refine_slab_tile(*(x.to("meta") for x in ops), qg)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    o = _operands(dev, 4096, 72, 8, 16)  # d % 16 != 0
    args = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    with pytest.raises(ValueError, match="d % 16"):
        scorer.block_topt_int8_coarse(*args, t=2, sub=512)
    o = _operands(dev, 4160, 64, 8, 16)  # N % 128 != 0
    args = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    with pytest.raises(ValueError, match="N % max"):
        scorer.block_topt_int8_coarse(*args, t=2, sub=64, block=64)
    # K5 takes int8_scan.cu's slices: sub % 128 == 0 or 128 % sub == 0, and
    # N % sub == 0
    o = _operands(dev, 4096, 16, 8, 16)
    args = [o[k] for k in ("bloom", "kw_w8", "kw_b", "add_row")]
    with pytest.raises(ValueError, match="sub % 128"):
        scorer.block_topt_kw_only(*args, t=4, sub=192)
    with pytest.raises(ValueError, match="N % max"):
        scorer.block_topt_kw_only(*args, t=4, sub=384)
    # T5 takes whole 16-byte groups of bloom bytes
    emb8 = torch.zeros((4096, 768), dtype=torch.int8, device=dev)
    q8 = torch.zeros((8, 768), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="W % 16"):
        profile_bloomT.bloom_scan(emb8, torch.zeros((4096, 24), dtype=torch.uint8, device=dev),
                                  q8, torch.zeros((8, 192), dtype=torch.int8, device=dev),
                                  torch.zeros((1, 4096), device=dev), False, 2048)
    with pytest.raises(ValueError, match="d % 4"):
        scorer.block_topt(torch.zeros((4096, 70), device=dev), o["bloom"],
                          torch.zeros((8, 70), device=dev), torch.zeros((8, 128), device=dev),
                          o["kw_b"], o["add_row"], t=4)
    raw = torch.zeros((10, 1 << 15), device=dev)
    with pytest.raises(ValueError, match="at most 16384"):
        exact_cos.exact_cos_rows(raw, torch.zeros((1, 1), dtype=torch.int32, device=dev),
                                 torch.zeros((1, 1 << 15), device=dev))
    args = list(_refine_inputs(dev, 4096, 768, 8, 16, 128, seed=4))
    args[12] = args[12].to(torch.int64)  # rows must be int32
    with pytest.raises(ValueError, match="rows"):
        refine._refine_dispatch(*args)


# ---- the compact store's shapes (W = 64: 512 bloom bits) and its device paths ----


@pytest.mark.parametrize("b", [1, 45, 896])
def test_scans_at_512_bloom_bits(dev, b):
    """K1 at the compact engine's layout (sub 1024, t 2) and batch (896),
    K4 at its rescue layout and K5 at its keyword layout, all over W = 64
    bloom bytes (the 512-bit compact index; the W % 64 == 0 load path at its
    edge): bitwise against their plain versions."""
    o = _operands(dev, 16384, 768, b, 64, seed=5, kw_nonzero=24)
    coarse = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    fused = [o[k] for k in ("emb8", "bloom", "q8", "kw_w8", "kw_b", "add_row", "scale_row",
                            "q_scale", "q_bias")]
    kw = [o[k] for k in ("bloom", "kw_w8", "kw_b", "add_row")]
    for kern, plain, args, t, sub in (
        (scorer.block_topt_int8_coarse, scorer.block_topt_int8_coarse_plain, coarse, 2, 1024),
        (scorer.block_topt_int8, scorer.block_topt_int8_plain, fused, 4, 512),
        (scorer.block_topt_kw_only, scorer.block_topt_kw_only_plain, kw, 4, 1024),
    ):
        kv, ki = kern(*args, t=t, sub=sub)
        pv, pi = plain(*args, t=t, sub=sub)
        assert _same(kv, pv) and _same(ki, pi), kern.__name__


@pytest.mark.parametrize("lo", [0, (1 << 24) + 77, (1 << 32) - (1 << 15)])
def test_rows_torch_on_the_card_equals_rows_np(dev, lo):
    from omni_recall_tpu_torch.index import compact

    n_clusters = 512
    center8, noise8 = compact.make_tables(n_clusters, 768)
    got = compact.rows_torch(lo, 1 << 15, torch.from_numpy(center8).to(dev),
                             torch.from_numpy(noise8).to(dev), n_clusters, noise8.shape[0])
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), torch.from_numpy(compact.rows_np(lo, lo + (1 << 15),
                                                                   center8, noise8)))


def test_upload_slabbed_through_pinned_staging(dev):
    """Slabs through the two pinned staging buffers, ticked at each slab,
    land bitwise; a copy-on-write memmap goes the same way."""
    import numpy as np

    from omni_recall_tpu_torch.index.device_index import upload_slabbed

    host = np.random.default_rng(1).integers(-127, 128, (10000, 768), dtype=np.int8)
    ticks = []
    out = upload_slabbed(host, dev, slab_bytes=768 * 999, tick=lambda: ticks.append(1))
    assert out.device.type == "cuda" and len(ticks) == 11
    assert torch.equal(out.cpu(), torch.from_numpy(host))


def test_restore_through_cuda_tensors_takes_the_fast_path(dev, tmp_path):
    """A snapshot of an int8 engine with the refine and raw planes on the
    card restores into a fresh engine on the card by the slab route; the
    uploaded planes equal the source's and the searches agree."""
    import random
    from datetime import datetime, timedelta, timezone

    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index import snapshot
    from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.models import hash_embedder
    from omni_recall_tpu_torch.search.engine import RecallEngine

    t0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
    rng = random.Random(3)
    words = ["".join(rng.choices("abcdefghij", k=5)) for _ in range(40)]
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt"))
    chunks = [ChunkRecord(id=f"d:{i:05d}", document_id="d", chunk_index=i,
                          content=" ".join(rng.choices(words, k=8)),
                          embedding=hash_embedder.embed_text(f"row {i}", 64),
                          created_at_utc=t0 + timedelta(minutes=i)) for i in range(3000)]
    store.upsert_chunks(chunks)
    opts = dict(backend="pallas", scan_dtype="int8", embedding_dim=64, capacity_block=1024,
                candidate_m=32, bloom_bits=512, recent_window=0, refine=True,
                device_exact_cos=True, direct_select=True)
    src = RecallEngine(store, options=EngineOptions(**opts))
    src.on_chunks_upserted(chunks, new=True)
    src.device_index.device_arrays()
    snapshot.save_snapshot(store, tmp_path, device_index=src.device_index)
    restored, aux = snapshot.load_snapshot_full(tmp_path)
    assert aux["meta"]["slabs"]["deriv"] == "device"
    eng = RecallEngine(restored, options=EngineOptions(**opts))
    assert snapshot.restore_engine(restored, eng, aux=aux) == "slabs"
    a, b = src.device_index.device_arrays(), eng.device_index.device_arrays()
    n = len(chunks)
    for name in ("emb", "scale", "err", "emb2", "scale2", "err2", "bloom", "created", "raw"):
        assert torch.equal(getattr(a, name)[:n], getattr(b, name)[:n]), name
    now = t0 + timedelta(days=3)
    reqs = [(" ".join(rng.choices(words, k=2)), hash_embedder.embed_text(f"q{i}", 64), 5)
            for i in range(32)]

    def dto(batch):
        return [[(h.chunk.id, round(h.score, 4)) for h in hits] for hits in batch]

    assert dto(eng.search_batch(reqs, now=now)) == dto(src.search_batch(reqs, now=now))


ENCODER_TEXTS = [f"topic c{k}x note r{i}" for k, i in zip(range(40, 100), range(900, 960))] + [
    "", "Ünïcödé wörds", "x " * 200, "the certificate compares bounds"]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_local_encoder_cuda_forward_matches_cpu(dev, compute_dtype):
    """The full-width encoder (the default config, seed 0) on the card
    against its CPU forward on the same token ids: f32 compute within 1e-5
    max abs; bf16 compute within twice the port's own bf16-vs-f32 gap on the
    CPU (a product's f32 bits differ between cuBLAS and the CPU, and one f32
    ulp before a bf16 rounding becomes a bf16 ulp)."""
    import dataclasses

    from omni_recall_tpu_torch.models import encoder

    cfg = dataclasses.replace(encoder.EncoderConfig(), compute_dtype=compute_dtype)
    state = encoder.init_params(0, cfg)
    ids = torch.from_numpy(encoder.tokenize_batch(ENCODER_TEXTS, cfg))[:, :32]
    cpu = encoder.Encoder.from_state(state, cfg, "cpu")(ids)
    got = encoder.Encoder.from_state(state, cfg, dev)(ids.to(dev)).cpu()
    assert torch.isfinite(got).all() and not got[len(ENCODER_TEXTS) - 4].any()
    if compute_dtype == "float32":
        tol = 1e-5
    else:
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        tol = 2 * float((encoder.Encoder.from_state(state, f32, "cpu")(ids) - cpu).abs().max())
    assert float((got - cpu).abs().max()) <= tol


def test_device_query_batch_on_cuda_is_certified(dev):
    """One batch of text-only queries through the device-query pipeline on
    the card (K1 and K2 launch), each DTO-identical to the port's float64
    oracle fed the query bits the engine's forward materialized."""
    import random
    from datetime import datetime, timedelta, timezone

    import numpy as np

    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.ingest.embedding import LocalEncoderEmbeddingClient
    from omni_recall_tpu_torch.models.encoder import EncoderConfig
    from omni_recall_tpu_torch.search.engine import RecallEngine

    d, n = 64, 4096
    cfg = EncoderConfig(vocab_size=2048, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                        max_len=32, out_dim=d)
    client = LocalEncoderEmbeddingClient(d, cfg=cfg)
    rng = random.Random(5)
    t0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt"))
    contents = [f"topic c{rng.randrange(n // 24)}x note r{i}" for i in range(n)]
    emb = client.embed_rows(contents)
    chunks = [ChunkRecord(id=f"d:{i:05d}", document_id="d", chunk_index=i, content=c,
                          embedding=emb[i], created_at_utc=t0 + timedelta(minutes=i))
              for i, c in enumerate(contents)]
    store.upsert_chunks(chunks)
    engine = RecallEngine(store, options=EngineOptions(
        backend="pallas", scan_dtype="int8", embedding_dim=d, capacity_block=1024,
        candidate_m=32, bloom_bits=512, recent_window=0, refine=True,
        device_exact_cos=True, direct_select=True))
    engine.on_chunks_upserted(chunks, new=True)
    engine.attach_device_embedder(client)
    forwards = []
    real = client.embed_device
    client.embed_device = lambda texts: forwards.append(real(texts)) or forwards[-1]
    reqs = [(f"{contents[i].split()[1]} r{i}", None, 5) for i in rng.sample(range(n), 64)]
    cuda.reset_launches()
    got = engine.search_batch(reqs, now=t0 + timedelta(days=4))
    assert cuda.LAUNCHES["coarse_scan"] > 0 and cuda.LAUNCHES["dd_rows"] > 0
    assert len(forwards) == 1 and forwards[0].is_cuda
    rows = forwards[0].cpu().numpy()
    oracle = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    for (q, _, k), hits, row in zip(reqs, got, rows):
        want = oracle.search(q, row.tolist(), k, now=t0 + timedelta(days=4))
        assert [(h.chunk.id, round(h.score, 4)) for h in hits] == [
            (h.chunk.id, round(h.score, 4)) for h in want], q
    assert np.isfinite(rows).all()


def test_encoder_train_step_on_cuda_matches_cpu(dev):
    """Three AdamW steps of the encoder (small config, f32 and bf16 compute)
    on the card against the port's CPU steps on the same batches: the first
    loss (the same weights) within 1e-5 (f32) and 2e-3 (bf16) relative,
    every step's within 1e-3 in f32 (the CPU fine-tune test's tolerance:
    AdamW turns last-bit differences of small gradients into whole steps)
    and 2e-3 in bf16 (the bf16 loss's)."""
    import dataclasses

    from omni_recall_tpu_torch.models import encoder, finetune

    base = encoder.EncoderConfig(vocab_size=4096, d_model=64, n_layers=2, n_heads=4,
                                 d_ff=128, max_len=32, out_dim=64)
    contents = [f"topic c{k % 40}x note r{k} " * (1 + k % 3) for k in range(200)]
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-3)):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        runs = {}
        for where in ("cpu", dev):
            losses = []
            finetune.inverse_cloze_finetune(contents, cfg, steps=3, seed=1, batch=32,
                                            device=where,
                                            on_step=lambda i, loss: losses.append(float(loss)))
            runs[str(where)] = losses
        rel = [abs(a - b) / abs(a) for a, b in zip(runs["cpu"], runs[str(dev)])]
        assert rel[0] <= tol and max(rel) <= max(tol, 1e-3), (dtype, runs)


def test_batcher_on_cuda_streams_equal_generate(dev):
    """The continuous batcher on the card (4 slots, 8-token chunks, a
    request joining mid-generation): each greedy stream bit for bit the
    card's own ``generate`` for its prompt at the same attend window."""
    import threading

    from omni_recall_tpu_torch.chat.serving import ContinuousBatcher
    from omni_recall_tpu_torch.models import decoder

    cfg = decoder.DecoderConfig(d_model=64, n_layers=2, n_heads=4, d_ff=128, max_len=256)
    w = decoder.serving_weights(decoder.init_params(3, cfg), cfg, dev)
    batcher = ContinuousBatcher(decoder, w, cfg, slots=4, chunk=8, prompt_buckets=(64,))
    prompts = [decoder.encode_text(f"prompt {i} " * (1 + i)) for i in range(6)]
    results = [None] * len(prompts)

    def run(i):
        results[i] = batcher.generate_sync(prompts[i], 0, 40)

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        while batcher.chunks_run < 2:
            threading.Event().wait(0.001)
        late = threading.Thread(target=run, args=(5,))
        late.start()
        for t in threads + [late]:
            t.join(timeout=300)
    finally:
        batcher.shutdown()
    for toks, got in zip(prompts, results):
        out = decoder.generate(w, decoder.pad_left_batch([toks], 64), cfg, 40)[0].tolist()
        want = []
        for t in out:
            if t in (decoder.EOS, decoder.PAD):
                break
            want.append(t)
        assert got == want


# ---- the eval campaigns' shapes: d 64 / 256 bloom bits (W 32) at a few
# hundred rows, and d 768 / 1024 bits at the eval corpora's sizes ----


@pytest.mark.parametrize("n, d, w, b", [(512, 64, 32, 1), (512, 64, 32, 45),
                                        (8192, 64, 32, 1), (512, 768, 128, 1),
                                        (8192, 768, 128, 3)])
def test_scans_at_eval_shapes(dev, n, d, w, b):
    """K1 at the layouts the engine gives a small index (sub 256 / 512 at
    t 8, sub 1024 at t 2), K4 at its rescue layouts and K5 at its keyword
    layouts, over the eval corpora's widths: bitwise against their plain
    versions. One query is the search service's batch."""
    o = _operands(dev, n, d, b, w, seed=n + d + b, kw_nonzero=12)
    coarse = [o[k] for k in ("emb8", "q8", "add_row", "scale_row", "q_scale", "q_bias")]
    fused = [o[k] for k in ("emb8", "bloom", "q8", "kw_w8", "kw_b", "add_row", "scale_row",
                            "q_scale", "q_bias")]
    kw = [o[k] for k in ("bloom", "kw_w8", "kw_b", "add_row")]
    layouts = [(scorer.block_topt_int8_coarse, scorer.block_topt_int8_coarse_plain, coarse, t,
                sub) for sub, t in ((256, 8), (512, 8), (128, 4), (1024, 2)) if sub <= n]
    layouts += [(scorer.block_topt_int8, scorer.block_topt_int8_plain, fused, t, sub)
                for sub, t in ((512, 8), (256, 8), (512, 4)) if sub <= n]
    layouts += [(scorer.block_topt_kw_only, scorer.block_topt_kw_only_plain, kw, t, sub)
                for sub, t in ((512, 8), (256, 8), (1024, 4)) if sub <= n]
    for kern, plain, args, t, sub in layouts:
        kv, ki = kern(*args, t=t, sub=sub)
        pv, pi = plain(*args, t=t, sub=sub)
        assert _same(kv, pv) and _same(ki, pi), (kern.__name__, sub, t)


@pytest.mark.parametrize("d, w, b, m", [(64, 32, 1, 16), (64, 32, 1, 64), (768, 128, 1, 16),
                                        (64, 32, 7, 128)])
def test_refine_and_dd_at_eval_shapes(dev, d, w, b, m):
    """K3 and K2 at the eval campaigns' widths and one-query batches."""
    args = _refine_inputs(dev, 512, d, b, m, w, seed=d + m)
    assert _same(refine._refine_dispatch(*args), refine.refine_bounds_plain(*args))
    raw = torch.randn((512, d), generator=torch.Generator(device=dev).manual_seed(d), device=dev)
    q, rows = args[8], args[12][:, :32].contiguous()
    h, lo, s = exact_cos.exact_cos_rows(raw, rows, q)
    ph, plo, ps = exact_cos.exact_cos_rows_plain(raw, rows, q)
    assert _same(h, ph) and _same(lo, plo)
    nonzero = ps != 0
    assert float(((s - ps).abs()[nonzero] / ps[nonzero]).max()) <= exact_cos.SABS_REL


EVAL_SHAPES = {
    # the JAX parity test's engine (tests/test_eval_parity.py)
    "jax_d64": dict(embedding_dim=64, bloom_bits=256, capacity_block=512, candidate_m=16),
    # the headline's options at the corpus's scale, d 768 and 1024 bits
    "headline_d768": dict(embedding_dim=768, bloom_bits=1024, capacity_block=512,
                          candidate_m=16, device_exact_cos=True, direct_select=True),
}


@pytest.mark.parametrize("shape", list(EVAL_SHAPES))
def test_eval_parity_campaign_on_the_card(dev, shape):
    """The 200-case recall@10 campaign of eval/corpus.py through the int8
    engine on the card: DTO-identical to the float64 oracle, through K1 and
    K3 (and K2 with the device-exact cosine)."""
    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.eval.corpus import parity_campaign

    opts = EVAL_SHAPES[shape]
    cuda.reset_launches()
    report = parity_campaign(EngineOptions(backend="pallas", scan_dtype="int8", recent_window=0,
                                           **opts), device="cuda", dim=opts["embedding_dim"])
    assert report["cases"] >= 200
    assert not report["mismatches"], report["mismatches"][:1]
    assert report["hit_rate"] >= 0.8
    launched = {k for k, v in cuda.LAUNCHES.items() if v}
    want = {"coarse_scan", "refine"} | ({"dd_rows"} if opts.get("device_exact_cos") else set())
    assert want <= launched, cuda.LAUNCHES
