"""A numpy model of T3's tensor-core tiling (csrc/refine.cu
``refine_slab_kernel``): its shared-memory layout, the ldmatrix and
mma.sync.m16n8k32 fragment maps, the keyword operand's K order
(``slab_kw_pos``), the cp.async ring's chunks of K and the epilogue's stores,
run lane by lane over shared memory that starts as random bytes, as the
card's does. Every integer sum it produces (q1.c1, q1.c2, q2.c1, q2.c2 and
the keyword dot under JAX's column rule: column j of the bit matrix is bit
j // W of bloom byte j % W) is held exactly to numpy's, and every entry of
the [B, qg*m] tile is written once. The kernel's f32 combine is
refine_slab_tile_plain's, held bit for bit on the card (tests/test_torch_cuda.py
``test_probe_serve_t3``).

The constants and address expressions mirror the kernel's; change them
together.
"""

import numpy as np
import pytest

WARPS = 8                    # kSlabWarps: consumer warps, an n8 tile each
ROWS = 8 * WARPS             # kSlabRows
TERM_BYTES = 5 * 16 * 4      # kSlabTermBytes
MAX_SMEM = 232448            # kMaxSmem


def layout(d, w, qg, kp, kb):
    """slab_layout."""
    sd, nw = -(-d // 32), -(-w // 16)
    lo = dict(sd=sd, nw=nw, a_stride=32 * sd + 16, kw_stride=128 * nw + 16,
              c_stride=32 * kp + 16, b_stride=16 * (kb | 1), zero=TERM_BYTES)
    lo["a1"] = lo["zero"] + 16
    lo["a2"] = lo["a1"] + qg * lo["a_stride"]
    lo["akw"] = lo["a2"] + qg * lo["a_stride"]
    lo["ring"] = lo["akw"] + qg * lo["kw_stride"]
    lo["c2"] = ROWS * lo["c_stride"]
    lo["bl"] = 2 * ROWS * lo["c_stride"]
    lo["side"] = lo["bl"] + ROWS * lo["b_stride"]
    lo["stage"] = lo["side"] + 4 * 4 * ROWS
    return lo


def plan(d, w, qg):
    """omni_refine_slab's choice of (kp, kb, chunks, stages)."""
    sd, nw = -(-d // 32), -(-w // 16)
    chunks = 1
    while True:
        kp, kb = -(-sd // chunks), -(-nw // chunks)
        lo = layout(d, w, qg, kp, kb)
        for stages in (3, 2):
            if lo["ring"] + stages * lo["stage"] <= MAX_SMEM:
                return kp, kb, max(-(-sd // kp), -(-nw // kb)), stages
        if kp == 1 and kb == 1:
            return None
        chunks += 1


def kw_pos(x, b):
    """slab_kw_pos."""
    return 32 * (4 * (x >> 4) + (b >> 1)) + 16 * (b & 1) + 4 * ((x >> 2) & 3) + (x & 3)


LANE = np.arange(32)


def ldmatrix_x4(smem, addrs):
    """Four 8x8 b16 matrices, lane L naming row L % 8 of matrix L // 8:
    register i of lane T is bytes 4 (T % 4) .. + 3 of matrix i's row T // 4.
    -> int8 [32 lanes, 4 registers, 4 bytes]."""
    rows = smem[addrs[:, None] + np.arange(16)].view(np.int8)  # [32, 16]
    src = 8 * np.arange(4)[None, :] + (LANE // 4)[:, None]      # [32, 4]
    col = 4 * (LANE % 4)[:, None, None] + np.arange(4)          # [32, 1, 4]
    return rows[src[:, :, None], col]


def mma(c, a, b0, b1):
    """c [32, 4] += the m16n8k32 s8 product of fragments a [32, 4, 4] and
    b0, b1 [32, 4] (PTX ISA's fragment layouts)."""
    g, t = LANE // 4, LANE % 4
    k = 4 * t[:, None] + np.arange(4)
    am = np.zeros((16, 32), np.int64)
    am[g[:, None], k], am[g[:, None] + 8, k] = a[:, 0], a[:, 1]
    am[g[:, None], k + 16], am[g[:, None] + 8, k + 16] = a[:, 2], a[:, 3]
    bm = np.zeros((32, 8), np.int64)
    bm[k, g[:, None]], bm[k + 16, g[:, None]] = b0, b1
    cm = am @ bm
    c[:, 0] += cm[g, 2 * t]
    c[:, 1] += cm[g, 2 * t + 1]
    c[:, 2] += cm[g + 8, 2 * t]
    c[:, 3] += cm[g + 8, 2 * t + 1]


def bit_plane(word, bit):
    """(word >> bit) & 0x01010101 of 32-bit words given as bytes [32, 4]."""
    return ((word >> bit) & 1).astype(np.int8)


def stage_queries(smem, lo, q1, q2, kw_w8, q0, qg):
    """A tile's A operand as the block stages it: the int8 planes (the
    producers' first copies, zero past d to a whole k-step) and the keyword
    weights in slab_kw_pos's order (the consumers', zero past W)."""
    d, w = q1.shape[1], kw_w8.shape[1] // 8
    for g in range(qg):
        for plane, src in ((lo["a1"], q1), (lo["a2"], q2)):
            row = plane + g * lo["a_stride"]
            smem[row:row + d] = src[q0 + g].view(np.uint8)
            smem[row + d:row + 32 * lo["sd"]] = 0
        row = lo["akw"] + g * lo["kw_stride"]
        for p in range(32 * lo["nw"]):
            b_, x = p // (4 * lo["nw"]), 4 * (p % (4 * lo["nw"]))
            for e in range(4):
                v = kw_w8[q0 + g, b_ * w + x + e] if x + e < w else 0
                smem[row + kw_pos(x, b_) + e] = np.int8(v).view(np.uint8)


def run_kernel(q1, q2, kw_w8, c1, c2, bloom, qg, m, kp, kb, chunks, stages, per, rng):
    """Every block of the grid (a tile and a run of ``per`` of its row
    blocks), lane by lane: the five int32 sums [5, B, ct] at the entries the
    kernel stores, and how many times each was stored."""
    b, d = q1.shape
    w = bloom.shape[1]
    ct = qg * m
    lo = layout(d, w, qg, kp, kb)
    nrb = -(-ct // ROWS)
    sums = np.zeros((5, b, ct), np.int64)
    stores = np.zeros((b, ct), np.int64)
    mat, mrow = LANE >> 3, LANE & 7
    qrow = mrow + 8 * (mat & 1)
    live = qrow < qg
    a1 = np.where(live, lo["a1"] + qrow * lo["a_stride"] + 16 * (mat >> 1), lo["zero"])
    a2 = np.where(live, lo["a2"] + qrow * lo["a_stride"] + 16 * (mat >> 1), lo["zero"])
    akw = np.where(live, lo["akw"] + qrow * lo["kw_stride"] + 16 * (mat >> 1), lo["zero"])
    a_step = np.where(live, 32, 0)
    grp, quad = LANE >> 2, LANE & 3
    blocks = [(tile, bx) for tile in range(b // qg) for bx in range(-(-nrb // per))]
    for tile, bx in blocks:
        smem = rng.integers(0, 256, lo["ring"] + stages * lo["stage"], dtype=np.uint8)
        smem[lo["zero"]:lo["zero"] + 16] = 0
        stage_queries(smem, lo, q1, q2, kw_w8, tile * qg, qg)
        acc = np.zeros((WARPS, 4, 32, 4), np.int64)
        kwacc = np.zeros((WARPS, 2, 32, 4), np.int64)
        rb_first = bx * per
        for it in range(min(per, nrb - rb_first) * chunks):
            rb, c = rb_first + it // chunks, it % chunks
            st = lo["ring"] + (it % stages) * lo["stage"]
            # slab_issue
            j0, base = rb * ROWS, tile * ct
            plo = 32 * kp * c
            nbytes = max(0, min(32 * kp, d - plo))
            wlo = kb * c
            words = min(kb, lo["nw"] - wlo)
            for r in range(ROWS):
                if j0 + r >= ct:
                    break
                row = base + j0 + r
                s1 = st + r * lo["c_stride"]
                smem[s1:s1 + nbytes] = c1[row, plo:plo + nbytes].view(np.uint8)
                s2 = s1 + lo["c2"]
                smem[s2:s2 + nbytes] = c2[row, plo:plo + nbytes].view(np.uint8)
                nb = max(0, min(16 * words, w - 16 * wlo))
                sb = st + lo["bl"] + r * lo["b_stride"]
                smem[sb:sb + nb] = bloom[row, 16 * wlo:16 * wlo + nb]
            # the consumer warps' products
            s0, ns = kp * c, min(kp, lo["sd"] - kp * c)
            w0, nwc = kb * c, min(kb, lo["nw"] - kb * c)
            for warp in range(WARPS):
                if c == 0:
                    acc[warp] = 0
                    kwacc[warp] = 0
                b_off = ((mat >> 1) * lo["c2"] + (8 * warp + mrow) * lo["c_stride"]
                         + 16 * (mat & 1))
                for s in range(max(ns, 0)):
                    qa = ldmatrix_x4(smem, a1 + a_step * (s0 + s))
                    qb = ldmatrix_x4(smem, a2 + a_step * (s0 + s))
                    cb = ldmatrix_x4(smem, st + b_off + 32 * s)
                    mma(acc[warp, 0], qa, cb[:, 0], cb[:, 1])
                    mma(acc[warp, 1], qa, cb[:, 2], cb[:, 3])
                    mma(acc[warp, 2], qb, cb[:, 0], cb[:, 1])
                    mma(acc[warp, 3], qb, cb[:, 2], cb[:, 3])
                bl = st + lo["bl"] + (8 * warp + grp) * lo["b_stride"] + 4 * quad
                for u in range(max(nwc, 0)):
                    word = smem[bl[:, None] + 16 * u + np.arange(4)]  # [32, 4] bytes
                    for r in range(4):
                        kq = ldmatrix_x4(smem, akw + a_step * (4 * (w0 + u) + r))
                        mma(kwacc[warp, r & 1], kq, bit_plane(word, 2 * r),
                            bit_plane(word, 2 * r + 1))
                if c != chunks - 1:
                    continue
                for e in range(4):
                    g = grp + 8 * (e >> 1)
                    j = rb * ROWS + 8 * warp + 2 * quad + (e & 1)
                    ok = (g < qg) & (j < ct)
                    q = tile * qg + g[ok]
                    for v in range(4):
                        sums[v, q, j[ok]] = acc[warp, v][ok, e]
                    sums[4, q, j[ok]] = kwacc[warp, 0][ok, e] + kwacc[warp, 1][ok, e]
                    np.add.at(stores, (q, j[ok]), 1)
    return sums, stores


def expected(q1, q2, kw_w8, c1, c2, bloom, qg):
    """The five sums of every (query, slab row of its tile) pair, [5, B, ct]."""
    b, w = q1.shape[0], bloom.shape[1]
    tiles = b // qg
    bits = (bloom[:, None, :] >> np.arange(8)[None, :, None]) & 1  # [rows, bit, byte]
    bits = bits.reshape(bloom.shape[0], 8 * w)  # column j = bit j // W of byte j % W

    def tile_dot(a, cc):
        a = a.astype(np.int64).reshape(tiles, qg, -1)
        cc = cc.astype(np.int64).reshape(tiles, -1, a.shape[-1])
        return (a @ cc.transpose(0, 2, 1)).reshape(b, -1)

    return np.stack([tile_dot(q1, c1), tile_dot(q1, c2), tile_dot(q2, c1), tile_dot(q2, c2),
                     tile_dot(kw_w8, bits)])


# (B, m, d, W, forced (kp, kb) or None for the entry's plan, row blocks a block)
CASES = [
    (15, 129, 784, 5, None, 3),      # qg 15, ct 1935 (odd, not a multiple of 8), W % 16 != 0,
                                     # K in two chunks
    (32, 64, 768, 128, None, 5),     # qg 16 at the serving widths, a partial last block
    (4, 512, 784, 40, (7, 1), 16),   # qg 4, K cut into four chunks, the last without bloom
    (16, 8, 4096, 128, None, 1),     # a row too wide for the ring: the entry's own chunks
]


@pytest.mark.parametrize("b, m, d, w, forced, per", CASES)
def test_slab_tiling_sums_every_pair_once(b, m, d, w, forced, per):
    rng = np.random.default_rng(b * 1000 + m + d + w)
    qg = max(1, min(16, 2048 // m))
    q1 = rng.integers(-127, 128, (b, d), dtype=np.int8)
    q2 = rng.integers(-127, 128, (b, d), dtype=np.int8)
    kw_w8 = (rng.integers(0, 128, (b, 8 * w)) * (rng.random((b, 8 * w)) < 0.3)).astype(np.int8)
    c1 = rng.integers(-127, 128, (b * m, d), dtype=np.int8)
    c2 = rng.integers(-127, 128, (b * m, d), dtype=np.int8)
    bloom = rng.integers(0, 256, (b * m, w), dtype=np.uint8)
    kp, kb, chunks, stages = plan(d, w, qg)
    if forced:
        kp, kb = forced
        chunks = max(-(-(-(-d // 32)) // kp), -(-(-(-w // 16)) // kb))
        stages = 2
    if d == 4096:
        assert chunks > 1  # the case is there for the chunks
    sums, stores = run_kernel(q1, q2, kw_w8, c1, c2, bloom, qg, m, kp, kb, chunks, stages,
                              per, rng)
    assert (stores == 1).all()
    np.testing.assert_array_equal(sums, expected(q1, q2, kw_w8, c1, c2, bloom, qg))


def test_kw_positions_are_a_permutation():
    """slab_kw_pos maps the 8 bits of the bloom bytes of 16-byte words onto
    the keyword operand's K one to one."""
    for nw in (1, 3, 8):
        pos = sorted(kw_pos(x, b) for x in range(16 * nw) for b in range(8))
        assert pos == list(range(128 * nw))


@pytest.mark.parametrize("d, w, qg, want", [
    (768, 128, 16, (12, 4, 2, 3)),    # the tool's and the select shape: K in two chunks
    (1040, 125, 15, (17, 4, 2, 2)),
    (768, 128, 4, (24, 8, 1, 2)),     # qg 4: K whole, two stages
    (4096, 128, 16, (9, 1, 15, 2)),
])
def test_plan_fits_the_ring(d, w, qg, want):
    assert plan(d, w, qg) == want


def test_sass_counts_tell_imma_from_igmma():
    """tools/ptxas_report counts the warp-level int8 product (IMMA, T3's)
    apart from the warpgroup one (IGMMA)."""
    from omni_recall_tpu_torch.tools.ptxas_report import _count

    sass = ("/*0100*/ IMMA.16832.S8.S8 R24, R4.ROW, R8.COL, R24 ;\n"
            "/*0110*/ IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], R24 ;\n"
            "/*0120*/ IMMA.16832.S8.S8 R28, R4.ROW, R10.COL, R28 ;\n")
    assert _count(sass) == {"HGMMA": 0, "IGMMA": 1, "IMMA": 2, "UTMALDG": 0}
