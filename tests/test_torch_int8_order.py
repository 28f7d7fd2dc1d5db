"""The keyword operand order of K4, K5 and T5 on the tensor cores
(csrc/int8_scan.cu), and K1's extraction in registers (csrc/int8_coarse.cu).

The card's K4, K5 and T5 build the keyword dot's A operand in registers from
32-bit bloom words, and the wrappers permute the keyword weights' columns to
match (``ops/scorer.py int8_kw_columns``). Here, on the CPU: the order is a
permutation of the JAX bit columns with zero columns only past W; K4's and
K5's plain versions over operands permuted that way are bit for bit the
interpret-mode Pallas kernels; and a numpy emulation of the kernels' thread
-> (row, k) fragment map, with the PTX register layout of an int8 wgmma A
operand, recovers the JAX bit matrix in that order from a row-major bloom
[N, W] (K4, K5, T5) and from T5's transposed bloom [W, N], which the kernel
first stages into rows in shared memory (a 4 x 4 byte transpose by
``__byte_perm``). And a numpy emulation of K1's extraction (which thread
holds which query and row of the wgmma accumulators, its running top-T, the
quad's shuffle merge, the decoded writes) against the max-and-mask rounds of
``_extract_topt`` in both modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.ops import pallas_scorer as jps
from omni_recall_tpu_torch.ops import scorer as tps

N, D, B = 4096, 64, 16


def _wp(w: int) -> int:
    return -(-w // 16) * 16


@pytest.mark.parametrize("w", [1, 8, 16, 24, 128, 256, 272])
def test_int8_kw_columns_is_a_permutation(w):
    """Every JAX bit column appears exactly once; the zero column 8W fills
    the 8(W' - W) kernel columns of bytes past W, and only those."""
    cols = tps.int8_kw_columns(w).numpy()
    wp = _wp(w)
    assert cols.shape == (8 * wp,)
    real = cols[cols < 8 * w]
    assert np.array_equal(np.sort(real), np.arange(8 * w))
    assert (cols == 8 * w).sum() == 8 * (wp - w)
    assert cols.max() <= 8 * w
    # a zero column stands where the kernel reads a byte past W
    kcol = np.arange(8 * wp)
    c = kcol % 32
    byte = (c % 16) // 4 * (wp // 4) + 4 * (kcol // 128) + c % 4
    assert np.array_equal(cols == 8 * w, byte >= w)
    op = tps.int8_kw_operand(torch.ones((3, 8 * w), dtype=torch.int8), w)
    assert op.shape == (3, 8 * wp) and op.dtype == torch.int8
    assert torch.equal(op.sum(dim=1), torch.full((3,), 8 * w))


def _operands(seed: int, w: int):
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(-127, 128, size=(N, D), dtype=np.int8)
    q8 = rng.integers(-127, 128, size=(B, D), dtype=np.int8)
    bloom = rng.integers(0, 256, size=(N, w), dtype=np.uint8)
    kw_w8 = np.where(rng.random((B, 8 * w)) < 0.1,
                     rng.integers(0, 128, size=(B, 8 * w)), 0).astype(np.int8)
    kw_b = (rng.random((B, 1)) * 0.05).astype(np.float32)
    add_row = (rng.random((1, N)) * 0.1).astype(np.float32)
    add_row[0, rng.random(N) < 0.1] = np.float32(-1e30)
    scale_row = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    q_scale = (rng.random((B, 1)) * 0.01 + 1e-3).astype(np.float32)
    q_bias = (rng.random((B, 1)) * 0.01).astype(np.float32)
    return (emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, q_scale, q_bias)


def _permute_bloom_bits(monkeypatch, w: int) -> None:
    """The plain versions' bit matrix, permuted as the kernels' operand is:
    columns in int8_kw_columns order, the zero column for bytes past W."""
    cols = tps.int8_kw_columns(w)
    bloom_bits = tps._bloom_bits

    def permuted_bits(bloom):
        bits = bloom_bits(bloom)
        return torch.cat([bits, bits.new_zeros((bits.shape[0], 1))], dim=1)[:, cols]

    monkeypatch.setattr(tps, "_bloom_bits", permuted_bits)


@pytest.mark.parametrize("w", [16, 24])
@pytest.mark.parametrize("t", [4, 1])
def test_permuted_plain_k4_matches_pallas(monkeypatch, w, t):
    """K4's plain version with the keyword weights in int8_kw_columns order
    and the bit matrix permuted the same way (zero columns past W) gives
    the interpret-mode Pallas kernel's output, bit for bit, in both
    extraction modes."""
    ops = _operands(w + t, w)
    jv, ji = jps.block_topt_int8(*map(jnp.asarray, ops), t=t, sub=256, interpret=True)

    _permute_bloom_bits(monkeypatch, w)
    tops = [torch.from_numpy(x) for x in ops]
    tops[3] = tps.int8_kw_operand(tops[3], w)
    tv, ti = tps.block_topt_int8_plain(*tops, t=t, sub=256)
    assert np.array_equal(np.asarray(jv).view(np.int32), tv.numpy().view(np.int32))
    assert np.array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("w", [16, 24, 128])
@pytest.mark.parametrize("t", [4, 1])
@pytest.mark.parametrize("sub", [512, 1024])
def test_permuted_plain_k5_matches_pallas(monkeypatch, w, t, sub):
    """K5's plain version with the keyword weights in int8_kw_columns order
    and the bit matrix permuted the same way (zero columns past W) gives the
    interpret-mode Pallas kernel's output, bit for bit, in both extraction
    modes, at the keyword scan's slices (its block is 1024 rows below
    W = 128, 2048 from there)."""
    ops = _operands(w + t + sub, w)
    bloom, kw_w8, kw_b, add_row = ops[1], ops[3], ops[4], ops[5]
    jv, ji = jps.block_topt_kw_only(*map(jnp.asarray, (bloom, kw_w8, kw_b, add_row)),
                                    t=t, sub=sub, interpret=True)

    _permute_bloom_bits(monkeypatch, w)
    kw8 = tps.int8_kw_operand(torch.from_numpy(kw_w8), w)
    tv, ti = tps.block_topt_kw_only_plain(
        torch.from_numpy(bloom), kw8, torch.from_numpy(kw_b), torch.from_numpy(add_row),
        t=t, sub=sub)
    assert tv.shape == (B, N // sub, min(t + 1, sub))
    assert np.array_equal(np.asarray(jv).view(np.int32), tv.numpy().view(np.int32))
    assert np.array_equal(np.asarray(ji), ti.numpy())


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte n is byte (nibble n of s) of y:x."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * n) & 7] << 8 * n for n in range(4))


def _u32(b: np.ndarray) -> int:
    return int(b.view(np.uint32)[0])


def _staged_rows(bloom_t: np.ndarray, w: int) -> np.ndarray:
    """T5's staging of one warpgroup's 64 rows of a transposed bloom
    [W, 64] into rows [64, W + 4] of shared memory, as the kernel does it
    (fetch_unit, store_unit): unit u is bytes 4 (u / 16) .. + 3 of rows
    4 (u % 16) .. + 3, four 32-bit loads along the rows, transposed by
    __byte_perm into one 32-bit word a row."""
    stride = w + 4
    staged = np.zeros((64, stride), np.uint8)
    for u in range(4 * w):
        jb, rb = u >> 4, u & 15
        x = [_u32(bloom_t[4 * jb + o, 4 * rb:4 * rb + 4]) for o in range(4)]
        t0, t1 = _byte_perm(x[0], x[1], 0x5140), _byte_perm(x[0], x[1], 0x7362)
        t2, t3 = _byte_perm(x[2], x[3], 0x5140), _byte_perm(x[2], x[3], 0x7362)
        rows = (_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))
        for i, y in enumerate(rows):
            staged[4 * rb + i, 4 * jb:4 * jb + 4] = np.array([y], np.uint32).view(np.uint8)
    return staged


def _kernel_a_operand(bloom: np.ndarray, w: int, transposed: bool = False) -> np.ndarray:
    """The A operand csrc/int8_scan.cu's K4 (K5, T5) hands wgmma for one tile
    of 128 rows, [128, 8W'] of 0/1, built as the kernel builds it from the
    bloom's rows [128, W] or, ``transposed`` (T5), its columns [W, 128].
    Consumer thread ctid (warp cw = ctid / 32, warpgroup g = cw / 4, lane,
    quad = lane % 4) owns rows r0 = 64 g + 16 (cw % 4) + lane / 4 and r0 + 8;
    its v-th word of a row is bytes quad·W'/4 + 4v + 0..3 (0 past W): one
    32-bit load of the row, or of the warpgroup's staged row (T5's
    transposed bloom, ``_staged_rows``); in k-step ks = 4v + p its
    registers are bit planes 2p of r0, 2p of r0 + 8, 2p + 1 of r0, 2p + 1 of
    r0 + 8. PTX's int8 A layout (m64nNk32): register 0 is row r0, columns
    4·quad + i (byte i), register 1 row r0 + 8, registers 2 and 3 the same
    rows at columns 16 + 4·quad + i."""
    wp = _wp(w)
    if transposed:  # T5: W % 16 == 0, so W' = W
        staged = [_staged_rows(bloom[:, 64 * g:64 * g + 64], w) for g in (0, 1)]

        def load(r, b0):  # a 32-bit read of the staged row
            return _u32(staged[r // 64][r % 64, b0:b0 + 4])
    else:
        padded = np.zeros((128, wp + 4), np.uint8)
        padded[:, :w] = bloom

        def load(r, b0):  # one little-endian 32-bit load
            return _u32(padded[r, b0:b0 + 4])
    a = np.zeros((128, 8 * wp), np.uint8)
    for ctid in range(256):
        cw, lane = ctid // 32, ctid % 32
        quad = lane % 4
        r0 = 64 * (cw // 4) + 16 * (cw % 4) + lane // 4
        for v in range(wp // 16):
            b0 = quad * (wp // 4) + 4 * v
            word = {r: load(r, b0) for r in (r0, r0 + 8)}
            for p in range(4):
                ks = 4 * v + p
                regs = [(word[r0] >> 2 * p) & 0x01010101, (word[r0 + 8] >> 2 * p) & 0x01010101,
                        (word[r0] >> 2 * p + 1) & 0x01010101,
                        (word[r0 + 8] >> 2 * p + 1) & 0x01010101]
                for reg, x in enumerate(regs):
                    row = r0 + 8 * (reg % 2)
                    col0 = 32 * ks + 16 * (reg // 2) + 4 * quad
                    for i in range(4):
                        a[row, col0 + i] = (x >> 8 * i) & 0xFF
    return a


@pytest.mark.parametrize("w", [16, 24, 128, 256])
def test_fragment_emulation_recovers_the_bit_matrix(w):
    """The emulated A operand's kernel column k is the JAX bit matrix's
    column int8_kw_columns[k] (0 for the zero column), for every row: the
    kernel's keyword dot against the wrapper's operand is the JAX dot."""
    bloom = np.random.default_rng(w).integers(0, 256, size=(128, w), dtype=np.uint8)
    a = _kernel_a_operand(bloom, w)
    bits = tps._bloom_bits(torch.from_numpy(bloom)).numpy()
    bits = np.concatenate([bits, np.zeros((128, 1), bits.dtype)], axis=1)
    cols = tps.int8_kw_columns(w).numpy()
    assert np.array_equal(a, bits[:, cols].astype(np.uint8))


@pytest.mark.parametrize("w", [16, 64, 128])
def test_fragment_emulation_recovers_the_bit_matrix_from_transposed_bloom(w):
    """T5's read of a transposed bloom [W, N] (each warpgroup's rows staged
    in shared memory by 4 x 4 byte transposes, then read as the row layout
    reads its rows) gives the same A operand as the row layout: the JAX bit
    matrix of the rows, in int8_kw_columns order."""
    bloom_t = np.random.default_rng(w + 1).integers(0, 256, size=(w, 128), dtype=np.uint8)
    a = _kernel_a_operand(bloom_t, w, transposed=True)
    assert np.array_equal(a, _kernel_a_operand(np.ascontiguousarray(bloom_t.T), w))
    bits = tps._bloom_bits(torch.from_numpy(np.ascontiguousarray(bloom_t.T))).numpy()
    bits = np.concatenate([bits, np.zeros((128, 1), bits.dtype)], axis=1)
    cols = tps.int8_kw_columns(w).numpy()
    assert np.array_equal(a, bits[:, cols].astype(np.uint8))


# ---- K1's extraction in registers (csrc/int8_coarse.cu) ----

K1_MAX_T1 = 9       # the largest t1 the kernel's lists take
NEG = np.float32(-1e30)


def _k1_slots(t1: int, packed: bool) -> int:
    """The list length (template T) the kernel launches for t1."""
    if packed:
        return 3 if t1 <= 3 else 5 if t1 <= 5 else 9
    return 2 if t1 <= 2 else 9


def _k1_threads(b: int):
    """K1's consumer threads that have queries: per query tile of 128, the
    warpgroups (64 queries each) with a query of the batch, their warps and
    lanes. Returns each thread's two queries (m and m + 8, m = 64 wg + 16
    warp + lane / 4 past the tile's first) and its quad (lane % 4), ordered
    so that lane ^ 1 and lane ^ 2 are the thread indices ^ 1 and ^ 2."""
    queries, quads = [], []
    for q0 in range(0, b, 128):
        for wg in range(2 if b - q0 > 64 else 1):
            for warp in range(4):
                for lane in range(32):
                    m = q0 + 64 * wg + 16 * warp + lane // 4
                    queries.append((m, m + 8))
                    quads.append(lane % 4)
    return np.array(queries), np.array(quads)


def _pair_before(x, row, v, r):
    return (x > v) | ((x == v) & (row < r))


def _shift_in(lists, c, cp, x):
    """Slot i takes x where x goes in at i, the slot above where it goes in
    above, else keeps its own (c[:, i]: x goes at or above slot i)."""
    out = lists.copy()
    for i in range(lists.shape[-1]):
        above = lists[..., i - 1] if i else x
        out[..., i] = np.where(c[..., i], np.where(cp[..., i], above, x), lists[..., i])
    return out


def _k1_insert(state, x, row, packed, in_order):
    """One entry into each list (``state``: keys, or values and rows,
    [threads, 2, T]), as the kernel's TopT::insert / push do."""
    if packed:
        k = state[0]
        new = k.copy()
        for i in range(k.shape[-1] - 1, 0, -1):
            new[..., i] = np.maximum(k[..., i], np.minimum(k[..., i - 1], x))
        new[..., 0] = np.maximum(k[..., 0], x)
        return (new,)
    v, r = state
    c = (x[..., None] > v) if in_order else _pair_before(x[..., None], row[..., None], v, r)
    cp = np.concatenate([np.zeros_like(c[..., :1]), c[..., :-1]], axis=-1)
    return (_shift_in(v, c, cp, x), _shift_in(r, c, cp, row))


def _k1_insert2(k, x, y):
    """TopT::insert2: the keys x, y into the lists at once, as the sorted
    pair (hi, lo) merged in: slot i the largest of k[i], min(k[i-1], hi)
    and min(k[i-2], lo)."""
    hi, lo = np.maximum(x, y), np.minimum(x, y)
    new = k.copy()
    for i in range(k.shape[-1] - 1, 1, -1):
        new[..., i] = np.maximum(k[..., i], np.maximum(np.minimum(k[..., i - 1], hi),
                                                       np.minimum(k[..., i - 2], lo)))
    new[..., 1] = np.maximum(k[..., 1], np.maximum(np.minimum(k[..., 0], hi), lo))
    new[..., 0] = np.maximum(k[..., 0], hi)
    return (new,)


def _k1_merge(state, lanes, packed):
    """The quad's shuffle round: each list takes in the list of thread
    ^ ``lanes`` (as it was before the round), entry by entry."""
    partner = np.arange(state[0].shape[0]) ^ lanes
    other = tuple(x[partner] for x in state)
    for i in range(state[0].shape[-1]):
        state = _k1_insert(state, other[0][..., i], None if packed else other[1][..., i],
                           packed, in_order=False)
    return state


def _k1_pair_entries(v, r, t1):
    """pair_entry: the two-reduce rounds' t1 entries from a merged list."""
    rstar = t1 - 1
    for i in range(t1 - 2, -1, -1):
        if v[i] <= NEG:
            rstar = i
    hit = min([int(r[i]) for i in range(rstar)] + ([int(r[rstar])] if v[rstar] == NEG else []),
              default=2**31 - 1)
    out = []
    for i in range(t1):
        if i == t1 - 1:
            out.append((v[0] if i == 0 else max(v[i], NEG), -2))
        elif i < rstar:
            out.append((v[i], r[i]))
        elif rstar == 0:
            out.append((v[0] if i == 0 else NEG, r[0]))
        else:
            out.append((NEG, hit))
    return out


def _emulate_k1(scores: np.ndarray, sub: int, t1: int):
    """csrc/int8_coarse.cu's extraction over f32 scores [B, N]: each
    thread folds its scores of each 128-row tile (rows 8 j + 2 quad + c, in
    the epilogue's order: j, then the query, then c; packed keys two at a
    time, c = 0 and 1) into its two lists; at
    a slice's last tile the quad merges (xor 1, then xor 2) and its lanes
    write entries r = quad, quad + 4, ... of their queries of the batch."""
    b, n = scores.shape
    packed = tps._packed_mode(sub, t1)
    slots = _k1_slots(t1, packed)
    lmask = sub - 1
    queries, quads = _k1_threads(b)
    valid = queries < b
    sc = np.concatenate([scores, np.zeros((queries.max() + 1 - b, n), np.float32)])
    keys = sc.view(np.int32)
    keys = keys ^ ((keys >> 31) & 0x7FFFFFFF)

    def fresh():
        shape = (len(quads), 2, slots)
        if packed:
            return (np.full(shape, np.iinfo(np.int32).min, np.int32),)
        return (np.full(shape, -np.inf, np.float32), np.full(shape, 2**31 - 1, np.int64))

    vals = np.full((b, n // sub, t1), np.nan, np.float32)
    idxs = np.full((b, n // sub, t1), -7, np.int32)
    state = fresh()
    for row0 in range(0, n, 128):
        for j in range(16):
            rows = [row0 + 8 * j + 2 * quads + c for c in range(2)]
            if packed:  # keys (kf | lmask) ^ e, e the row in its slice, two at a time
                x = [((keys[queries, r[:, None]] | lmask) ^ (r[:, None] & lmask)).astype(np.int32)
                     for r in rows]
                state = _k1_insert2(state[0], x[0], x[1])
            else:
                for r in rows:
                    state = _k1_insert(state, sc[queries, r[:, None]],
                                       np.broadcast_to(r[:, None], queries.shape), False, True)
        if (row0 + 128) % sub:
            continue
        state = _k1_merge(_k1_merge(state, 1, packed), 2, packed)
        for x in state:  # the four lanes of a quad hold the same lists
            assert (x.reshape(-1, 4, 2, slots) == x.reshape(-1, 4, 2, slots)[:, :1]).all()
        base, sl = row0 + 128 - sub, (row0 + 128) // sub - 1
        for th, h in zip(*np.nonzero(valid)):
            q = queries[th, h]
            if packed:
                ks = state[0][th, h]
                y = ks | np.int32(lmask)  # decode_up: the lane bits set to 1
                up = (y ^ ((y >> 31) & 0x7FFFFFFF)).view(np.float32)
                entries = [(up[r], -2 if r == t1 - 1 else lmask - (int(ks[r]) & lmask) + base)
                           for r in range(t1)]
            else:
                entries = _k1_pair_entries(state[0][th, h], state[1][th, h], t1)
            for r in range(quads[th], t1, 4):
                vals[q, sl, r], idxs[q, sl, r] = entries[r]
        state = fresh()
    return vals, idxs


def _k1_scores(rng, b: int, n: int, sub: int, packed: bool) -> np.ndarray:
    """f32 scores [B, N] with planted ties: values on a coarse grid (many
    equal scores, in one thread's rows and across the quad's), runs of
    adjacent floats (equal above the packed keys' row bits), negative
    scores, rows at -1e30 (removed rows), and slices with at most two live
    rows (the two-reduce rounds then take masked entries again)."""
    s = (rng.integers(-40, 60, size=(b, n)) / 64).astype(np.float32)
    near = rng.random((b, n)) < 0.2
    s[near] = (np.float32(0.625).view(np.int32) + rng.integers(0, 2 * sub, size=near.sum())
               ).astype(np.int32).view(np.float32)
    s[rng.random((b, n)) < 0.1] = NEG
    for sl in rng.choice(n // sub, size=max(1, n // sub // 3), replace=False):
        live = rng.integers(0, 3)
        part = s[:, sl * sub:(sl + 1) * sub]
        keep = rng.random(part.shape) < live / sub
        part[~keep] = NEG
    return s


K1_CASES = ([("packed", sub, t1) for sub in (128, 256, 512, 1024) for t1 in (3, 5, K1_MAX_T1)]
            + [("pair", sub, t1) for sub in (128, 256, 512, 1024) for t1 in (1, 2)]
            + [("pair", 384, 5), ("pair", 384, K1_MAX_T1), ("pair", 640, 3)])


@pytest.mark.parametrize("b", [1, 63, 65, 414])
@pytest.mark.parametrize("mode, sub, t1", K1_CASES)
def test_k1_register_extraction_matches_the_rounds(mode, sub, t1, b):
    """The emulated kernel's [B, slices, t1] is bit for bit the max-and-mask
    rounds of _extract_topt (ops/scorer.py's plain version of them) in the
    mode the JAX code picks: packed keys at a power-of-two sub and t1 >= 3,
    else the value/row two-reduce (sub 384 and 640 give it at t1 > 2)."""
    assert tps._packed_mode(sub, t1) == (mode == "packed")
    n = 2 * sub if sub >= 512 else 1024 if sub % 128 == 0 and 1024 % sub == 0 else 3 * sub
    rng = np.random.default_rng(sub * 131 + t1 * 7 + b)
    scores = _k1_scores(rng, b, n, sub, mode == "packed")
    kv, ki = _emulate_k1(scores, sub, t1)
    pv, pi = tps._extract_topt_plain(torch.from_numpy(scores), sub, t1)
    assert np.array_equal(kv.view(np.int32), pv.numpy().view(np.int32))
    assert np.array_equal(ki, pi.numpy())
