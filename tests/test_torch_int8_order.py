"""The keyword operand order of K4, K5 and T5 on the tensor cores
(csrc/int8_scan.cu).

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
``__byte_perm``).
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
