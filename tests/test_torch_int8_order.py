"""K4's keyword operand order on the tensor cores (csrc/int8_scan.cu).

The card's K4 builds the keyword dot's A operand in registers from 32-bit
bloom loads, and the wrapper permutes the keyword weights' columns to match
(``ops/scorer.py int8_kw_columns``). Here, on the CPU: the order is a
permutation of the JAX bit columns with zero columns only past W; K4's plain
version over operands permuted that way is bit for bit the interpret-mode
Pallas kernel; and a numpy emulation of the kernel's thread -> (row, k)
fragment map, with the PTX register layout of an int8 wgmma A operand,
recovers the JAX bit matrix in that order.
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


@pytest.mark.parametrize("w", [16, 24])
@pytest.mark.parametrize("t", [4, 1])
def test_permuted_plain_k4_matches_pallas(monkeypatch, w, t):
    """K4's plain version with the keyword weights in int8_kw_columns order
    and the bit matrix permuted the same way (zero columns past W) gives
    the interpret-mode Pallas kernel's output, bit for bit, in both
    extraction modes."""
    ops = _operands(w + t, w)
    jv, ji = jps.block_topt_int8(*map(jnp.asarray, ops), t=t, sub=256, interpret=True)

    cols = tps.int8_kw_columns(w)
    bloom_bits = tps._bloom_bits

    def permuted_bits(bloom):
        bits = bloom_bits(bloom)
        return torch.cat([bits, bits.new_zeros((bits.shape[0], 1))], dim=1)[:, cols]

    monkeypatch.setattr(tps, "_bloom_bits", permuted_bits)
    tops = [torch.from_numpy(x) for x in ops]
    tops[3] = tps.int8_kw_operand(tops[3], w)
    tv, ti = tps.block_topt_int8_plain(*tops, t=t, sub=256)
    assert np.array_equal(np.asarray(jv).view(np.int32), tv.numpy().view(np.int32))
    assert np.array_equal(np.asarray(ji), ti.numpy())


def _kernel_a_operand(bloom: np.ndarray, w: int) -> np.ndarray:
    """The A operand csrc/int8_scan.cu's K4 hands wgmma for one tile of 128
    rows, [128, 8W'] of 0/1, built as the kernel builds it. Consumer thread
    ctid (warp cw = ctid / 32, warpgroup g = cw / 4, lane, quad = lane % 4)
    owns rows r0 = 64 g + 16 (cw % 4) + lane / 4 and r0 + 8; its v-th word of
    a row is bytes quad·W'/4 + 4v + 0..3 (0 past W); in k-step ks = 4v + p its
    registers are bit planes 2p of r0, 2p of r0 + 8, 2p + 1 of r0, 2p + 1 of
    r0 + 8. PTX's int8 A layout (m64nNk32): register 0 is row r0, columns
    4·quad + i (byte i), register 1 row r0 + 8, registers 2 and 3 the same
    rows at columns 16 + 4·quad + i."""
    wp = _wp(w)
    padded = np.zeros((128, wp + 4), np.uint32)
    padded[:, :w] = bloom
    a = np.zeros((128, 8 * wp), np.uint8)
    for ctid in range(256):
        cw, lane = ctid // 32, ctid % 32
        quad = lane % 4
        r0 = 64 * (cw // 4) + 16 * (cw % 4) + lane // 4
        for v in range(wp // 16):
            b0 = quad * (wp // 4) + 4 * v
            word = {r: sum(int(padded[r, b0 + i]) << (8 * i) for i in range(4))
                    for r in (r0, r0 + 8)}
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
