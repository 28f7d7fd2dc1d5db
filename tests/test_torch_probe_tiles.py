"""T2 and T4 on K1's tiles (csrc/int8_scan.cu), modelled on the CPU.

The card's T4 is ``int8_scan_kernel`` with ``KeysArgs`` and T2 is
``int8_pipe_kernel``; neither runs here. What they add to K1 is where they
write and when, and that is modelled here from the .cu and held against the
tools' own kernels (tools/probe_keys_emit.py, tools/probe_pipe.py) run in
interpret mode:

- T4's emit offsets: the kernel's grid (query tiles of QT, groups of
  max(sub, 128) rows, a block's consumer warps taking queries w, w + 8, ...,
  stopping at the batch end) places each query's packed keys of each slice
  at ``SliceMajor`` / ``BlockMajor`` offsets (topt_extract.cuh). The mirror
  writes every entry through those offsets into a flat buffer, checks that
  each entry is written exactly once, and holds the buffer bit for bit
  against ``kern_pair`` / ``kern_p3`` / ``kern_pf``.
- T2's slot schedule: two score slots, the consumers scoring group g into
  slot g % 2 while the extractor runs group g - 1, the last group drained
  after the loop, with the named barriers' arrivals counted as the kernel
  makes them. Held bit for bit against K1's plain version and the tool's
  pipelined kernel, at a single group a block and an odd number.

Inputs are made with numpy from a seed; the per-slice rounds are the plain
versions' (``ops/scorer.py``), which the card tests hold against the kernels.
"""

import ast
import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omni_recall_tpu_torch.ops import scorer
from omni_recall_tpu_torch.tools import probe_keys_emit as t4
from omni_recall_tpu_torch.tools import probe_pipe as t2

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D, B = 4096, 64, 20  # B is a multiple of no query tile (32, 16, 8)
TILE_ROWS = 128       # csrc/int8_scan.cu kTileRows
CONSUMER_WARPS = 8    # K1's two consumer warpgroups (T4 extracts with them)
EXTRACT_WARPS = 8     # T2's two extraction warpgroups
WAVE_BLOCKS = 132 * 8  # kWaveBlocks
MAX_GROUPS = 64       # kMaxGroups


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; with several
    test workers sharing the machine's cores, an intra-op thread pool stalls
    on every one of them, so these tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pick_groups(row_groups: int, q_tiles: int) -> int:
    """int8_scan.cu pick_groups."""
    g = 1
    while (g * 2 <= MAX_GROUPS and row_groups % (g * 2) == 0
           and (row_groups // (g * 2)) * q_tiles >= WAVE_BLOCKS):
        g *= 2
    return g


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


# ---------------------------------------------------------------- T4


@functools.cache
def _t4_tool(c: int, sub: int, t1: int):
    """The tool's three kernels (``make_kernels``), read with ``ast`` (importing
    the tool sets JAX's compilation cache), in interpret mode."""
    path = ROOT / "tools" / "probe_keys_emit.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fns = [node for node in tree.body if isinstance(node, ast.FunctionDef)
           and node.name in ("packed_keys", "extract_keys", "make_kernels")]
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id)
    ns = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"), ns)
    return dict(zip(t4.EMITS, ns["make_kernels"](N, D, B, c, sub, t1)))


def _t4_operands(seed: int):
    """Random bits as int8 rows and queries, every fifth row a repeat of the
    one before (ties that only the lane bits tell apart), random scales."""
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(0, 256, (N, D), dtype=np.uint8).view(np.int8)
    q8 = rng.integers(0, 256, (B, D), dtype=np.uint8).view(np.int8)
    scale = (rng.random((1, N)) * 1e-3 + 1e-5).astype(np.float32)
    twins = np.arange(0, N - 1, 5)
    emb8[twins + 1] = emb8[twins]
    scale[0, twins + 1] = scale[0, twins]
    qs = (rng.random((B, 1)) * 1e-2 + 1e-4).astype(np.float32)
    return emb8, q8, scale, qs


def _slice_major(qg, s, n_slices, t1, b, n_sub):
    return (qg * n_slices + s) * t1


def _block_major(qg, s, n_slices, t1, b, n_sub):
    return ((s // n_sub * b + qg) * n_sub + s % n_sub) * t1


def t4_kernel_mirror(keys: np.ndarray, n: int, b: int, c: int, sub: int, t1: int, emit: str,
                     qt: int):
    """Where int8_scan_kernel<QT, KeysArgs> writes: ``keys`` [B, N/sub, t1]
    are one query's packed keys of each slice, as a warp's rounds give them.
    Returns the emit's arrays, written entry by entry at the kernel's offsets
    (extract_emit: pair and P3 BlockMajor, PF SliceMajor), each entry checked
    to be written exactly once."""
    n_slices, n_sub = n // sub, c // sub
    rows = max(sub, TILE_ROWS)
    q_tiles, row_groups = -(-b // qt), n // rows
    groups = _pick_groups(row_groups, q_tiles)
    offset = _slice_major if emit == "pf" else _block_major
    size = b * n_slices * t1
    vals = np.full(size, np.nan, dtype=np.float32)
    out = np.zeros(size, dtype=np.int32)  # pair's idxs, or the keys
    written = np.zeros(size, dtype=np.int32)
    lmask = sub - 1
    for bx in range(q_tiles):                          # blockIdx.x: the query tile
        for by in range(row_groups // groups):         # blockIdx.y: G groups of rows
            for grp in range(groups):
                row0 = (by * groups + grp) * rows      # grow0
                for cw in range(CONSUMER_WARPS):
                    for ql in range(cw, qt, CONSUMER_WARPS):
                        qg = bx * qt + ql
                        if qg >= b:
                            break                      # warp-uniform, as in the kernel
                        for sl in range(rows // sub):
                            base = row0 + sl * sub
                            o = offset(qg, base // sub, n_slices, t1, b, n_sub)
                            for r in range(t1):
                                m = int(keys[qg, base // sub, r])
                                written[o + r] += 1
                                if emit == "pair":
                                    y = np.int32(m | lmask)
                                    y ^= (y >> 31) & 0x7FFFFFFF
                                    vals[o + r] = np.array(y, dtype=np.int32).view(np.float32)
                                    out[o + r] = -2 if r == t1 - 1 else (lmask - (m & lmask)) + base
                                else:
                                    out[o + r] = m
    assert (written == 1).all(), "an entry written twice or never"
    shape = (b, n // c * n_sub * t1) if emit == "pf" else (n // c, b, n_sub * t1)
    if emit == "pair":
        return vals.reshape(shape), out.reshape(shape)
    return (out.reshape(shape),)


@functools.cache
def _t4_case(c: int, sub: int, t1: int, emit: str):
    """One layout's packed keys [B, N/sub, t1] (the tool's scores, K1's
    packed-key rounds: what one warp's rounds give) and the tool's output."""
    arrs = _t4_operands(c + sub + t1)
    e, q, scale, qs = (torch.from_numpy(x) for x in arrs)
    keys = scorer._packed_keys_plain((scorer._int_dot(q, e) * qs) * scale, sub, t1).numpy()
    want = _t4_tool(c, sub, t1)[emit](*map(jnp.asarray, arrs))
    return keys, tuple(np.asarray(x) for x in (want if emit == "pair" else (want,)))


@pytest.mark.parametrize("qt", [32, 16, 8])
@pytest.mark.parametrize("emit", list(t4.EMITS))
@pytest.mark.parametrize("c, sub, t1", [(1024, 1024, 3), (1024, 256, 3), (2048, 512, 5),
                                        (256, 64, 2), (128, 2, 2)])
def test_t4_emit_offsets_match_the_tool(c, sub, t1, emit, qt):
    """Several blocks of the tool (N/c of them), several slices a block and
    groups of several slices (sub < 128), a ragged last query tile."""
    keys, want = _t4_case(c, sub, t1, emit)
    got = t4_kernel_mirror(keys, N, B, c, sub, t1, emit, qt)
    assert len(got) == len(want)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------- T2


def _t2_tool_module():
    spec = importlib.util.spec_from_file_location("probe_pipe_tool",
                                                  ROOT / "tools" / "probe_pipe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


T2_TOOL = _t2_tool_module()


def _t2_tool(emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, c):
    """The tool's pipelined pallas_call (memory spaces and compiler
    parameters omitted) in interpret mode: [N/c, B, (c/sub)(t+1)]."""
    t1, n_sub, nblocks = t + 1, c // sub, N // c
    last = nblocks - 1
    clamp = lambda i: jnp.minimum(i, last)  # noqa: E731
    prev = lambda i: (jnp.maximum(i - 1, 0), 0, 0)  # noqa: E731
    kern = pl.pallas_call(
        T2_TOOL._make_pipe_kernel(t1, c, sub), grid=(nblocks + 1,),
        in_specs=[pl.BlockSpec((c, D), lambda i: (clamp(i), 0)),
                  pl.BlockSpec((B, D), lambda i: (0, 0)),
                  pl.BlockSpec((1, c), lambda i: (0, clamp(i))),
                  pl.BlockSpec((1, c), lambda i: (0, clamp(i))),
                  pl.BlockSpec((B, 1), lambda i: (0, 0)),
                  pl.BlockSpec((B, 1), lambda i: (0, 0))],
        out_specs=(pl.BlockSpec((1, B, n_sub * t1), prev),
                   pl.BlockSpec((1, B, n_sub * t1), prev)),
        out_shape=(jax.ShapeDtypeStruct((nblocks, B, n_sub * t1), jnp.float32),
                   jax.ShapeDtypeStruct((nblocks, B, n_sub * t1), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((B, c), jnp.float32)] * 2,
        interpret=True,
    )
    vals, idxs = kern(*map(jnp.asarray, (emb8, q8, add_row, scale_row, q_scale, q_bias)))
    return np.asarray(vals), np.asarray(idxs)


def _t2_operands(seed: int):
    """K1's value ranges, the 0.7 weight folded into q_scale (as the tool
    passes it), random row scales, recency terms with tombstones and
    per-query biases, and repeated rows (ties within a slice)."""
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(-127, 128, (N, D), dtype=np.int8)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q8, q_scale, _ = scorer.quantize_queries_int8(torch.from_numpy(q))
    add_row = (rng.random((1, N)) * 0.1).astype(np.float32)
    add_row[0, rng.random(N) < 0.01] = -1e30
    scale_row = (rng.random((1, N)) * 1e-3 + 1e-4).astype(np.float32)
    twins = np.arange(0, N - 1, 97)
    emb8[twins + 1] = emb8[twins]
    add_row[0, twins + 1] = add_row[0, twins]
    scale_row[0, twins + 1] = scale_row[0, twins]
    q_bias = (rng.random((B, 1)) * 0.01).astype(np.float32)
    return emb8, q8.numpy(), add_row, scale_row, q_scale.numpy(), q_bias


class NamedBarrier:
    """A bar.arrive / bar.sync pair of int8_pipe_kernel's hand-over: each
    instance completes when the 256 consumer threads and the 128 extractor
    threads (one side arriving, the other waiting) have reached it."""

    def __init__(self):
        self.arrived = 0
        self.waited = 0

    def arrive(self):
        assert self.arrived == self.waited, "arrived again before the last was taken"
        self.arrived += 1

    def sync(self):
        assert self.arrived == self.waited + 1, "waits on a slot nobody handed over"
        self.waited += 1


def t2_slot_schedule(emb8, q8, add_row, scale_row, q_scale, q_bias, sub: int, t1: int,
                     qt: int, groups: int | None):
    """int8_pipe_kernel's schedule, one block at a time: step k, the consumers
    score group k into slot k % 2 (after the slot came back from group k - 2)
    while the extractor runs group k - 1's rounds from the other slot; step
    G drains the last group. Returns K1's contract [B, N/sub, t1] as written,
    each entry written exactly once, and every hand-over balanced."""
    n, b = emb8.shape[0], q8.shape[0]
    rows = max(sub, TILE_ROWS)
    q_tiles, row_groups = -(-b // qt), n // rows
    per_block = groups or _pick_groups(row_groups, q_tiles)
    n_slices = n // sub
    vals = torch.full((b, n_slices, t1), float("nan"))
    idxs = torch.zeros((b, n_slices, t1), dtype=torch.int32)
    written = torch.zeros((b, n_slices), dtype=torch.int32)
    for bx in range(q_tiles):
        qsl = slice(bx * qt, min(bx * qt + qt, b))     # queries past b: never extracted
        for by in range(-(-row_groups // per_block)):
            g_count = min(per_block, row_groups - by * per_block)
            full = [NamedBarrier(), NamedBarrier()]
            free = [NamedBarrier(), NamedBarrier()]
            slots = [None, None]
            for k in range(g_count + 1):
                if k < g_count:                        # consumers: score group k
                    if k >= 2:
                        free[k % 2].sync()
                    r0 = (by * per_block + k) * rows
                    slots[k % 2] = (k, r0, scorer._coarse_scores_plain(
                        emb8[r0:r0 + rows], q8[qsl], add_row[:, r0:r0 + rows],
                        scale_row[:, r0:r0 + rows], q_scale[qsl], q_bias[qsl]))
                    full[k % 2].arrive()
                if k >= 1:                             # extractor: group k - 1
                    g = k - 1
                    full[g % 2].sync()
                    got_g, r0, sc = slots[g % 2]
                    assert got_g == g
                    v, i = scorer._extract_topt_plain(sc, sub, t1)
                    i = torch.where(i == -2, i, i + r0)  # slice-local rows -> global
                    s0 = r0 // sub
                    for ew in range(EXTRACT_WARPS):  # warp ew: queries ew, ew + 8, ...
                        for ql in range(ew, qt, EXTRACT_WARPS):
                            qg = bx * qt + ql
                            if qg >= b:
                                break  # warp-uniform, as in the kernel
                            vals[qg, s0:s0 + rows // sub] = v[ql]
                            idxs[qg, s0:s0 + rows // sub] = i[ql]
                            written[qg, s0:s0 + rows // sub] += 1
                    if g + 2 < g_count:
                        free[g % 2].arrive()
            # no hand-over left pending when the block exits
            assert all(x.arrived == x.waited for x in full + free)
            assert sum(x.arrived for x in full) == g_count
            assert sum(x.arrived for x in free) == max(g_count - 2, 0)
    assert bool((written == 1).all())
    return vals, idxs


def _fold(q_scale):
    return np.float32(0.7) * q_scale


@functools.cache
def _t2_tool_cached(c_mul: int, sub: int, t: int):
    emb8, q8, add_row, scale_row, q_scale, q_bias = _t2_operands(40 + sub + t + c_mul)
    return _t2_tool(emb8, q8, add_row, scale_row, _fold(q_scale), q_bias, t, sub, c_mul * sub)


@pytest.mark.parametrize("groups", [1, 3, None])
@pytest.mark.parametrize("sub, t", [(512, 4), (256, 2), (512, 1), (64, 3)])
@pytest.mark.parametrize("c_mul", [1, 2])
def test_t2_slot_schedule_matches_k1_and_the_tool(c_mul, sub, t, groups):
    """A single group a block (no overlap: fill, then drain), three (odd;
    the last block walks what is left of N/R groups) and K1's choice; c =
    sub and 2 sub (the tool's layout only); packed keys and the two-reduce
    mode (t = 1); sub 64: two slices a 128-row group."""
    c = c_mul * sub
    emb8, q8, add_row, scale_row, q_scale, q_bias = _t2_operands(40 + sub + t + c_mul)
    tt = [torch.from_numpy(x) for x in (emb8, q8, add_row, scale_row, q_scale, q_bias)]
    folded = torch.from_numpy(_fold(q_scale))
    vals, idxs = t2_slot_schedule(*tt[:4], folded, tt[5], sub, t + 1, qt=32, groups=groups)
    want_v, want_i = scorer.block_topt_int8_coarse_plain(*tt, t=t, sub=sub, block=c)
    assert vals.view(torch.int32).equal(want_v.view(torch.int32)) and idxs.equal(want_i)
    tool_v, tool_i = _t2_tool_cached(c_mul, sub, t)
    got_v, got_i = t2._tool_layout(vals, idxs, c, sub)
    assert _bits_equal(got_v.contiguous().numpy(), tool_v)
    assert np.array_equal(got_i.contiguous().numpy(), tool_i)


@pytest.mark.parametrize("sub", [192, 320, 448])
def test_t2_kernel_rejects_slices_that_k1s_tiles_do_not_take(sub):
    """The first CUDA T2 took sub % 64 == 0; K1's tiles take sub % 128 == 0
    or 128 % sub == 0, and the wrapper raises on the rest (before any
    launch, so this runs without a card)."""
    with pytest.raises(ValueError, match="sub % 128 == 0 or 128 % sub == 0"):
        t2.check_kernel_shape(1 << 20, 768, sub)
    t2.check_kernel_shape(1 << 20, 768, 512)
    t2.check_kernel_shape(1 << 20, 768, 64)
    with pytest.raises(ValueError, match="groups >= 1"):
        t2.check_kernel_shape(1 << 20, 768, 512, groups=0)
    with pytest.raises(ValueError, match="d % 16"):
        t2.check_kernel_shape(1 << 20, 760, 512)
