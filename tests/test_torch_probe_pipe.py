"""T2 (omni_recall_tpu_torch/tools/probe_pipe.py) against the tool's own
kernel (tools/probe_pipe.py, ``_make_pipe_kernel``) run in interpret mode on
the CPU, and against K1's plain version.

The kernel body is imported from the tool (importing it runs nothing) and
launched here through ``pl.pallas_call(..., interpret=True)`` with the
tool's grid, BlockSpecs and two VMEM score slots. Inputs are made with numpy
from a seed and fed to both; on the CPU the port's wrapper takes its plain
version. The int dots are exact and the f32 epilogue follows K1's
contractions, so everything is held bit for bit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omni_recall_tpu_torch.ops import scorer
from omni_recall_tpu_torch.tools import probe_pipe as t2

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D, B = 4096, 768, 16
CONFIGS = [(512, 512), (1024, 1024), (1024, 512)]  # the tool's (c, sub)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; with several
    test workers sharing the machine's cores, an intra-op thread pool stalls
    on every one of them, so these tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool_module():
    spec = importlib.util.spec_from_file_location("probe_pipe_tool",
                                                  ROOT / "tools" / "probe_pipe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool_module()


def _tool(emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, c):
    """The tool's pallas_call (its pipe_scan, memory spaces and compiler
    parameters omitted) in interpret mode."""
    t1, n_sub, nblocks = t + 1, c // sub, N // c
    last = nblocks - 1
    clamp = lambda i: jnp.minimum(i, last)  # noqa: E731
    prev = lambda i: (jnp.maximum(i - 1, 0), 0, 0)  # noqa: E731
    kern = pl.pallas_call(
        TOOL._make_pipe_kernel(t1, c, sub), grid=(nblocks + 1,),
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


def _operands(seed: int):
    """The tool's value ranges (int8 rows, normalized quantized queries,
    the 0.7 weight folded into q_scale), with random row scales, recency
    terms with tombstones and per-query biases (the tool's are constant or
    zero) so that every step of the epilogue shows, and repeated rows so
    that slices hold ties."""
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(-127, 128, (N, D), dtype=np.int8)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q8, q_scale, _ = scorer.quantize_queries_int8(torch.from_numpy(q))
    add_row = (rng.random((1, N)) * 0.1).astype(np.float32)
    add_row[0, rng.random(N) < 0.01] = -1e30
    scale_row = (rng.random((1, N)) * 1e-3 + 1e-4).astype(np.float32)
    twins = np.arange(0, N - 1, 97)  # row r + 1 repeats row r: equal scores
    emb8[twins + 1] = emb8[twins]
    add_row[0, twins + 1] = add_row[0, twins]
    scale_row[0, twins + 1] = scale_row[0, twins]
    q_bias = (rng.random((B, 1)) * 0.01).astype(np.float32)
    return emb8, q8.numpy(), add_row, scale_row, q_scale.numpy(), q_bias


def _fold(q_scale):
    return np.float32(0.7) * q_scale


def _port(emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, c):
    args = (torch.from_numpy(np.ascontiguousarray(x))
            for x in (emb8, q8, add_row, scale_row, q_scale, q_bias))
    vals, idxs = t2.pipe_scan(*args, t, sub, c)
    return vals.numpy(), idxs.numpy()


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("t", [4, 2])
@pytest.mark.parametrize("c, sub", CONFIGS)
def test_t2_matches_the_tool_bitwise(c, sub, t):
    emb8, q8, add_row, scale_row, q_scale, q_bias = _operands(10 + c + sub + t)
    args = (emb8, q8, add_row, scale_row, _fold(q_scale), q_bias, t, sub, c)
    want_v, want_i = _tool(*args)
    got_v, got_i = _port(*args)
    assert want_v.shape == (N // c, B, (c // sub) * (t + 1))
    assert _bits_equal(want_v, got_v) and np.array_equal(want_i, got_i)
    assert (got_i[..., t::t + 1] == -2).all()  # each slice's bound


@pytest.mark.parametrize("t", [4, 2, 1])
@pytest.mark.parametrize("c, sub", CONFIGS)
def test_t2_equals_k1s_plain_version(c, sub, t):
    """The tool's check: the pipelined scan decodes to K1's output on the
    same inputs (K1 folds the 0.7 weight itself). t = 1 takes the
    value/index two-reduce mode."""
    emb8, q8, add_row, scale_row, q_scale, q_bias = _operands(20 + c + sub + t)
    tt = [torch.from_numpy(x) for x in (emb8, q8, add_row, scale_row, q_scale, q_bias)]
    got_v, got_i = t2.pipe_scan(*tt[:4], torch.from_numpy(_fold(q_scale)), tt[5], t, sub, c)
    want_v, want_i = scorer.block_topt_int8_coarse_plain(*tt, t=t, sub=sub, block=c)
    assert got_v.transpose(0, 1).reshape(want_v.shape).view(torch.int32).equal(
        want_v.view(torch.int32))
    assert got_i.transpose(0, 1).reshape(want_i.shape).equal(want_i)


def test_t2_wrapper_rejects_layouts_it_does_not_take():
    arrs = [torch.from_numpy(x) for x in _operands(30)]
    with pytest.raises(ValueError, match="c % sub"):
        t2.pipe_scan(*arrs, 4, 512, 768)
    with pytest.raises(ValueError, match="N % c"):
        t2.pipe_scan(*arrs, 4, 512, 1536)
    with pytest.raises(ValueError, match="t \\+ 1 <= sub"):
        t2.pipe_scan(*arrs, 64, 64, 512)


def test_t2_main_runs_the_tool_sweep_on_the_cpu(capsys):
    records = t2.main(n=4096, device="cpu", runs=1)
    lines = capsys.readouterr().out.splitlines()
    tool_lines = [ln for ln in lines if ln.startswith("P  pipelined scan")]
    assert len(tool_lines) == len(records) == len(t2.CONFIGS)
    assert tool_lines[0].startswith("P  pipelined scan c=512 sub=512 t=4 ")
    assert tool_lines[0].endswith(" ms/batch")
    assert "vals equal: True idxs equal: True" in lines
    assert lines[-1].startswith('{"tool": "probe_pipe", "device": "cpu"')
    check = records[t2.CONFIGS.index(t2.CHECK)]
    assert check["k1_vals_equal"] and check["k1_idxs_equal"]
    assert all(r["launches"] == 0 and r["ms"] > 0 for r in records)


def test_t2_main_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t2.main()
