"""T5 (omni_recall_tpu_torch/tools/profile_bloomT.py) against the tool's own
kernel body (tools/profile_bloomT.py, ``kernel`` inside ``variant``) run in
interpret mode on the CPU.

The tool builds 2^20-row arrays and runs its sweep when imported, so the body
is read from its source with ``ast`` and launched here through
``pl.pallas_call(..., interpret=True)`` with the tool's BlockSpecs. Inputs
are made with numpy from a seed and fed to both; on the CPU the port's
wrapper takes its plain version. Its int dots are exact, so everything is
held bit for bit: the port against the tool, and the row layout against the
transposed one.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from omni_recall_tpu_torch.tools import profile_bloomT as t5

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D, B, C = 4096, 768, 16, 2048
LAYOUTS = {"row": False, "transposed": True}


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions run thousands of small tensor operations; with
    several test workers sharing the machine's cores, an intra-op thread
    pool stalls on every one of them, so these tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _tool_body(transposed: bool):
    path = ROOT / "tools" / "profile_bloomT.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    variant = next(node for node in tree.body
                   if isinstance(node, ast.FunctionDef) and node.name == "variant")
    body = next(node for node in variant.body
                if isinstance(node, ast.FunctionDef) and node.name == "kernel")
    ns = {"jax": jax, "jnp": jnp, "transposed": transposed, "c": C}
    exec(compile(ast.Module(body=[body], type_ignores=[]), str(path), "exec"), ns)
    return ns["kernel"]


def _tool(transposed, emb8, bloom, q8, kw8, add):
    """The tool's body as its ``variant`` launches it (memory spaces
    omitted), in interpret mode."""
    bits = kw8.shape[1]
    w = bits // 8
    bspec = (pl.BlockSpec((w, C), lambda i: (0, i)) if transposed
             else pl.BlockSpec((C, w), lambda i: (i, 0)))
    kern = pl.pallas_call(
        _tool_body(transposed), grid=(N // C,),
        in_specs=[pl.BlockSpec((C, D), lambda i: (i, 0)), bspec,
                  pl.BlockSpec((B, D), lambda i: (0, 0)),
                  pl.BlockSpec((B, bits), lambda i: (0, 0)),
                  pl.BlockSpec((1, C), lambda i: (0, i))],
        out_specs=pl.BlockSpec((1, B, C // 512), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((N // C, B, C // 512), jnp.float32),
        interpret=True,
    )
    return np.asarray(kern(*map(jnp.asarray, (emb8, bloom, q8, kw8, add))))


def _port(transposed, *arrs):
    return t5.bloom_scan(*(torch.from_numpy(np.ascontiguousarray(x)) for x in arrs),
                         transposed, C).numpy()


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


def _operands(seed: int, bits: int):
    """The tool's value ranges, with a random recency term (the tool's is
    zero) so that the epilogue's last addition shows."""
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(-127, 127, (N, D), dtype=np.int8)
    q8 = rng.integers(-127, 127, (B, D), dtype=np.int8)
    kw8 = rng.integers(0, 2, (B, bits), dtype=np.int8)
    add = (rng.random((1, N)) * 0.1).astype(np.float32)
    bloom = rng.integers(0, 256, (N, bits // 8), dtype=np.uint8)
    return emb8, bloom, q8, kw8, add


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("bits", [512, 1024])
def test_t5_matches_the_tool_bitwise(bits, layout):
    emb8, bloom, q8, kw8, add = _operands(30 + bits, bits)
    transposed = LAYOUTS[layout]
    bloom = np.ascontiguousarray(bloom.T) if transposed else bloom
    want = _tool(transposed, emb8, bloom, q8, kw8, add)
    got = _port(transposed, emb8, bloom, q8, kw8, add)
    assert want.shape == (N // C, B, C // 512)
    assert _bits_equal(want, got)


@pytest.mark.parametrize("bits", [512, 1024])
def test_t5_row_and_transposed_layouts_agree_bitwise(bits):
    emb8, bloom, q8, kw8, add = _operands(40 + bits, bits)
    row = _port(False, emb8, bloom, q8, kw8, add)
    cols = _port(True, emb8, bloom.T, q8, kw8, add)
    assert _bits_equal(row, cols)
    assert np.isfinite(row).all()


def test_t5_slice_maxima_hold_against_float64():
    """Each value lies within 2 ulp of its slice's float64 maximum (the
    exact dots, the unrounded constants: the f32 epilogue's roundings)."""
    bits = 1024
    emb8, bloom, q8, kw8, add = _operands(50, bits)
    got = _port(False, emb8, bloom, q8, kw8, add)  # [N/C, B, C/512]
    bb = np.concatenate([(bloom.astype(np.int64) >> s) & 1 for s in range(8)], axis=1)
    exact = (0.7e-4 * (q8.astype(np.int64) @ emb8.astype(np.int64).T)
             + (0.2 / 127) * (kw8.astype(np.int64) @ bb.T) + add.astype(np.float64))
    want = exact.reshape(B, N // 512, 512).max(axis=2).reshape(B, N // C, C // 512)
    want = want.transpose(1, 0, 2)
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want).astype(np.float32)))


def test_t5_wrapper_rejects_blocks_it_does_not_take():
    arrs = [torch.from_numpy(x) for x in _operands(60, 512)]
    with pytest.raises(ValueError, match="c % 512"):
        t5.bloom_scan(*arrs, False, 1000)
    with pytest.raises(ValueError, match="N % c"):
        t5.bloom_scan(*arrs, False, 1536)


def test_t5_main_runs_the_tool_sweep_on_the_cpu(capsys):
    records = t5.main(n=4096, device="cpu", runs=1)
    lines = capsys.readouterr().out.splitlines()
    tool_lines = [ln for ln in lines if " qps" in ln and ln.startswith("B=")]
    assert len(tool_lines) == len(records) == len(t5.CONFIGS)
    assert tool_lines[0].startswith("B=512 bits=512 T=True c=2048: ")
    assert lines[-1].startswith('{"tool": "profile_bloomT", "device": "cpu"')
    assert all(r["launches"] == 0 and r["ms"] > 0 for r in records)


def test_t5_main_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t5.main()
