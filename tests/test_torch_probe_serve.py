"""T3 (omni_recall_tpu_torch/ops/refine.py refine_slab_tile, the second kernel
of csrc/refine.cu) against the tool's own launch (tools/probe_serve.py
``k_body``, :202-233) in interpret mode on the CPU, against K3's plain
version on its block diagonal, and the tool's stage sweep
(omni_recall_tpu_torch/tools/probe_serve.py) at a small size.

The kernel body is the JAX package's ``_make_refine_kernel_full``, taken
from the tool's own import of ``omni_recall_tpu.ops.refine`` (importing the
tool runs nothing); ``k_body`` is local to the tool's ``main``, so its
``pl.pallas_call`` is rebuilt here with the tool's grid, BlockSpecs and
[B, qg*m] out shape (memory spaces omitted). Inputs are made with numpy
from a seed and fed to both; on the CPU the port's wrapper takes its plain
version. The int dots are exact and the f32 combine follows the contractions
XLA's CPU compiler makes in the interpret-mode body, so everything is held
bit for bit.
"""

import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from omni_recall_tpu_torch.index.device_index import device_quantize
from omni_recall_tpu_torch.ops import refine as tref
from omni_recall_tpu_torch.tools import probe_serve as t3

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL_PATH = ROOT / "tools" / "probe_serve.py"
# (B, m, d, bits): qg 16 at the tool's m; qg 4; another width; qg 2 with a
# tile of 2000 slab rows and 64 bloom bits; qg 15 with a tile of 1935 slab
# rows (not a multiple of 8), d = 16 x 49 (not a multiple of 32) and W = 5
CASES = [(32, 128, 768, 1024), (8, 512, 768, 512), (32, 64, 384, 256), (6, 1000, 256, 64),
         (15, 129, 784, 40)]


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
    spec = importlib.util.spec_from_file_location("probe_serve_tool", TOOL_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool_module()


def _tool(ops, qg: int, m: int):
    """The tool's T3 launch (its ``k_body`` without the carry) in interpret
    mode, under jit as the tool runs it."""
    q1, kw_w8, gbloom = ops[0], ops[7], ops[10]
    b, d = q1.shape
    ct = qg * m
    per_query = lambda k: (k, 0)  # noqa: E731
    per_row = lambda k: (0, k)  # noqa: E731
    call = pl.pallas_call(
        TOOL.refine._make_refine_kernel_full(qg, ct, m),
        grid=(b * m // ct,),
        in_specs=[pl.BlockSpec((qg, d), per_query), pl.BlockSpec((qg, d), per_query)]
        + [pl.BlockSpec((qg, 1), per_query)] * 5
        + [pl.BlockSpec((qg, kw_w8.shape[1]), per_query),
           pl.BlockSpec((ct, d), per_query), pl.BlockSpec((ct, d), per_query),
           pl.BlockSpec((ct, gbloom.shape[1]), per_query)]
        + [pl.BlockSpec((1, ct), per_row)] * 4,
        out_specs=pl.BlockSpec((qg, ct), per_query),
        out_shape=jax.ShapeDtypeStruct((b, ct), jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(call)(*map(jnp.asarray, ops)))


def _operands(b: int, m: int, d: int, bits: int, seed: int):
    """The tool's fifteen operands at realistic magnitudes: unit queries
    quantized by the port's residual quantizer, int8 slabs, row scales
    around 1/127/sqrt(d), residual scales and errors around the tool's,
    sparse small keyword weights with per-query biases up to 0.5 (so that
    the keyword cap of 1 binds for some pairs) and -1e30 add terms."""
    rng = np.random.default_rng(seed)
    w, rows = bits // 8, b * m
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q1, t1, q2, t2, eq2 = (x.numpy() for x in
                           tref.quantize_queries_int8_residual(torch.from_numpy(q)))
    s1 = (rng.uniform(0.5, 1.5, (1, rows)) / 127 / np.sqrt(d)).astype(np.float32)
    add = rng.uniform(0, 0.1, (1, rows)).astype(np.float32)
    add[0, rng.random(rows) < 0.05] = -1e30
    return [
        q1, q2, t1, t2, eq2,
        np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32),
        rng.uniform(0, 0.5, (b, 1)).astype(np.float32),
        ((rng.random((b, bits)) < 0.04) * rng.integers(1, 8, (b, bits))).astype(np.int8),
        rng.integers(-127, 128, (rows, d), dtype=np.int8),
        rng.integers(-127, 128, (rows, d), dtype=np.int8),
        rng.integers(0, 256, (rows, w), dtype=np.uint8),
        s1, (s1 * rng.uniform(4e-3, 9e-3, (1, rows))).astype(np.float32),
        rng.uniform(1e-5, 8e-5, (1, rows)).astype(np.float32), add,
    ]


def _port(ops, qg: int) -> np.ndarray:
    return tref.refine_slab_tile(*(torch.from_numpy(x) for x in ops), qg).numpy()


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("b, m, d, bits", CASES)
def test_t3_matches_the_tool_bitwise(b, m, d, bits):
    qg = tref.slab_tile_queries(m)
    ops = _operands(b, m, d, bits, seed=b + m + d + bits)
    want = _tool(ops, qg, m)
    got = _port(ops, qg)
    assert want.shape == (b, qg * m)
    assert _bits_equal(got, want)
    assert (got < -1e29).any() and np.isfinite(got).all()


def test_t3_combine_needs_the_tools_contractions(monkeypatch):
    """The same combine rounded after every operation (no fused
    multiply-add) misses the tool's output on some entries, so the test
    above checks the order and the contractions, not only the dots."""
    b, m, d, bits = CASES[0]
    qg = tref.slab_tile_queries(m)
    ops = _operands(b, m, d, bits, seed=3)
    want = _tool(ops, qg, m)
    monkeypatch.setattr(tref, "_fma32", lambda a, x, c: a * x + c)
    loose = _port(ops, qg)
    assert (loose.view(np.uint32) != want.view(np.uint32)).sum() > 0


def _k3_inputs(b: int, m: int, d: int, w: int, seed: int):
    """K3's operands (refine_bounds_plain order) over residual planes the
    port's quantizer makes, with sentinel slots, invalid rows and -inf scan
    bounds."""
    n = 2048
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((n, d), generator=g)
    emb /= emb.norm(dim=1, keepdim=True)
    planes = device_quantize(emb, refine=True)
    q = torch.randn((b, d), generator=g)
    q /= q.norm(dim=1, keepdim=True)
    rows = torch.randint(-1, n, (b, m), generator=g).to(torch.int32)
    vals = torch.randn((b, m), generator=g)
    vals[torch.rand((b, m), generator=g) < 0.03] = float("-inf")
    kw = torch.where(torch.rand((b, 8 * w), generator=g) < 0.05,
                     torch.rand((b, 8 * w), generator=g) * 0.3, torch.zeros(()))
    return (planes["emb"], planes["scale"], planes["emb2"], planes["scale2"], planes["err2"],
            torch.randint(0, 256, (n, w), generator=g).to(torch.uint8),
            torch.rand((n,), generator=g) * 400, torch.rand((n,), generator=g) > 0.1,
            q, tref.quantize_kw_weights(kw), torch.rand((b,), generator=g) * 0.1,
            365.0, rows, vals)


@pytest.mark.parametrize("b, m, d, w", [(32, 64, 768, 128), (8, 512, 384, 64),
                                        (16, 16, 256, 32)])
def test_t3_block_diagonal_is_k3(b, m, d, w):
    """Given K3's candidates as the JAX K3 wrapper gathers them (qn with
    K3's slack, add = fma(0.1, rec, eps) or -1e30), each query's own
    columns of T3's tile are K3's refined bounds, bit for bit."""
    args = _k3_inputs(b, m, d, w, seed=b * m)
    ops, qg = t3.k3_slab_operands(*args)
    diag = t3.block_diagonal(tref.refine_slab_tile(*ops, qg), m, qg)
    want = tref.refine_bounds_plain(*args)
    assert diag.view(torch.int32).equal(want.view(torch.int32))
    assert bool(torch.isneginf(want).any()) and bool(torch.isfinite(want).any())


def test_slab_tile_queries_is_the_tools_rule():
    """qg is the expression the tool assigns in main (read with ast)."""
    tree = ast.parse(TOOL_PATH.read_text(encoding="utf-8"))
    expr = next(node.value for node in ast.walk(tree)
                if isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "qg")
    rule = compile(ast.Expression(expr), str(TOOL_PATH), "eval")
    for m in (1, 16, 64, 100, 128, 129, 512, 1000, 2048, 4096):
        assert tref.slab_tile_queries(m) == eval(rule, {"m": m})  # noqa: S307


def test_t3_wrapper_rejects_shapes_the_grid_does_not_cover():
    ops = [torch.from_numpy(x) for x in _operands(8, 64, 256, 256, seed=5)]
    with pytest.raises(ValueError, match="B % qg"):
        tref.refine_slab_tile(*ops, 16)  # B = 8 is not a multiple of 16
    with pytest.raises(ValueError, match="qg <= 16"):
        tref.refine_slab_tile(*ops, 32)
    short = list(ops)
    short[8] = ops[8][:-1]
    with pytest.raises(ValueError, match="slab rows"):
        tref.refine_slab_tile(*short, 4)


def test_t3_wrapper_has_no_kernel_for_other_devices():
    ops = [torch.from_numpy(x).to("meta") for x in _operands(8, 64, 256, 256, seed=6)]
    with pytest.raises(ValueError, match="no kernel"):
        tref.refine_slab_tile(*ops, 8)


def test_t3_bound_at_the_tool_and_select_shapes():
    """0.104 ms at (B 1536, m 128, qg 16) and 0.0153 ms at K3's select shape
    (448, 64, qg 16), both by bytes: ~347 MB and ~51 MB at 3.35 TB/s."""
    ms, by = t3.slab_bound_ms(1536, 128, 768, 128, 16)
    assert by == "bytes" and abs(ms - 0.1035) < 5e-4
    ms, by = t3.slab_bound_ms(448, 64, 768, 128, 16)
    assert by == "bytes" and abs(ms - 0.01527) < 5e-5


def test_probe_serve_main_runs_every_stage_on_the_cpu(capsys):
    records = t3.main(n=4096, bt=32, m=16, device="cpu", runs=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "layout: block=2048 sub=1024 t=8"
    assert list(records) == list(t3.LABELS)
    for name, label in t3.LABELS.items():
        line = next(ln for ln in lines if ln.startswith(label + " "))
        assert line.endswith(" ms/batch") and records[name]["ms"] > 0
        assert records[name]["launches"] == {}  # the plain versions launch nothing
    assert "scan candidate bounds sorted desc: True" in lines
    sums = next(ln for ln in lines if ln.startswith("sum of parts S+G+K+T+Q = "))
    assert "S+R = " in sums and "SR measured = " in sums
    assert lines[-1].startswith('{"tool": "probe_serve", "device": "cpu"')
    k = records["K"]
    assert (k["qg"], k["ct"], k["bound_by"]) == (16, 256, "bytes") and k["bound_ms"] > 0


def test_probe_serve_main_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t3.main()
