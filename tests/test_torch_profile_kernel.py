"""T1 (omni_recall_tpu_torch/tools/profile_kernel.py) against the tool's own
kernel bodies (tools/profile_kernel.py mk_cos_only, mk_cos_kw, mk_full) run
in interpret mode on the CPU.

The tool builds 2^20-row arrays and runs its sweep when imported, so the
bodies are read from its source with ``ast`` and launched here through
``pl.pallas_call(..., interpret=True)`` with the tool's BlockSpecs. Inputs are
made with numpy from a seed and fed to both; on the CPU the port's wrapper
takes its plain version. The interpret kernel sums its bf16 dots in XLA's
order and the port in k order (K6's rule, tests/test_torch_scorer.py): on
exactly-summable inputs (entries multiples of 2^-4, keyword weights
multiples of 2^-6) every order gives the same sums and the port is held bit
for bit; elsewhere to the bound of a reordered f32 sum,
0.7·γ_d·Σ|q̂ê| + 0.2·γ_8W·Σŵ (T1-cos: γ_d·Σ|q̂ê|), γ_n = n·2^-24, plus 4 ulp
of the result for the epilogue.
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

from omni_recall_tpu_torch.tools import profile_kernel as t1

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D, B, BITS = 4096, 768, 16, 1024
W = BITS // 8
BLOCKS = (1024, 2048)


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
def _tool_bodies():
    path = ROOT / "tools" / "profile_kernel.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    defs = [node for node in tree.body if isinstance(node, ast.FunctionDef)
            and node.name in ("mk_cos_only", "mk_cos_kw", "mk_full")]
    assert len(defs) == 3
    ns = {"jax": jax, "jnp": jnp, "b": B}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"), ns)
    return {"cos": ns["mk_cos_only"], "coskw": ns["mk_cos_kw"],
            "full": lambda c: ns["mk_full"](c, t1.TOP)}


def _tool(variant, c, arrs):
    """The tool's body for ``variant`` at block c, as its bench_variant
    launches it (memory spaces omitted), in interpret mode."""
    width = t1.TOP if variant == "full" else t1.WIDE
    kern = pl.pallas_call(
        _tool_bodies()[variant](c), grid=(N // c,),
        in_specs=[pl.BlockSpec((c, D), lambda i: (i, 0)),
                  pl.BlockSpec((c, W), lambda i: (i, 0)),
                  pl.BlockSpec((B, D), lambda i: (0, 0)),
                  pl.BlockSpec((B, BITS), lambda i: (0, 0)),
                  pl.BlockSpec((B, 1), lambda i: (0, 0)),
                  pl.BlockSpec((1, c), lambda i: (0, i))],
        out_specs=(pl.BlockSpec((1, B, width), lambda i: (i, 0, 0)),),
        out_shape=(jax.ShapeDtypeStruct((N // c, B, width), jnp.float32),),
        interpret=True,
    )
    emb, *rest = arrs
    return np.asarray(kern(jnp.asarray(emb).astype(jnp.bfloat16), *map(jnp.asarray, rest))[0])


def _port(variant, c, arrs):
    emb, *rest = arrs
    out = t1.profile_scan(variant, torch.from_numpy(emb).to(torch.bfloat16),
                          *(torch.from_numpy(x) for x in rest), c)
    return out.numpy()


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


def _operands(seed: int, exact: bool):
    rng = np.random.default_rng(seed)

    def sparse(rows):
        x = np.zeros((rows, D), np.float32)
        for r in range(rows):
            x[r, rng.choice(D, 32, replace=False)] = rng.integers(-16, 17, 32) * 2.0**-4
        return x

    if exact:
        emb, q = sparse(N), sparse(B)
        kw = np.where(rng.random((B, BITS)) < 0.01,
                      rng.integers(0, 20, (B, BITS)) * 2.0**-6, 0).astype(np.float32)
        kw_b = (rng.integers(0, 8, (B, 1)) * 2.0**-6).astype(np.float32)
    else:
        emb = rng.standard_normal((N, D)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        q = rng.standard_normal((B, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        kw = np.where(rng.random((B, BITS)) < 0.05, rng.random((B, BITS)) * 0.1,
                      0).astype(np.float32)
        kw[2] *= 20.0  # a query whose keyword term clamps at 1
        kw_b = (rng.random((B, 1)) * 0.05).astype(np.float32)
    bloom = rng.integers(0, 256, size=(N, W), dtype=np.uint8)
    add_row = (rng.random((1, N)) * 0.1).astype(np.float32)
    # rows 5, 6 and 7 repeat row 3, and query 0 points at it: four equal
    # block maxima
    for r in (5, 6, 7):
        emb[r], bloom[r], add_row[0, r] = emb[3], bloom[3], add_row[0, 3]
    q[0] = emb[3]
    return emb, bloom, q, kw, kw_b, add_row


def _bound(arrs, variant, c, got):
    """Per-entry bound of a reordered sum (see the module docstring),
    shaped like the variant's output."""
    emb, _, q, kw = arrs[:4]
    eh = np.asarray(jnp.asarray(emb).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    qh = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    g = lambda n: n * 2.0**-24  # noqa: E731
    cos_term = g(D) * (np.abs(qh) @ np.abs(eh).T)  # [B, N]
    if variant == "cos":
        per = cos_term
    else:
        kw_term = g(BITS) * kw.astype(np.float64).sum(axis=1, keepdims=True) * (1 + 2.0**-8)
        per = 0.7 * cos_term + 0.2 * kw_term
    if variant == "full":  # an order statistic moves at most as far as any score
        per = per.reshape(B, N // c, c).max(axis=2).T[:, :, None]
    else:
        per = per.reshape(B, N // c, c)[:, :, :t1.WIDE].transpose(1, 0, 2)
    return per + 4 * np.spacing(np.abs(got).astype(np.float32))


@pytest.mark.parametrize("c", BLOCKS)
@pytest.mark.parametrize("variant", list(t1.VARIANTS))
def test_t1_matches_the_tool_bitwise_on_exactly_summable_inputs(variant, c):
    arrs = _operands(20, exact=True)
    want, got = _tool(variant, c, arrs), _port(variant, c, arrs)
    assert _bits_equal(want, got)


@pytest.mark.parametrize("c", BLOCKS)
@pytest.mark.parametrize("variant", list(t1.VARIANTS))
def test_t1_matches_the_tool_within_the_sum_order_bound(variant, c):
    arrs = _operands(21, exact=False)
    want, got = _tool(variant, c, arrs), _port(variant, c, arrs)
    assert want.shape == got.shape and got.dtype == np.float32
    diff = np.abs(want.astype(np.float64) - got.astype(np.float64))
    assert np.all(diff <= _bound(arrs, variant, c, want))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("c", BLOCKS)
def test_t1_full_is_the_float64_top9_of_the_plain_scores(c):
    arrs = _operands(22, exact=False)
    emb, *rest = arrs
    scores = t1.scores_plain("coskw", torch.from_numpy(emb).to(torch.bfloat16),
                             *(torch.from_numpy(x) for x in rest)).numpy()
    top = -np.sort(-scores.astype(np.float64).reshape(B, N // c, c), axis=2)[:, :, :t1.TOP]
    got = _port("full", c, arrs)
    assert np.array_equal(got.astype(np.float64), top.transpose(1, 0, 2))


def test_t1_full_repeats_equal_scores_lowest_lane_first():
    arrs = _operands(23, exact=False)
    c = 1024
    want, got = _tool("full", c, arrs), _port("full", c, arrs)
    # query 0, block 0: rows 3, 5, 6, 7 are one row four times
    for out in (want, got):
        assert len(set(out[0, 0, :4].tolist())) == 1 and out[0, 0, 4] < out[0, 0, 0]
    emb, *rest = arrs
    scores = t1.scores_plain("coskw", torch.from_numpy(emb).to(torch.bfloat16),
                             *(torch.from_numpy(x) for x in rest))
    vals, lanes = t1.top_values_plain(scores.reshape(B, N // c, c))
    assert lanes[0, 0, :4].tolist() == [3, 5, 6, 7]
    assert _bits_equal(vals.transpose(0, 1).numpy(), got)


def test_t1_wrapper_rejects_blocks_it_does_not_take():
    arrs = [torch.from_numpy(x) for x in _operands(24, exact=True)]
    arrs[0] = arrs[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="c >= 128"):
        t1.profile_scan("cos", *arrs, 64)
    with pytest.raises(ValueError, match="N % c"):
        t1.profile_scan("full", *arrs, 3000)
    with pytest.raises(ValueError, match="unknown T1 variant"):
        t1.profile_scan("kw", *arrs, 1024)


def test_t1_main_runs_the_tool_sweep_on_the_cpu(capsys):
    records = t1.main("all", n=4096, device="cpu", runs=1)
    lines = capsys.readouterr().out.splitlines()
    tool_lines = [ln for ln in lines if " ms/scan -> " in ln]
    assert len(tool_lines) == len(records) == 3 * len(t1.BLOCKS)
    assert tool_lines[0].startswith("cos-only (c=1024): ")
    assert tool_lines[-1].startswith("full t=8 (c=4096): ")
    assert lines[-1].startswith('{"tool": "profile_kernel", "device": "cpu"')
    assert all(r["launches"] == 0 and r["ms"] > 0 for r in records)


def test_t1_main_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t1.main("cos")
