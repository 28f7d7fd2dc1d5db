"""T4 (omni_recall_tpu_torch/tools/probe_keys_emit.py) against the tool's own
kernels (tools/probe_keys_emit.py, ``kern_pair``, ``kern_p3`` and ``kern_pf``
as ``make_kernels`` builds them) run in interpret mode on the CPU.

Importing the tool would set the process's JAX compilation cache, so its
three functions (``packed_keys``, ``extract_keys``, ``make_kernels``) are
read from its source with ``ast`` and run with a ``pl`` whose
``pallas_call`` is ``pl.pallas_call(..., interpret=True)``. Inputs are made
with numpy from a seed and fed to both; on the CPU the port's wrapper takes
its plain version. The rows and queries are random bits read as int8, so
-128 occurs, and some rows repeat their neighbour, so slices hold equal
scores that only the lane bits of their keys tell apart. Held bit for bit.
"""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omni_recall_tpu_torch.tools import probe_keys_emit as t4

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D, B = 4096, 768, 16
# (c, sub, t1): the tool's configuration, two blocks of several slices, and
# slices of two rows, whose keys drop one bit of the score: there the f32
# order of the scores shows in the keys (with sub >= 512 a wrong order still
# passed)
LAYOUTS = [(1024, 1024, 3), (1024, 512, 3), (2048, 512, 5), (128, 2, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions run many small tensor operations; with several
    test workers sharing the machine's cores, an intra-op thread pool stalls
    on every one of them, so these tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _tool_kernels(c: int, sub: int, t1: int, n: int = N):
    path = ROOT / "tools" / "probe_keys_emit.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fns = [node for node in tree.body if isinstance(node, ast.FunctionDef)
           and node.name in ("packed_keys", "extract_keys", "make_kernels")]
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id)
    ns = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"), ns)
    return dict(zip(t4.EMITS, ns["make_kernels"](n, D, B, c, sub, t1)))


def _operands(seed: int):
    """Random bits as int8 rows and queries, every fifth row a repeat of the
    one before it; positive row scales and query scales drawn at random (the
    tool's are 1e-4) so the order of the two multiplies shows."""
    rng = np.random.default_rng(seed)
    emb8 = rng.integers(0, 256, (N, D), dtype=np.uint8).view(np.int8)
    q8 = rng.integers(0, 256, (B, D), dtype=np.uint8).view(np.int8)
    scale = (rng.random((1, N)) * 1e-3 + 1e-5).astype(np.float32)
    twins = np.arange(0, N - 1, 5)
    emb8[twins + 1] = emb8[twins]
    scale[0, twins + 1] = scale[0, twins]
    qs = (rng.random((B, 1)) * 1e-2 + 1e-4).astype(np.float32)
    assert (emb8 == -128).any() and (q8 == -128).any()
    return emb8, q8, scale, qs


def _port(emit, c, sub, t1, *arrs):
    out = t4.keys_scan(*(torch.from_numpy(x) for x in arrs), c, sub, t1, emit)
    return tuple(x.numpy() for x in out) if emit == "pair" else (out.numpy(),)


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("emit", list(t4.EMITS))
@pytest.mark.parametrize("c, sub, t1", LAYOUTS)
def test_t4_matches_the_tool_bitwise(c, sub, t1, emit):
    arrs = _operands(c + sub + t1)
    want = _tool_kernels(c, sub, t1)[emit](*map(jnp.asarray, arrs))
    want = tuple(np.asarray(x) for x in (want if emit == "pair" else (want,)))
    got = _port(emit, c, sub, t1, *arrs)
    width = (c // sub) * t1
    assert want[0].shape == ((B, N // c * width) if emit == "pf" else (N // c, B, width))
    assert len(got) == len(want)
    assert all(_bits_equal(w, g) for w, g in zip(want, got))


def test_t4_score_order_is_the_tools():
    """At sub = 1 a key is its whole score, so the tool's PF emit gives
    every score's bits. Over 1024 rows and 16 queries: ``(cosd * qs) *
    scale`` matches all 16384; ``cosd * (qs * scale)`` misses 5715 and
    ``(cosd * scale) * qs`` 5706."""
    n = 1024
    emb8, q8, scale, qs = _operands(1)
    emb8, scale = emb8[:n], scale[:, :n]
    tool = _tool_kernels(256, 1, 1, n)["pf"]
    keys = np.asarray(tool(*map(jnp.asarray, (emb8, q8, scale, qs))))
    want = (keys ^ ((keys >> 31) & 0x7FFFFFFF)).view(np.float32)
    dot = torch.from_numpy(q8).to(torch.float64) @ torch.from_numpy(emb8).to(torch.float64).T
    dot, qs_t, scale_t = dot.float(), torch.from_numpy(qs), torch.from_numpy(scale)
    forms = {"port": (dot * qs_t) * scale_t, "qs*scale first": dot * (qs_t * scale_t),
             "scale first": (dot * scale_t) * qs_t}
    misses = {k: int((v.numpy().view(np.int32) != want.view(np.int32)).sum())
              for k, v in forms.items()}
    assert misses["port"] == 0 and misses["qs*scale first"] > 0 and misses["scale first"] > 0
    got = t4.keys_scan(*map(torch.from_numpy, (emb8, q8, np.ascontiguousarray(scale), qs)),
                       256, 1, 1, "pf")
    assert np.array_equal(got.numpy(), keys)


def test_t4_ties_are_told_apart_by_their_lanes():
    """Each repeated row scores exactly as its neighbour; where both are
    among a slice's top two, the pair emit names both rows, the lower one
    (the larger lane bits) first, with equal decoded values."""
    emb8, q8, scale, qs = _operands(7)
    sub, t1 = 1024, 3
    vals, idxs = _port("pair", sub, sub, t1, emb8, q8, scale, qs)
    first, second = idxs[..., 0], idxs[..., 1]
    tied = second == first + 1
    assert tied.any()
    assert (vals[..., 0][tied] == vals[..., 1][tied]).all()


def test_t4_emits_agree_as_the_tool_checks():
    """P3 decoded is bitwise pair's values; PF is P3 transposed."""
    arrs = _operands(8)
    c, sub, t1 = 1024, 512, 3
    vals, _ = _port("pair", c, sub, t1, *arrs)
    (k3,) = _port("p3", c, sub, t1, *arrs)
    (kf,) = _port("pf", c, sub, t1, *arrs)
    assert _bits_equal(t4.decode_up(torch.from_numpy(k3), sub).numpy(), vals)
    assert np.array_equal(kf.reshape(B, N // c, -1), k3.transpose(1, 0, 2))


def test_t4_wrapper_rejects_what_it_does_not_take():
    arrs = [torch.from_numpy(x) for x in _operands(9)]
    with pytest.raises(ValueError, match="unknown T4 emit"):
        t4.keys_scan(*arrs, 1024, 1024, 3, "flat")
    with pytest.raises(ValueError, match="power of two"):
        t4.keys_scan(*arrs, 768, 768, 3, "pair")
    with pytest.raises(ValueError, match="N % c"):
        t4.keys_scan(*arrs, 3072, 1024, 3, "p3")


def test_t4_main_runs_the_tool_configuration_on_the_cpu(capsys):
    records = t4.main(n=4096, device="cpu", runs=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "P3 decode: bit-identical to the pair emit"
    assert lines[1] == "PF flat layout: matches P3"
    timed = [ln for ln in lines if ln.endswith(" ms/batch")]
    assert [ln.split(" (")[0].strip() for ln in timed] == ["pair", "P3", "PF"]
    assert lines[-1].startswith('{"tool": "probe_keys_emit", "device": "cpu"')
    assert [r["emit"] for r in records] == list(t4.EMITS)
    assert all(r["launches"] == 0 and r["ms"] > 0 for r in records)


def test_t4_main_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t4.main()
