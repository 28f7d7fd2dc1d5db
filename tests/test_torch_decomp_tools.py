"""The six stage probes of the port's tools/ (profile_int8, sweep_coarse,
probe_scan_decomp, profile_refine, probe_direct_serve, probe_gather_sorted)
at small sizes on the CPU, with the kernels' plain versions: each ``main``
times every stage and holds the stages' outputs against the unsplit path's
(``whole_path_equal``, bitwise; ``main`` raises where they differ), prints
one JSON line with its records, and asks for CUDA unless the CPU is asked.
Then the stages' bounds against hand counts."""

import json

import pytest
import torch

from omni_recall_tpu_torch.tools import (
    probe_direct_serve,
    probe_gather_sorted,
    probe_scan_decomp,
    profile_int8,
    profile_refine,
    stages,
    sweep_coarse,
)

SMALL = {
    "profile_int8": (profile_int8, dict(n=8192, d=64, configs=(
        ("base", 8, 256, 1, 512), ("bits512", 16, 512, 1, 256)), m=8)),
    "sweep_coarse": (sweep_coarse, dict(n=8192, d=64, grid=[(8, 1024, 512), (16, 2048, 1024)],
                                        top=8)),
    "probe_scan_decomp": (probe_scan_decomp, dict(n=8192, d=64, bt=16, m=16, bits=256)),
    "profile_refine": (profile_refine, dict(n=8192, b=16, d=64, bits=256, m=32)),
    "probe_direct_serve": (probe_direct_serve, dict(n=1 << 17, d=32, bt=8, bits=256)),
    "probe_gather_sorted": (probe_gather_sorted, dict(n=4096, d=64, w=32, bt=16, m=8)),
}
STAGES = {
    "profile_int8": ["K4", "K4"],
    "sweep_coarse": ["K1", "K1"],
    "probe_scan_decomp": ["B"] * 7 + ["A", "Q", "M", "F"],
    "profile_refine": ["gather", "select", "refine", "scan", "serve"],
    "probe_direct_serve": ["S", "A", "B", "B", "DD", "Sm", "Sm", "Bn", "Bg", "B33"] * 3,
    "probe_gather_sorted": ["R", "S", "SF"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(SMALL))
def test_tool_times_its_stages_and_holds_them_to_the_whole_path(name, capsys):
    tool, kw = SMALL[name]
    records = tool.main(device="cpu", runs=1, **kw)
    assert [r["stage"] for r in records] == STAGES[name]
    for r in records:
        assert r["ms"] > 0 and r["host_ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["launches"] == {}  # the plain versions launch no kernel
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tool"] == name and line["device"] == "cpu" and line["records"] == records
    if name in ("profile_int8", "sweep_coarse"):
        assert all(r["whole_path_equal"] for r in records)
    else:
        assert line["whole_path_equal"] is True


def test_sweep_coarse_grid_is_the_tool_s():
    grid = sweep_coarse.configs()
    assert len(grid) == 16 and grid[0] == (448, 1024, 512) and grid[-1] == (1024, 2048, 1024)
    assert all(sub <= block for _, block, sub in grid)


@pytest.mark.parametrize("name", list(SMALL))
def test_tool_needs_cuda_unless_cpu_is_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool, kw = SMALL[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(runs=1, **kw)


def test_stage_bounds_count_bytes_and_operations():
    # K1 at the serving shape: its int8 operations bind (chip_smoke.py's K1 line: 0.365 ms)
    n, b, d = 1 << 20, 448, 768
    ms, by = stages.bound_ms(*stages.coarse_work(n, b, d, 1024, 3))
    assert by == "operations" and abs(ms - 2.0 * n * d * b / 1.979e15 * 1e3) < 1e-12
    # a gather moves each row twice (read, write) and does no arithmetic
    ms, by = stages.bound_ms(*stages.gather_work(1000, 1812))
    assert by == "bytes" and abs(ms - 2 * 1000 * 1812 / 3.35e12 * 1e3) < 1e-15
    # stages in sequence: bytes add, operation times add at their own rates
    a, c = stages.coarse_work(n, b, d, 1024, 3), stages.dd_work(b, 32, d)
    moved, ops, rate = stages.total(a, c)
    assert moved == a[0] + c[0]
    assert abs(ops / rate - (a[1] / a[2] + c[1] / c[2])) < 1e-15
