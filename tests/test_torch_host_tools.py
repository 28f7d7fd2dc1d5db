"""The port's counterparts of the repository's host-only tools of the
snapshot / compact-store / ingestion slice (tools/probe_rebuild.py,
tools/sweep_10m.py, tools/bench_ingest.py) at small sizes on the CPU: each
runs its stages and prints its JSON lines."""

import json

import numpy as np
import pytest


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]


def test_probe_rebuild_times_each_stage(capsys):
    from omni_recall_tpu_torch.tools import probe_rebuild

    records = probe_rebuild.main(["--rows", "2048", "--dim", "32", "--device", "cpu"])
    assert [r["stage"] for r in records] == ["fetch", "append", "upload", "upload", "rebuild",
                                             "compact"]
    assert all(r["rows"] == 2048 and r["s"] >= 0 for r in records)
    # the first rebuild derives every row; the second reuses the index's own
    assert records[4]["route"] == "upload" and records[5]["route"] == "device"
    lines = _json_lines(capsys)
    assert lines[-1]["tool"] == "probe_rebuild" and lines[-1]["stages"] == records


def test_probe_rebuild_stages_leave_the_index_serving():
    from omni_recall_tpu_torch.tools import probe_rebuild

    engine = probe_rebuild.build_engine(1024, d=32, bits=256, device="cpu")
    probe_rebuild.stages(engine, trials=1)
    dix = engine.device_index
    assert dix.n_rows == 1024 and dix.n_valid == 1024
    q = np.zeros(32, dtype=np.float32)
    q[0] = 1.0
    hits = engine.search("topic c7x", q.tolist(), 3)
    assert len(hits) == 3


def test_bench_ingest_reports_chunks_per_second(capsys):
    from omni_recall_tpu_torch.tools import bench_ingest

    records = bench_ingest.main(["--rows", "1500", "--dim", "32", "--device", "cpu"])
    assert [r["scan_dtype"] for r in records] == ["f32", "int8"]
    for r in records:
        assert r["rows"] == 1500 and r["chunks_per_s"] > 0 and r["append_chunks_per_s"] > 0
    assert _json_lines(capsys)[-1]["records"] == records


def test_sweep_10m_sweeps_k1_layouts_on_built_planes(capsys):
    from omni_recall_tpu_torch.tools import sweep_10m

    assert sweep_10m.DEFAULT_CONFIGS[0] == (448, 512, 2) and len(sweep_10m.DEFAULT_CONFIGS) == 12
    records = sweep_10m.main(["--rows", "16384", "--m", "32", "--device", "cpu", "8,512,2",
                              "8,1024,4"])
    assert [(r["b"], r["sub"], r["t"]) for r in records] == [(8, 512, 2), (8, 1024, 4)]
    for r in records:
        assert "failed" not in r and r["k1_ms"] > 0 and r["scan_ms"] > 0
        assert r["qps"] == pytest.approx(8 / r["scan_ms"] * 1e3)
    assert _json_lines(capsys)[-1]["tool"] == "sweep_10m"
