"""tools/span_report.py on the CPU: ``summarize`` on hand-made records whose
every reading is known, and the tool end to end at a tiny size for both
engines, whose answers are held to the exact host scan."""

import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.tools import span_report
from omni_recall_tpu_torch.utils import tracing as tr

A, B, C = 11, 22, 33   # dispatcher, finalize worker, a caller


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(rows, dropped=0):
    """rows: (name, thread, batch, parent, start, end, cpu, attrs)."""
    n = len(rows)
    attrs = np.zeros((n, tr.N_ATTRS), np.int64)
    for i, r in enumerate(rows):
        attrs[i, :len(r[7])] = r[7]
    col = lambda j, dt: np.array([r[j] for r in rows], dt)  # noqa: E731
    return {"name": col(0, np.int16), "thread": col(1, np.int64), "batch": col(2, np.int64),
            "parent": col(3, np.int64), "start": col(4, float), "end": col(5, float),
            "cpu": col(6, float), "attrs": attrs, "names": tr.NAMES,
            "threads": {A: "search-coalescer", B: "search-finalize_0", C: "caller-0"},
            "dropped": dropped}


def test_summarize_reads_every_column():
    nan = float("nan")
    rec = _records([
        (tr.COLLECT, A, 0, -1, 0.0, 0.1, 0.1, (4, 8, 2)),
        (tr.INFLIGHT_WAIT, A, 0, -1, 0.1, 0.3, 0.0, ()),
        (tr.DISPATCH, A, 0, -1, 0.3, 0.5, 0.1, (4, 1, 0)),
        (tr.SCAN_K1, A, 0, 2, 0.35, 0.45, 0.05, (100, 8, 4, 16, 2, 128)),
        (tr.FINALIZE_QUEUE, B, 0, -1, 0.5, 0.6, 0.0, ()),
        (tr.FINALIZE, B, 0, -1, 0.6, 1.0, 0.1, (1, 0, 0, 0, 0, 50)),
        (tr.WAIT, B, 0, 5, 0.6, 0.8, 0.0, ()),
        (tr.RESCUE, B, 0, 5, 0.8, 0.95, 0.08, ()),
        (tr.WAIT, B, 0, 7, 0.85, 0.9, 0.0, ()),
        (tr.GC, C, -1, -1, 0.2, 0.4, 0.2, (2, 10)),
        (tr.GC, B, -1, 7, 0.9, 0.92, 0.02, (0, 3)),
        (tr.DISPATCH, A, 1, -1, 1.2, 1.3, 0.1, (4, 0, 0)),     # after the window
        (tr.FINALIZE, B, 1, -1, 0.95, nan, 0.0, ()),           # still open
    ])
    got = span_report.summarize(rec, 0.0, 1.0)
    assert got["dropped"] == 0 and got["window_s"] == 1.0
    assert got["host_gc_pct"] == pytest.approx(22.0)
    assert got["gc"] == {"passes": {"0": 1, "2": 1}, "collected": 13}
    # stages: wall 0.2 + 0.4 less waits 0.2 + 0.05; CPU 0.1 + 0.1
    assert got["host_stall_pct"] == pytest.approx(100 * (1 - 0.2 / 0.35))
    assert got["finalize_wait_ms"] == pytest.approx(250.0)
    assert got["batch_wait_ms"] == pytest.approx(300.0)
    assert got["batches"] == {"count": 1, "fill_mean": 4.0, "fill_share": 0.5, "max_batch": 8,
                              "backlog_mean": 2.0, "backlog_max": 2}
    assert got["dispatch"]["b"] == {"total": 4, "batches": 1}
    assert got["dispatch"]["host_only"] == {"total": 1, "batches": 1}
    assert got["finalize"]["escalation_rounds"] == {"total": 1, "batches": 1}
    assert got["finalize"]["rescore_pairs"] == {"total": 50, "batches": 1}
    assert got["finalize"]["host_fallbacks"] == {"total": 0, "batches": 0}
    (label, scan), = got["scans"].items()
    assert label == "scan.k1:n=100,d=8,sub=16,t=2,qt=128"
    assert scan == {"count": 1, "b_mean": 4.0, "wall_ms": pytest.approx(100.0)}
    spans = got["spans"]
    assert spans["engine.dispatch"]["count"] == 1 and spans["engine.finalize"]["count"] == 1
    assert spans["engine.finalize"]["self_ms"] == pytest.approx(50.0)
    assert spans["finalize.rescue"]["self_ms"] == pytest.approx(80.0)
    assert spans["finalize.wait"]["wall_ms"] == pytest.approx(125.0)
    assert set(got["threads"]) == {"search-coalescer", "search-finalize_0"}
    assert got["threads"]["search-coalescer"]["busy_pct"] == pytest.approx(50.0)
    assert got["threads"]["search-finalize_0"]["busy_pct"] == pytest.approx(50.0)
    assert got["threads"]["search-finalize_0"]["cpu_pct"] == pytest.approx(10.0)


def test_summarize_of_nothing():
    rec = _records([(tr.DISPATCH, A, 0, -1, 0.0, float("nan"), 0.0, ())], dropped=3)
    assert span_report.summarize(rec) == {"dropped": 3, "spans": {}}


def test_site_cost_counts_one_batch_of_sites():
    cost = span_report.site_cost_us(n_off=200, n_on=50, reps=3)
    assert cost["spans"] == 17.0 and cost["off"] > 0 and cost["on"] > 0
    assert not tr.enabled()


@pytest.mark.parametrize("engine", ["int8", "xla"])
def test_the_tool_serves_and_reports(engine, monkeypatch):
    from omni_recall_tpu_torch.tools import e2e_engine

    served = {}
    build = e2e_engine.build_e2e_engine

    def keep(*a, **k):
        served["engine"] = build(*a, **k)
        return served["engine"]

    monkeypatch.setattr(e2e_engine, "build_e2e_engine", keep)
    monkeypatch.setattr(span_report, "site_cost_us", lambda: {})
    out = span_report.main(["--engine", engine, "--n", "8192", "--callers", "8",
                            "--max-batch", "4", "--seconds", "1", "--warmup", "0.3",
                            "--device", "cpu"])
    assert out["qps"] > 0 and out["dropped"] == 0 and not tr.enabled()
    assert out["batches"]["max_batch"] == 4 and 1 <= out["batches"]["fill_mean"] <= 4
    for name in ("coalesce.collect", "coalesce.inflight_wait", "coalesce.finalize_queue",
                 "coalesce.resolve", "engine.dispatch", "dispatch.prep", "engine.finalize"):
        assert out["spans"][name]["count"] > 0, name
    assert 0 <= out["host_gc_pct"] < 100 and out["finalize_wait_ms"] >= 0
    assert {"search-coalescer", "search-finalize_0"} <= set(out["threads"])
    eng, make_requests, now, opts = served["engine"]
    assert opts.scan_dtype == ("int8" if engine == "int8" else "f32")
    assert eng.device_index.scan_dtype == opts.scan_dtype
    reqs = make_requests(5, 6)
    for (text, q, k), hits in zip(reqs, eng.search_batch(reqs, now=now)):
        want = eng._search_full_host(text, q, k, 0, now)
        assert [(h.chunk.id, h.score) for h in hits] == [(h.chunk.id, h.score) for h in want]
