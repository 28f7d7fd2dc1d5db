"""The port's profiling helpers (omni_recall_tpu_torch/utils/profiling.py) on
the CPU: ``Stopwatch`` as the JAX package's, ``device_trace`` writing a
Chrome trace when the CPU is asked, ``device_ops`` reading a trace's device
operations, the medians on the host clock, and CUDA by default: without a
card the trace refuses."""

import json
import time

import pytest
import torch

from omni_recall_tpu.utils import profiling as jprofiling
from omni_recall_tpu_torch.utils import profiling


def test_stopwatch_counts_milliseconds_as_jax_s():
    for mod in (profiling, jprofiling):
        watch = mod.Stopwatch()
        time.sleep(0.02)
        ms = watch.elapsed_ms()
        assert 15.0 <= ms < 2000.0
        assert watch.elapsed_ms() >= ms


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace"), device="cpu") as trace:
        y = x @ x
    assert trace.path == str(tmp_path / "trace" / "trace.json")
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)
    assert trace.profile is not None and float(y.sum()) == float((x @ x).sum())
    # no device on the CPU: the trace holds host events only
    assert profiling.device_ops(trace.path) == []


def test_device_ops_sums_kernels_by_name(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void int8_scan_kernel<CoarseArgs>", "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "void int8_scan_kernel<CoarseArgs>", "dur": 7.0},
        {"ph": "X", "cat": "kernel", "name": "dd_rows_kernel", "dur": 1.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 90.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]}))
    ops = profiling.device_ops(str(path))
    assert [o["name"] for o in ops] == ["void int8_scan_kernel<CoarseArgs>", "Memcpy DtoH",
                                        "dd_rows_kernel"]
    assert ops[0] == {"name": "void int8_scan_kernel<CoarseArgs>", "category": "kernel",
                      "count": 2, "total_us": 12.0, "max_us": 7.0}


def test_medians_on_the_host_clock():
    calls = []
    ms = profiling.median_ms(lambda: calls.append(time.sleep(0.002)), torch.device("cpu"),
                             runs=3)
    assert len(calls) == 4 and 1.5 <= ms < 1000.0  # one warm-up, three timed
    assert profiling.host_median_ms(lambda: None, runs=3) >= 0.0


def test_cuda_defaults_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.device_trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t" / "trace.json").exists()
