"""The benchmark's frozen arithmetic on hand-made samples: percentiles,
rates, roofline bounds, interval unions, and the reading of a trace."""

import json

import numpy as np
import pytest

from recall_bench import measure, spans, trace


def test_percentile_and_rate():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 1000):
        v = rng.exponential(size=n)
        for q in (0, 50, 95, 100):
            assert measure.percentile(v, q) == pytest.approx(np.percentile(v, q), rel=1e-12)
    assert measure.percentile([1, 2, 3, 4], 95) == pytest.approx(3.85)
    assert measure.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        measure.percentile([], 95)


def test_roofline_bounds():
    # K1 at the serving shape: 2 * 2^20 * 768 * 448 int8 operations at 1979 TOP/s
    ops, nbytes = measure.coarse_scan_work(1 << 20, 768, 448, 1024, 2)
    assert ops == 2 * (1 << 20) * 768 * 448
    assert nbytes == (1 << 20) * 768 + 8 * (1 << 20) + 448 * 768 + 8 * 448 + 8 * 448 * 1024 * 2
    assert measure.bound_s(ops, nbytes, "int8") == pytest.approx(ops / 1979e12)
    assert measure.bound_s(ops, nbytes, "int8") * 1e3 == pytest.approx(0.3646, abs=1e-4)
    # the xla scan's cosine product in f32: compute-bound too
    ops, nbytes = measure.xla_scan_work(1 << 20, 768, 448, 128)
    assert nbytes == 4 * (1 << 20) * 768 + (1 << 20) * 128
    assert measure.bound_s(ops, nbytes, "f32") == pytest.approx(ops / 67e12)
    # a byte-bound shape
    assert measure.bound_s(1.0, 3.35e12, "int8") == pytest.approx(1.0)


def test_intervals():
    busy = measure.merge([(5, 7), (0, 2), (1, 3), (6, 9), (20, 30)], 0, 10)
    assert busy == [[0, 3], [5, 9]]
    assert measure.gaps(busy, 0, 10) == [(3, 5), (9, 10)]
    assert measure.intersect([(0, 4), (6, 8)], [(3, 7)]) == [(3, 4), (6, 7)]
    assert measure.overlap([(0, 4), (6, 8)], [(3, 7)]) == 2
    assert measure.idle_share(7.0, 10.0) == pytest.approx(30.0)


def write_trace(tmp_path):
    """A traced span 1000 us long at 10000 us on the profiler's clock; host clock
    = profiler clock - 9 s (anchors say so); one K1 kernel and two kernels
    launched inside an xla call, one kernel launched outside."""
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "ts": 10001.0, "dur": 1,
         "tid": 1, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "ts": 10990.0, "dur": 1,
         "tid": 1, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10100.0, "dur": 5,
         "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "int8_scan_kernel<32, CoarseArgs>", "ts": 10110.0,
         "dur": 100.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10400.0, "dur": 5,
         "tid": 8, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10410.0, "dur": 200.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10420.0, "dur": 5,
         "tid": 8, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "topk", "ts": 10610.0, "dur": 50.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10800.0, "dur": 5,
         "tid": 8, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10800.0, "dur": 300.0,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 10200.0, "dur": 20.0,
         "args": {}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    host = -9.0   # host = profiler - 9 s
    anchors = {"window": (0.010 + host, 0.011 + host),
               "queries": [[(0.010001 + host - 1e-7, 0.010001 + host + 1e-7)],
                           [(0.010990 + host - 1e-7, 0.010990 + host + 1e-7)]]}
    calls = [spans.Call("xla_scan", 0.010390 + host, 0.010430 + host,
                        {"n": 1, "d": 1, "b": 1, "w": 1}),
             spans.Call("dispatch", 0.010050 + host, 0.010300 + host, {}),
             spans.Call("finalize", 0.010380 + host, 0.010700 + host, {})]
    return path, anchors, calls


def test_trace_reading(tmp_path):
    path, anchors, calls = write_trace(tmp_path)
    tr = trace.read(str(path), anchors, calls)
    assert tr.window == pytest.approx((0.010, 0.011))
    # device busy: [10110, 10220) + [10410, 10660) + [10800, 11000) clipped to the window
    assert tr.busy_s() == pytest.approx((110 + 250 + 200) * 1e-6)
    xla = tr.in_window("xla_scan")
    assert len(xla) == 1 and xla[0].kernels == 2
    assert xla[0].device_s == pytest.approx(250e-6)
    ops = dict(trace.top_device_ops(tr))
    assert ops["gemm"] == pytest.approx(400e-6)
    # idle gaps [10000, 10110) [10220, 10410) [10660, 10800); dispatch open over
    # [10050, 10300), finalize over [10380, 10700)
    idle = dict(trace.idle_by_host(tr, "dispatch", "finalize"))
    assert idle["dispatch"] == pytest.approx(140e-6)
    assert idle["finalize"] == pytest.approx(70e-6)
    assert idle["dispatch+finalize"] == pytest.approx(0.0, abs=1e-12)
    assert idle["none"] == pytest.approx(230e-6)


def test_trace_without_the_anchors_is_refused(tmp_path):
    path, anchors, calls = write_trace(tmp_path)
    extra = dict(anchors, queries=[anchors["queries"][0] * 2, anchors["queries"][1]])
    with pytest.raises(ValueError, match="cudaStreamQuery"):
        trace.read(str(path), extra, calls)
    with pytest.raises(ValueError, match="cudaStreamQuery"):
        trace.read(str(path), dict(anchors, queries=[]), calls)


def test_roofline_readers(tmp_path, root):
    from recall_bench.run import RunData, reader

    path, anchors, calls = write_trace(tmp_path)
    calls.append(spans.Call("k1", 0.010090 - 9.0, 0.010120 - 9.0,
                            {"n": 1 << 20, "d": 768, "b": 448, "sub": 1024, "t": 2}))
    tr = trace.read(str(path), anchors, calls)
    run = RunData(window=(0, 1), latencies=np.ones(3), completed=3, setup_s=1.0,
                  stats0={"searches_total": 0, "rescore_pairs_total": 0},
                  stats1={"searches_total": 10, "rescore_pairs_total": 320}, trace=tr)
    k1 = reader(root, "coarse_scan_roofline_pct")(run)
    bound = measure.bound_s(*measure.coarse_scan_work(1 << 20, 768, 448, 1024, 2), "int8")
    assert k1 == pytest.approx(100 * bound / 100e-6)
    xla = reader(root, "xla_scan_roofline_pct")(run)
    assert xla == pytest.approx(100 * measure.bound_s(2.0, 5.0, "f32") / 250e-6)
    assert reader(root, "rescore_pairs_per_query")(run) == 32.0
    assert reader(root, "device_idle_pct")(run) == pytest.approx(44.0)
    # a reader that finds nothing to read returns nothing
    empty = RunData(window=(0, 1), latencies=np.ones(3), completed=3, setup_s=1.0,
                    stats0={}, stats1={})
    for name in ("coarse_scan_roofline_pct", "xla_scan_roofline_pct", "device_idle_pct",
                 "dispatch_ms", "finalize_ms"):
        assert reader(root, name)(empty) is None


def test_device_time_per_query_reads_the_window_trace():
    from recall_bench.run import RunData, reader
    from conftest import ROOT

    tr = trace.Trace(window=(0.0, 10.0), device=[(1.0, 2.0, "k"), (1.5, 3.0, "k"),
                                                 (5.0, 6.0, "c"), (9.5, 11.0, "k")])
    run = RunData(window=(100.0, 110.0), latencies=np.ones(1000), completed=1000, setup_s=1.0,
                  stats0={}, stats1={}, trace=tr, trace_is_window=True)
    read = reader(ROOT, "device_us_per_query")
    assert read(run) == pytest.approx(1e6 * 3.5 / 1000)
    run.trace_is_window = False      # a span traced after the window is not the window
    assert read(run) is None
