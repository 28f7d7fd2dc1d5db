"""The program's own spans (``omni_recall_tpu_torch/utils/tracing.py``)
against the benchmark's wrappers (``spans.py``), in a whole traced run of
each cell on the CPU with the recorder switched on: every ``engine.dispatch``,
``engine.finalize``, ``scan.k1`` and ``scan.xla`` span lies inside one
wrapper call of its method, one to one, so the spans can take the
wrappers' place without moving what the metrics time."""

import pytest

from conftest import ROOT, tiny

PAIRS = (("dispatch", "engine.dispatch"), ("finalize", "engine.finalize"),
         ("k1", "scan.k1"), ("xla_scan", "scan.xla"))


@pytest.mark.parametrize("cell", ["int8-1M-hybrid-c896", "xla-1M-hybrid-c896"])
def test_program_spans_nest_in_the_wrappers_calls(cell, monkeypatch):
    import numpy as np

    from omni_recall_tpu_torch.utils import tracing

    from recall_bench import run, spans

    clocks = []
    install = spans.install

    def keep_clock(engine, clock):
        clocks.append(clock)
        return install(engine, clock)

    monkeypatch.setattr(spans, "install", keep_clock)
    tracing.disable()
    try:
        out = run.run(ROOT, tiny(cell), 2**31 + 23, 1.0, True, device="cpu",
                      patch=lambda engine: tracing.enable())
        rec = tracing.records()
    finally:
        tracing.disable()
    assert out["correct"], out["checks"]
    assert rec["dropped"] == 0
    calls = clocks[0].calls
    lo, hi = min(c.start for c in calls), max(c.end for c in calls)
    seen = set()
    for wrapper, name in PAIRS:
        wrapped = sorted((c.start, c.end) for c in calls if c.name == wrapper)
        rows = np.flatnonzero((rec["name"] == tracing.NAMES.index(name))
                              & (rec["start"] >= lo) & (rec["start"] <= hi))
        rows = rows[np.argsort(rec["start"][rows])]
        assert len(rows) == len(wrapped), (wrapper, len(rows), len(wrapped))
        for (start, end), r in zip(wrapped, rows):
            assert start <= rec["start"][r] <= rec["end"][r] <= end, wrapper
        if len(rows):
            seen.add(wrapper)
    assert {"dispatch", "finalize"} <= seen
    assert ("k1" if cell.startswith("int8") else "xla_scan") in seen
