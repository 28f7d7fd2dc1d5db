"""Whole runs of each cell at a size the CPU holds: correct, the metrics of
the cell's line, and nothing of JAX or the JAX package loaded."""

import json
import subprocess
import sys
from concurrent.futures import Future

import pytest

from conftest import ROOT, tiny


@pytest.mark.parametrize("cell", ["int8-1M-hybrid-c896", "xla-1M-hybrid-c896"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run(cell, traced):
    from recall_bench import run

    c = tiny(cell)
    out = run.run(ROOT, c, 2**31 + 17, 1.5, traced, device="cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    # no card is traced on the CPU: the readers of a trace find nothing
    want -= {m["name"] for m in (c.per_layer if traced else c.end_to_end)
             if m["source"] == "device_trace"}
    assert "breakdown" not in out and "busy_s" not in out["device"]
    assert set(out["metrics"]) == want
    assert list(out)[-2:] == ["checks", "stats"]
    st = out["stats"]
    rate = out["metrics"].get("certified_qps" if not traced else "certified_qps.hostpaced")
    assert st["window_qps"] > 0
    if rate is not None:
        assert st["window_qps"] == pytest.approx(rate["value"])
    assert st["callback_ms_per_batch"] >= 0 and st["harness_ms_per_batch"] > 0
    assert st["gc_full_passes"] >= 0 and st["process_cpu_s"] > 0


def test_the_loop_mirrors_search():
    from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor

    from recall_bench import load

    load.check_mirror(CoalescingSearchExecutor)

    class Changed(CoalescingSearchExecutor):
        def search(self, query, query_embedding, top_k, now=None):
            """Blocking search."""
            future = Future()
            with self._submit_lock:
                if self._closed:
                    raise RuntimeError("executor is closed")
                self._queue.put(((query, query_embedding, top_k), now, future, "more"))
            return future.result()

    with pytest.raises(RuntimeError, match="no longer the enqueue"):
        load.check_mirror(Changed)


def test_no_jax_is_loaded():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import ROOT, tiny\n"
            "from recall_bench import run\n"
            "out = run.run(ROOT, tiny('int8-1M-hybrid-c896'), 5, 1.0, True, device='cpu')\n"
            "print(run.forbidden_modules(), out['correct'])\n") % (str(ROOT), str(ROOT / "recall_bench" / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"
    # and the check catches a name whose top level is the JAX package's, whole
    from recall_bench import run

    sys.modules.setdefault("omni_recall_tpu", type(sys)("omni_recall_tpu"))
    try:
        assert run.forbidden_modules() == ["omni_recall_tpu"]
    finally:
        del sys.modules["omni_recall_tpu"]


def test_without_a_card_no_result():
    res = subprocess.run([sys.executable, "-m", "recall_bench.run", "--workload",
                          "int8-1M-hybrid-c896", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_result_line_is_json(tmp_path):
    from recall_bench import run

    out = run.run(ROOT, tiny("xla-1M-hybrid-c896"), 3, 1.0, False, device="cpu")
    out.pop("stats")
    line = json.dumps(out)
    assert json.loads(line)["correct"] is True
    assert list(json.loads(line))[-1] == "checks"
