"""One short run of each cell on the card, as the benchmark's command runs
it (``python -m pytest -m cuda recall_bench/tests``); skipped without one."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["int8-1M-hybrid-c896", "xla-1M-hybrid-c896"])
def test_short_run_on_the_card(cell):
    import torch

    from recall_bench import run

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run([sys.executable, "-m", "recall_bench.run", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    want = {m["name"] for m in run.load_cell(ROOT, cell).end_to_end}
    assert set(out["metrics"]) == want and all(m["value"] > 0 for m in out["metrics"].values())
