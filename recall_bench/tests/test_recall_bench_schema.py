"""``BENCHMARK.json`` and the files it names: the format's characters, keys
and limits, and one file of its own for every configuration, traffic mix,
cell limit and metric."""

import json
import re

from recall_bench import generator

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expan")


def load(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(root):
    b = load(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("recall_bench/") and (root / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        names.add(c["name"])
    assert len(names) == len(b["configs"]) and 1 <= len(names) <= 24
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"]) and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    metrics = set()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.add(m["name"])
    assert "setup_s" in metrics
    e2e = set(metrics)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        metrics.add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert len(metrics) == len(b["end_to_end"]) + len(b["per_layer"])
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for cell in cells:
        mine = [m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in b["per_layer"])


def test_every_name_has_its_files(root):
    b = load(root)
    for m in b["end_to_end"] + b["per_layer"]:
        assert (root / "recall_bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in b["workloads"]:
        t = json.loads((root / "recall_bench" / "traffic" / f"{w['traffic']}.json").read_text())
        generator.check_traffic(t)
        limits = json.loads((root / "recall_bench" / "limits" / f"{w['name']}.json").read_text())
        assert set(limits["limits"]) == {"row_gap", "rank_gap", "unanswered"}
    for c in b["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["assumed"]
        from omni_recall_tpu_torch.config import EngineOptions

        EngineOptions(**cfg["engine"])


def test_a_full_check_fits(root):
    """A full check at 24 cells: 2 + 14 runs a cell, each the window and 60 s,
    180 s a cell to compile, 1200 s spare, within 12 hours."""
    seconds = load(root)["run_seconds"]
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
