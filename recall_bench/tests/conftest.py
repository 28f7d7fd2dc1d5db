"""Shared helpers of the benchmark's CPU tests: the cells cut to a size the
CPU runs in seconds (the same code paths, the port's plain versions)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def tiny(cell_name: str, rows: int = 8192, dim: int | None = None):
    from recall_bench import run

    cell = run.load_cell(ROOT, cell_name)
    cfg = json.loads(json.dumps(cell.config))
    cfg["corpus"]["rows"] = rows
    eng = cfg["engine"]
    if dim is not None:
        cfg["corpus"]["dim"] = eng["embedding_dim"] = dim
    if "capacity_block" in eng:
        eng["capacity_block"] = 8192
    eng.pop("coarse_sub", None)   # the engine picks its own layout below 2^20 rows
    eng.pop("coarse_t", None)
    traffic = dict(cell.traffic, clients=16, max_batch=8, requests=64, sample=8, ramp_s=0.3)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


@pytest.fixture
def root():
    return ROOT
