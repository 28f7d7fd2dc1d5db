"""The comparison that decides ``correct``.

Three numbers, each against the limit of the cell (``limits/<cell>.json``):

- ``row_gap``: over every answer served in the run, the largest distance
  between a served score and the reference's exact score of the row it
  names; an answer with another number of hits than k counts ``MISSING``.
  A wrong id, a wrong score, a short answer: each shows here.
- ``rank_gap``: over a sample of the pool's requests drawn from the seed,
  every answer served for them against the reference's full scan of every
  row: the largest distance, rank by rank, between the served score and the
  reference's k best; a hit missing from an answer (or one too many) counts
  ``MISSING``. A row the certificate wrongly kept or dropped shows here.
- ``unanswered``: requests of the window that raised or were never
  answered, a minute past the close at most. Exact: limit 0.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MISSING = 1.0   # a hybrid score lies in [-0.7, 1]: a gap no rounding reaches


def _served(cols: dict, k: int):
    """(pool index, row, score) of every hit of every good answer."""
    good = cols["hits"] >= 0
    n = np.minimum(cols["hits"][good], k + 1)
    mask = np.arange(k + 1)[None, :] < n[:, None]
    return (np.repeat(cols["q"][good], n), cols["rows"][good][mask],
            cols["scores"][good][mask])


def row_gap(ref, requests: list, cols: dict, k: int) -> float:
    """``cols``: every served answer (``load.Answers.columns``)."""
    if not cols:
        return 0.0
    good = cols["hits"] >= 0
    if np.any(cols["hits"][good] != k):
        return MISSING
    qidx, rows, served = _served(cols, k)
    if rows.size == 0:
        return 0.0
    key = qidx * ref.c.n + rows
    uniq, inv = np.unique(key, return_inverse=True)
    exact = ref.pair_scores(requests, uniq // ref.c.n, uniq % ref.c.n)
    return float(np.max(np.abs(served - exact[inv])))


def rank_gap(expected: dict, cols: dict, k: int) -> float:
    """``expected``: pool index -> (rows, exact scores) of the reference's
    top k; every answer of a sampled request is held to it."""
    gap = 0.0
    if not cols:
        return gap
    for i in np.nonzero(np.isin(cols["q"], list(expected)) & (cols["hits"] >= 0))[0]:
        want = expected[int(cols["q"][i])][1]
        h = int(cols["hits"][i])
        n = min(len(want), h)
        if n:
            gap = max(gap, float(np.max(np.abs(cols["scores"][i, :n] - want[:n]))))
        if h != len(want):
            gap = max(gap, MISSING)
    return gap


def draw_sample(seed: int, answered: list, size: int) -> list:
    """Pool indices to hold to the full scan, drawn from the seed among the
    requests that were answered."""
    pool = sorted(set(answered))
    r = np.random.default_rng([int(seed), 2])
    if len(pool) <= size:
        return pool
    return sorted(r.choice(pool, size=size, replace=False).tolist())


def load_limits(root: Path, cell: str) -> dict:
    with open(root / "recall_bench" / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) with every number at or under its
    limit."""
    checks = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
