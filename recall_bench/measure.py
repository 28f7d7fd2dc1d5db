"""The benchmark's frozen measurement arithmetic: percentiles over every
request, rates over the whole window, roofline bounds from shapes and the
H100's published peaks, and the idle share from device intervals."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates (the card's power limit is printed
# beside every reading)
PEAK = {
    "int8": 1979e12,   # TOP/s
    "bf16": 989e12,    # FLOP/s
    "tf32": 495e12,
    "f32": 67e12,      # outside the tensor cores
}
HBM_BYTES_S = 3.35e12


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, interpolated linearly
    between order statistics (numpy's default rule)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        raise ValueError("no values")
    pos = (v.size - 1) * q / 100.0
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.size - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds


def per_query(stats0: dict, stats1: dict, key: str):
    """A program counter's growth over the window per query searched
    (``searches_total``); None where no query was searched."""
    q = stats1["searches_total"] - stats0["searches_total"]
    return (stats1[key] - stats0[key]) / q if q else None


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the HBM rate."""
    return max(ops / PEAK[peak], nbytes / HBM_BYTES_S)


def coarse_scan_work(n: int, d: int, b: int, sub: int, t: int) -> tuple[float, float]:
    """K1's (operations, bytes): the int8 cosine product 2·N·d·B, and its
    inputs read once (int8 rows, the f32 scale and add-row columns, the int8
    queries with their f32 scale and bias) and its outputs written once
    (f32 value and i32 row of t candidates a slice of ``sub`` rows a query)."""
    ops = 2.0 * n * d * b
    nbytes = n * d + 8.0 * n + b * d + 8.0 * b + 8.0 * b * (n // sub) * t
    return ops, nbytes


def xla_scan_work(n: int, d: int, b: int, w: int) -> tuple[float, float]:
    """The plain-torch scan's (operations, bytes): the cosine product alone,
    2·N·d·B in f32, and the f32 rows and bloom bytes read once."""
    return 2.0 * n * d * b, 4.0 * n * d + float(n) * w


def merge(intervals, lo: float, hi: float) -> list:
    """The union of [start, end) intervals clipped to [lo, hi), sorted and
    disjoint."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The complement of disjoint sorted ``busy`` intervals in [lo, hi)."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def intersect(a: list, b: list) -> list:
    """The intervals two sorted disjoint interval lists share."""
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap(a: list, b: list) -> float:
    """Total length shared by two sorted disjoint interval lists."""
    return float(sum(e - s for s, e in intersect(a, b)))


def idle_share(busy_s: float, window_s: float) -> float:
    """Percent of the window with no kernel or copy on the card."""
    return 100.0 * (1.0 - busy_s / window_s)
