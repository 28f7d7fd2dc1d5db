"""The benchmark's own frozen copy of the synthetic corpus recipe.

Plain NumPy; it imports nothing of the program, so the reference and the
program read the same inputs and the recipe cannot move with the program.
It is the integer recipe of the port's ``index/compact.py`` with varied
cluster radii (``make_tables(..., spread=True)``) as
``tools/e2e_engine.py build_e2e_engine`` lays it out:

- C = max(min_clusters, n // rows_per_cluster) clusters; int8 centers with
  amplitude 90 and int8 noise rows (4096 of them) with amplitude 22 scaled
  by a factor in [0.3, 1] linear in the noise row;
- row i is q8 = center8[cid(i)] + noise8[nid(i)], with cid = (i * 2654435761
  mod 2^32) mod C and nid = (i * 40503 + 2531) mod 4096, stored as the unit
  f32 row fl32(q8 * scale), scale = fl32(1 / sqrt(sum q8^2)) from the exact
  integer sum of squares through an f64 square root;
- the row's content is its cluster's ``"topic c{cid:05d}x synthetic chunk"``;
- its created day is ``linspace(0, days, n)`` rounded to 3 decimals (f32),
  held as exact integer millidays.

The tables are drawn from the run's seed, so every seed serves another
corpus with the same statistics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CID_MULT = np.uint32(2654435761)
NID_MULT, NID_ADD = 40503, 2531
SLAB_ROWS = 1 << 18


@dataclass
class Corpus:
    emb: np.ndarray           # f32 [n, d] unit rows
    assign: np.ndarray        # i64 [n] cluster of each row
    scale: np.ndarray         # f32 [n]
    center8: np.ndarray       # i8 [C, d]
    noise8: np.ndarray        # i8 [K, d]
    centers: np.ndarray       # f32 [C, d] unit cluster centers (the queries' geometry)
    contents: list            # str [C], one a cluster
    created_days: np.ndarray  # f32 [n], 3 decimals
    millidays: np.ndarray     # i64 [n], the exact created instants
    days: float               # the span of the created days; "now" is its end
    slab_rows: int

    @property
    def n(self) -> int:
        return self.emb.shape[0]


def n_clusters(spec: dict) -> int:
    return max(spec["min_clusters"], spec["rows"] // spec["rows_per_cluster"])


def make_tables(n_clusters: int, d: int, seed: int, noise_rows: int = 4096,
                amp_center: int = 90, amp_noise: int = 22, spread: bool = True):
    """int8 cluster centers [C, d] and noise rows [K, d]."""
    if amp_center + amp_noise > 127:
        raise ValueError("amp_center + amp_noise must stay <= 127 (one wrap-free int8 add)")
    rng = np.random.default_rng(seed)
    center8 = rng.integers(-amp_center, amp_center + 1, size=(n_clusters, d),
                           dtype=np.int16).astype(np.int8)
    noise16 = rng.integers(-amp_noise, amp_noise + 1, size=(noise_rows, d), dtype=np.int16)
    if spread:
        fac = 0.3 + 0.7 * np.arange(noise_rows) / max(1, noise_rows - 1)
        noise16 = np.rint(noise16 * fac[:, None]).astype(np.int16)
    return center8, noise16.astype(np.int8)


def row_ids(lo: int, hi: int, n_clusters: int, noise_rows: int):
    """(cid, nid) of rows [lo, hi), in numpy's wrapping uint32 arithmetic."""
    if noise_rows & (noise_rows - 1):
        raise ValueError("noise_rows must be a power of two")
    i = np.arange(lo, hi, dtype=np.uint32)
    cid = (i * CID_MULT) % np.uint32(n_clusters)
    nid = (i * np.uint32(NID_MULT) + np.uint32(NID_ADD)) & np.uint32(noise_rows - 1)
    return cid.astype(np.int64), nid.astype(np.int64)


def slab_rows_for(n: int) -> int:
    """2^18 rows, else the largest power of two at most 2^(bit_length - 4)
    that divides n (the device fill runs one shape a slab)."""
    slab = SLAB_ROWS
    if n % slab:
        slab = max(1, 1 << (n.bit_length() - 4))
        while n % slab:
            slab //= 2
    return slab


def unit_rows(center8: np.ndarray, noise8: np.ndarray, n: int, slab_rows: int):
    """(emb f32 [n, d], assign i64 [n], scale f32 [n])."""
    d = center8.shape[1]
    emb = np.empty((n, d), dtype=np.float32)
    s2 = np.empty(n, dtype=np.float32)
    assign = np.empty(n, dtype=np.int64)
    q8 = np.empty((slab_rows, d), dtype=np.int8)
    tmp8 = np.empty((slab_rows, d), dtype=np.int8)
    for lo in range(0, n, slab_rows):
        cid, nid = row_ids(lo, lo + slab_rows, center8.shape[0], noise8.shape[0])
        np.take(center8, cid, axis=0, out=q8, mode="clip")
        np.take(noise8, nid, axis=0, out=tmp8, mode="clip")
        q8 += tmp8
        e = emb[lo:lo + slab_rows]
        np.copyto(e, q8, casting="unsafe")
        # exact: every element and every row sum of squares is below 2^24
        np.einsum("ij,ij->i", e, e, out=s2[lo:lo + slab_rows])
        assign[lo:lo + slab_rows] = cid
    scale = (1.0 / np.sqrt(np.where(s2 > 0, s2, 1.0).astype(np.float64))).astype(np.float32)
    emb *= scale[:, None]
    return emb, assign, scale


def unit_centers(center8: np.ndarray) -> np.ndarray:
    centers = center8.astype(np.float32)
    centers /= np.sqrt(np.einsum("ij,ij->i", centers, centers))[:, None].astype(np.float32)
    return centers


def cluster_contents(n_clusters: int) -> list:
    return [f"topic c{cid:05d}x synthetic chunk" for cid in range(n_clusters)]


def cluster_token(cluster: int) -> str:
    """The keyword a query of ``cluster`` carries: a substring of exactly
    that cluster's content."""
    return f"c{cluster:05d}x"


def make_corpus(spec: dict, seed: int) -> Corpus:
    """The corpus a configuration's ``corpus`` block describes, from ``seed``."""
    n, d = spec["rows"], spec["dim"]
    c = n_clusters(spec)
    center8, noise8 = make_tables(c, d, seed, spec["noise_rows"], spec["amp_center"],
                                  spec["amp_noise"], spec["spread"])
    slab = slab_rows_for(n)
    emb, assign, scale = unit_rows(center8, noise8, n, slab)
    created_days = np.round(np.linspace(0.0, spec["days"], n), 3).astype(np.float32)
    millidays = np.round(created_days.astype(np.float64) * 1000.0).astype(np.int64)
    return Corpus(emb=emb, assign=assign, scale=scale, center8=center8, noise8=noise8,
                  centers=unit_centers(center8), contents=cluster_contents(c),
                  created_days=created_days, millidays=millidays, days=float(spec["days"]),
                  slab_rows=slab)
