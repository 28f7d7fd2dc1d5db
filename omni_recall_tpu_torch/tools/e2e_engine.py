"""The end-to-end bench's corpus and certified engine at scale (counterpart of
the repository's ``bench.py build_e2e_engine``).

The corpus is the deterministic integer recipe of ``index/compact.py`` with
heterogeneous cluster radii (``make_tables(C, d, spread=True)``, C =
max(4096, n // 64) clusters, about 64 rows a cluster):

- row i is fl32(q8 * scale) with q8 = center8[cid] + noise8[nid] (the ids of
  ``row_ids_np``) and scale = fl32(1 / sqrt(sum q8^2)) through an f64 sqrt
  of the exact f32 sum of squares: unit rows to about 1e-7;
- its content is ``"topic c{cid:05d}x synthetic chunk"`` and its bloom row
  the real signature of that content (one a cluster, by the native batch
  signature function where it loads);
- its created day is ``linspace(0, 365, n)`` rounded to 3 decimals, and the
  aux columns of ``bulk_load`` (created micros and timestamps, seqs, the
  lowercased arena) are derived from the rounded day, bitwise what the
  records give.

The host side builds those mirrors and ``bulk_load``s them. The device side
does not upload the [n, d] f32 rows: it uploads the two int8 tables and the
scale column, fills the raw plane slab by slab with ``rows_torch(...) *
scale``, quantizes it with ``device_quantize`` (keeping the raw plane for
the device-exact cosine when ``dd``), gathers the bloom plane from the
cluster signatures, makes pad rows past n dead, and installs the planes with
``DeviceIndex.install_device_planes``: the same bits the standard upload
would give, which the build checks on the first 256 raw rows.

The bench reads its switches from the environment; here they are keyword
arguments with the bench's defaults. Everything runs on CUDA unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import time
from datetime import timedelta

import numpy as np
import torch

from omni_recall_tpu_torch.index import compact

BIG_N = 1 << 20      # from here on the bench serves its measured layout
BIG_LAYOUT = (1024, 2)
SLAB_ROWS = 1 << 18
PROBE_ROWS = 256     # raw rows the build holds to the host mirror


def n_clusters_for(n: int) -> int:
    return max(4096, n // 64)


def slab_rows_for(n: int) -> int:
    """The bench's fill slab: 2^18 rows, else the largest power of two at
    most 2^(bit_length - 4) that divides n."""
    slab = SLAB_ROWS
    if n % slab != 0:
        slab = max(1, 1 << (n.bit_length() - 4))
        while n % slab:
            slab //= 2
    return slab


def unit_centers(center8: np.ndarray) -> np.ndarray:
    """The queries' geometry: the f32 cluster centers scaled to unit length."""
    centers = center8.astype(np.float32)
    centers /= np.sqrt(np.einsum("ij,ij->i", centers, centers))[:, None].astype(np.float32)
    return centers


def cluster_contents(n_clusters: int) -> list[str]:
    """Fixed-width contents (zero-padded cluster id): the arena builds as one
    gather, and a query carries the same token."""
    return [f"topic c{cid:05d}x synthetic chunk" for cid in range(n_clusters)]


def bench_options(n: int, d: int, bits: int, *, dd: bool = True, direct_select: bool = True,
                  coarse_sub: int | None = None, coarse_t: int | None = None,
                  select_t_out: int = 0):
    """The bench's engine options: int8 scan with the refine planes, the
    device-exact cosine when ``dd``, and (1024, 2) as the coarse layout from
    2^20 rows on (below it the engine's own layout)."""
    from omni_recall_tpu_torch.config import EngineOptions

    big = n >= BIG_N
    return EngineOptions(
        backend="pallas", embedding_dim=d, recent_window=0,
        candidate_m=128, bloom_bits=bits, scan_dtype="int8",
        capacity_block=max(8192, n // 64),
        device_exact_cos=dd,
        direct_select=direct_select,
        coarse_sub=(BIG_LAYOUT[0] if big else 0) if coarse_sub is None else coarse_sub,
        coarse_t=(BIG_LAYOUT[1] if big else 0) if coarse_t is None else coarse_t,
        select_t_out=select_t_out,
    )


def host_rows(n: int, d: int, center8: np.ndarray, noise8: np.ndarray, slab_rows: int,
              checkpoint=None):
    """(emb f32 [n, d] unit rows, assign i64 [n], scale f32 [n]) by the
    bench's slab loop."""
    n_clusters, noise_k = center8.shape[0], noise8.shape[0]
    emb = np.empty((n, d), dtype=np.float32)
    s2f = np.empty(n, dtype=np.float32)
    assign = np.empty(n, dtype=np.int64)
    q8buf = np.empty((slab_rows, d), dtype=np.int8)
    tmp8 = np.empty((slab_rows, d), dtype=np.int8)
    for s0 in range(0, n, slab_rows):
        s1 = s0 + slab_rows
        cid, nid = compact.row_ids_np(s0, s1, n_clusters, noise_k)
        # mode="clip": the ids are in range by construction, and the
        # default checked path is far slower with out=
        np.take(center8, cid, axis=0, out=q8buf, mode="clip")
        np.take(noise8, nid, axis=0, out=tmp8, mode="clip")
        q8buf += tmp8  # wrap-free by the make_tables amplitude invariant
        e = emb[s0:s1]
        np.copyto(e, q8buf, casting="unsafe")  # int8 -> f32, exact
        # exact f32 sum of squares (row sums < 2^24, index/compact.py)
        np.einsum("ij,ij->i", e, e, out=s2f[s0:s1])
        assign[s0:s1] = cid
        if checkpoint is not None:
            checkpoint()
    scale = (1.0 / np.sqrt(np.where(s2f > 0, s2f, 1.0).astype(np.float64))).astype(np.float32)
    emb *= scale[:, None]  # rows = fl32(q8 * scale)
    return emb, assign, scale


def bench_centers(n: int, d: int) -> np.ndarray:
    """The unit cluster centers of the n-row corpus (its queries' geometry)."""
    return unit_centers(compact.make_tables(n_clusters_for(n), d, spread=True)[0])


def records(n: int, emb: np.ndarray, assign: np.ndarray, contents: list[str],
            created_days: np.ndarray) -> list:
    """The corpus's ChunkRecords; their datetimes come from the rounded
    days."""
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.index.records import ChunkRecord

    day_cache: dict = {}
    meta = []
    for i in range(n):
        day = round(float(created_days[i]), 3)
        when = day_cache.get(day)
        if when is None:
            when = day_cache[day] = EPOCH + timedelta(days=day)
        meta.append(ChunkRecord(
            id=f"s:{i}", document_id="synthetic", chunk_index=i, content=contents[assign[i]],
            embedding=emb[i], created_at_utc=when, seq=i,
        ))
    return meta


def aux_columns(n: int, assign: np.ndarray, contents: list[str],
                created_days: np.ndarray) -> dict:
    """``bulk_load``'s aux columns, vectorized: the created micros are the
    exact integers of the rounded days (millidays * 86.4e6) and the
    timestamps f64(micros) / 1e6, bitwise what the records give."""
    from omni_recall_tpu_torch.index.device_index import EPOCH, to_micros

    millidays = np.round(created_days.astype(np.float64) * 1000.0).astype(np.int64)
    aux_us = to_micros(EPOCH) + millidays * 86_400_000
    fixed = np.array(contents, dtype="S")
    return {
        "created_us": aux_us,
        "created_ts": aux_us.astype(np.float64) / 1e6,
        "seqs": np.arange(n, dtype=np.int64),
        "lower_arena": fixed[assign].tobytes(),
        "lower_off": np.arange(n + 1, dtype=np.int64) * fixed.dtype.itemsize,
    }


def cluster_signatures(contents: list[str], dix) -> np.ndarray:
    """One bloom signature a cluster, with the index's own bloom parameters
    (or the device keyword score is not a sound bound)."""
    from omni_recall_tpu_torch.ops import hashing, native

    sigs = native.chunk_signatures([c.lower().encode() for c in contents],
                                   dix.bloom_bits, dix.ngram, dix.bloom_hashes)
    if sigs is None:
        sigs = np.stack([hashing.chunk_signature(c.lower(), dix.bloom_bits, dix.ngram,
                                                 dix.bloom_hashes) for c in contents])
    return sigs


def device_planes(dix, n: int, center8: np.ndarray, noise8: np.ndarray, scale: np.ndarray,
                  sigs: np.ndarray, assign: np.ndarray, slab_rows: int, dd: bool,
                  checkpoint=None):
    """The index's planes generated on its device from the integer tables:
    the DeviceArrays the standard upload plus ``device_quantize`` would give
    from the host mirrors."""
    from omni_recall_tpu_torch.index.device_index import DeviceArrays, device_quantize

    dev = dix.device
    cap, d = dix._cap, center8.shape[1]
    n_clusters, noise_k = center8.shape[0], noise8.shape[0]
    c8 = torch.from_numpy(center8).to(dev)
    n8 = torch.from_numpy(noise8).to(dev)
    sc = torch.from_numpy(scale).to(dev)
    raw = torch.zeros((cap, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, slab_rows):
        q8 = compact.rows_torch(lo, slab_rows, c8, n8, n_clusters, noise_k)
        # one rounding a product (int8 -> f32 is exact): the host's bits
        torch.mul(q8.to(torch.float32), sc[lo:lo + slab_rows, None],
                  out=raw[lo:lo + slab_rows])
        del q8
        if checkpoint is not None:
            checkpoint()
    del c8, n8, sc
    conv = device_quantize(raw, refine=dix.refine)
    if not dd:
        raw = None
    pad_assign = torch.zeros(cap, dtype=torch.int64)
    pad_assign[:n] = torch.from_numpy(assign)
    bloom = torch.from_numpy(sigs).to(dev).index_select(0, pad_assign.to(dev))
    # pad rows are dead on the device: valid False (the host column) and
    # bloom zero (the gather gave them cluster 0's signature)
    bloom[n:] = 0
    return DeviceArrays(
        emb=conv["emb"], bloom=bloom,
        created=torch.from_numpy(dix.created).to(dev, copy=True),
        valid=torch.from_numpy(dix.valid).to(dev, copy=True),
        scale=conv.get("scale"), err=conv.get("err"),
        emb2=conv.get("emb2"), scale2=conv.get("scale2"), err2=conv.get("err2"),
        raw=raw,
    )


def build_e2e_engine(n: int, d: int, bits: int, checkpoint=None, *, device="cuda",
                     dd: bool = True, direct_select: bool = True,
                     coarse_sub: int | None = None, coarse_t: int | None = None,
                     select_t_out: int = 0, timings: dict | None = None, options=None):
    """Build the bench's corpus and a certified-exact engine over it.
    Returns (engine, make_requests(seed, nb), now, opts); the engine carries
    ``bench_n_clusters`` and ``bench_corpus`` (meta, contents, assign, emb:
    references, not copies). ``checkpoint`` (no arguments) is called after
    each slab of the host build and of the device fill. ``timings`` (if
    given) receives the host build's, the records' and the device planes'
    seconds. ``options`` (``EngineOptions``) replaces the bench's; an index
    stored other than in int8 takes the standard upload of the host rows."""
    from omni_recall_tpu_torch.device import resolve_device
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine

    dev = resolve_device(device)
    timings = timings if timings is not None else {}
    t0 = time.perf_counter()
    n_clusters = n_clusters_for(n)
    center8, noise8 = compact.make_tables(n_clusters, d, spread=True)
    slab_rows = slab_rows_for(n)
    emb, assign, scale = host_rows(n, d, center8, noise8, slab_rows, checkpoint)
    centers = unit_centers(center8)
    contents = cluster_contents(n_clusters)
    # 3-decimal days: the records' datetimes and the device created column
    # must encode the same instant (snapshot restore's integrity sample
    # compares them)
    created_days = np.round(np.linspace(0.0, 365.0, n), 3).astype(np.float32)
    t1 = time.perf_counter()
    meta = records(n, emb, assign, contents, created_days)
    timings["records_s"] = time.perf_counter() - t1
    aux = aux_columns(n, assign, contents, created_days)
    opts = options if options is not None else bench_options(
        n, d, bits, dd=dd, direct_select=direct_select, coarse_sub=coarse_sub,
        coarse_t=coarse_t, select_t_out=select_t_out)
    engine = RecallEngine(InMemoryIngestionStore(), options=opts, device=dev)
    dix = engine.device_index
    sigs = cluster_signatures(contents, dix)
    # exact fit (capacity == n): the emb array is adopted for both mirrors
    dix.bulk_load(emb, sigs[assign], created_days, meta, aux=aux)
    timings["host_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if dix.scan_dtype != "int8":
        dix.device_arrays()
    else:
        planes = device_planes(dix, n, center8, noise8, scale, sigs, assign, slab_rows,
                               dix.exact_cos, checkpoint)
        if checkpoint is not None:
            checkpoint()
        dix.install_device_planes(planes)
        if dix.exact_cos:
            probe = min(PROBE_ROWS, n)
            if not np.array_equal(planes.raw[:probe].cpu().numpy(), emb[:probe]):
                raise AssertionError("device-generated raw plane diverges from the host mirror")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timings["device_s"] = time.perf_counter() - t0

    def make_requests(seed: int, nb: int):
        """nb queries, each near a cluster center, its text the cluster's
        token (the bench's draws: the same seed gives the same requests)."""
        r = np.random.default_rng(seed)
        reqs = []
        for _ in range(nb):
            cluster = int(r.integers(n_clusters))
            qn = r.standard_normal(d).astype(np.float32)
            qn /= np.linalg.norm(qn)
            q = centers[cluster] + 0.2 * qn
            q /= np.linalg.norm(q)
            reqs.append((f"c{cluster:05d}x", q, 10))
        return reqs

    engine.bench_n_clusters = n_clusters
    engine.bench_corpus = {"meta": meta, "contents": contents, "assign": assign, "emb": emb}
    now = EPOCH + timedelta(days=365.0)
    return engine, make_requests, now, opts
