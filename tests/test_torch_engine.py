"""The port's RecallEngine against the JAX RecallEngine and the oracle.

Both engines serve the same index state: the JAX engine builds an int8
``DeviceIndex(refine=False, exact_cos=True)`` from the records, and the
port's index is made from that index's planes and records with
``DeviceIndex.from_numpy_planes``. Both run the slice's configuration
(``backend="pallas"``, int8 scan, coarse prepass, direct selection,
device-exact cosine); on the CPU the JAX side runs its Pallas kernels in
interpret mode and the port its plain PyTorch versions. Results must be
DTO-identical — the same chunk ids in the same order with the same
``round(score, 4)`` — to each other and to ``backend="oracle"``.
"""

import dataclasses
import random
import string
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from omni_recall_tpu.config import EngineOptions as JOptions
from omni_recall_tpu.index.device_index import DeviceIndex as JIndex
from omni_recall_tpu.index.records import ChunkRecord as JChunk
from omni_recall_tpu.index.records import DocumentRecord as JDoc
from omni_recall_tpu.index.store import InMemoryIngestionStore as JStore
from omni_recall_tpu.search.engine import RecallEngine as JEngine
from omni_recall_tpu_torch.config import EngineOptions as TOptions
from omni_recall_tpu_torch.index.device_index import PLANES
from omni_recall_tpu_torch.index.device_index import DeviceIndex as TIndex
from omni_recall_tpu_torch.index.records import ChunkRecord as TChunk
from omni_recall_tpu_torch.index.records import DocumentRecord as TDoc
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore as TStore
from omni_recall_tpu_torch.search.engine import RecallEngine as TEngine

DIM = 64
BITS = 1024
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
SLICE = dict(
    backend="pallas", scan_dtype="int8", embedding_dim=DIM, capacity_block=4096,
    candidate_m=32, bloom_bits=BITS, recent_window=0, device_exact_cos=True,
    direct_select=True, refine=False,
)


def _corpus(seed: int, n: int, near_ties: bool = False):
    """Clustered unit embeddings (64 rows per cluster) with cluster-token
    contents. ``near_ties``: every row of a cluster is the same vector and
    text, so scores tie exactly and certificates cannot separate them."""
    rng = np.random.default_rng(seed)
    n_clusters = max(8, n // 64)
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32)
    words = ["".join(random.Random(seed + i).choices(string.ascii_lowercase, k=6))
             for i in range(n_clusters)]
    toks = ["".join(random.Random(10_000 * seed + i).choices(string.ascii_lowercase, k=8))
            for i in range(n)]
    rows = []
    for i in range(n):
        c = int(rng.integers(n_clusters))
        v = centers[c] if near_ties else centers[c] + 0.3 * rng.standard_normal(DIM).astype(np.float32)
        text = f"topic {words[c]} chunk" if near_ties else f"topic {words[c]} {toks[i]}"
        rows.append((text, v.astype(np.float32).tolist(), T0 + timedelta(minutes=i // 4)))
    return rows, centers, words, toks


def _stores(rows):
    """The same records in a JAX store and a port store (same seqs)."""
    out = []
    for store_cls, doc_cls, chunk_cls in ((JStore, JDoc, JChunk), (TStore, TDoc, TChunk)):
        store = store_cls()
        store.upsert_document(doc_cls(id="d", file_name="d.txt", created_at_utc=T0))
        chunks = [
            chunk_cls(id=f"d:{i:05d}", document_id="d", chunk_index=i, content=text,
                      embedding=emb, created_at_utc=ts)
            for i, (text, emb, ts) in enumerate(rows)
        ]
        store.upsert_chunks(chunks)
        out.append((store, chunks))
    return out


def _engines(rows, **overrides):
    (jstore, jchunks), (tstore, tchunks) = _stores(rows)
    opts = {**SLICE, **overrides}
    jdix = JIndex(DIM, capacity_block=opts["capacity_block"], bloom_bits=BITS,
                  ngram=4, bloom_hashes=2, scan_dtype="int8", refine=False,
                  exact_cos=True)
    jeng = JEngine(jstore, jdix, JOptions(**opts))
    jeng.on_chunks_upserted(jchunks, new=True)
    dev = jdix.device_arrays()
    planes = {k: np.asarray(getattr(dev, k)) for k in PLANES
              if getattr(dev, k) is not None}
    by_id = {c.id: c for c in tchunks}
    meta = [None if m is None else by_id[m.id] for m in jdix.meta]
    tdix = TIndex.from_numpy_planes(planes, meta, device="cpu",
                                    capacity_block=opts["capacity_block"],
                                    bloom_bits=BITS, ngram=4, bloom_hashes=2)
    teng = TEngine(tstore, tdix, TOptions(**opts))
    toracle = TEngine(tstore, None, TOptions(backend="oracle", recent_window=0),
                      device="cpu")
    return jeng, teng, toracle


def _dto(hits):
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


def _requests(centers, words, count, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(count):
        c = int(rng.integers(len(centers)))
        q = centers[c] + 0.2 * rng.standard_normal(DIM).astype(np.float32)
        reqs.append((words[c], q.tolist(), int(rng.choice([1, 3, 10]))))
    return reqs


def _kw_requests(toks, count, seed):
    """Explicit empty vectors; each query names three rows' unique tokens."""
    rng = np.random.default_rng(seed)
    return [
        (" ".join(toks[j] for j in rng.choice(len(toks), 3, replace=False)), [],
         int(rng.choice([1, 2, 3])))
        for _ in range(count)
    ]


def _assert_same(jeng, teng, toracle, reqs):
    jres = jeng.search_batch(reqs, now=NOW)
    tres = teng.search_batch(reqs, now=NOW)
    for (q, emb, k), jh, th in zip(reqs, jres, tres):
        expected = _dto(toracle.search(q, emb, k, now=NOW))
        assert _dto(th) == _dto(jh)
        assert _dto(th) == expected
        assert len(th) == min(k, len(expected))


@pytest.fixture(scope="module")
def clustered():
    return _corpus(21, 3000)


def test_embedding_queries_coarse_direct_dd(clustered):
    """K1 -> direct selection -> K2 -> DD certificate."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 12, 1))
    assert teng.stats["coarse_resolved_total"] > 0
    assert teng.stats["dd_resolved_total"] > 0
    for key in ("coarse_resolved_total", "dd_resolved_total", "host_fallbacks_total"):
        assert teng.stats[key] == jeng.stats[key], key


def test_fused_scan_serves_without_coarse_prepass(clustered):
    """coarse_prepass=False: every embedding query goes to the fused K4."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows, coarse_prepass=False)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 10, 2))
    assert teng.stats["coarse_resolved_total"] == 0
    assert teng.stats["escalation_rounds_total"] == jeng.stats["escalation_rounds_total"]


def test_empty_query_vectors_take_keyword_scan(clustered):
    """Explicit empty vectors: keyword-only scan (K5), cosine exactly 0."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _engines(rows)
    reqs = _kw_requests(toks, 10, 3)
    _assert_same(jeng, teng, toracle, reqs)
    assert teng.stats["kw_only_resolved_total"] > 0
    assert teng.stats["kw_only_resolved_total"] == jeng.stats["kw_only_resolved_total"]


def test_near_tie_corpus_escalates_to_oracle_fill():
    rows, centers, words, _ = _corpus(22, 1500, near_ties=True)
    jeng, teng, toracle = _engines(rows)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 6, 4))
    assert teng.stats["host_fallbacks_total"] > 0
    assert teng.stats["host_fallbacks_total"] == jeng.stats["host_fallbacks_total"]


def test_pipelined_batches_and_mixed_requests(clustered):
    """search_batches_pipelined over mixed batches (vectors, empty vectors,
    a dim-mismatched vector routed to the host scan) equals search_batch."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _engines(rows)
    a = _requests(centers, words, 6, 5)
    b = _kw_requests(toks, 4, 6) + [("chunk", [0.5, 0.5], 3)]
    piped = teng.search_batches_pipelined([a, b], now=NOW)
    for reqs, got in zip((a, b), piped):
        jres = jeng.search_batch(reqs, now=NOW)
        assert [_dto(h) for h in got] == [_dto(h) for h in jres]
        for (q, emb, k), h in zip(reqs, got):
            assert _dto(h) == _dto(toracle.search(q, emb, k, now=NOW))


def test_options_the_port_cannot_serve_raise():
    store = TStore()
    for bad in (dict(backend="xla"), dict(scan_dtype="bf16"), dict(refine=True),
                dict(shards=2)):
        opts = dataclasses.replace(TOptions(embedding_dim=DIM), **bad)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(store, None, opts, device="cpu")


def test_full_width_certificate_without_direct_select(clustered):
    """direct_select=False: no compact slice; the host certifies the full
    [B, m+1] scan candidates (no DD), as the JAX engine does without
    residual planes."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows, direct_select=False)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 8, 7))
    assert teng.stats["dd_resolved_total"] == 0
    assert teng.stats["coarse_resolved_total"] == jeng.stats["coarse_resolved_total"] > 0


def test_coalesced_concurrent_searches_equal_serial(clustered):
    """The coalescing executor (search/coalesce.py) batches concurrent
    requests through dispatch/finalize; every caller gets its own result."""
    import threading

    from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor

    rows, centers, words, toks = clustered
    _, teng, toracle = _engines(rows)
    reqs = _requests(centers, words, 10, 8) + _kw_requests(toks, 6, 9)
    ex = CoalescingSearchExecutor(teng, window_ms=20.0, max_batch=64)
    got: dict[int, list] = {}

    def run(i, q, emb, k):
        got[i] = _dto(ex.search(q, emb, k, now=NOW))

    threads = [threading.Thread(target=run, args=(i, *r)) for i, r in enumerate(reqs)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        ex.close()
    for i, (q, emb, k) in enumerate(reqs):
        assert got[i] == _dto(toracle.search(q, emb, k, now=NOW))
    assert teng.stats["searches_total"] == len(reqs)
