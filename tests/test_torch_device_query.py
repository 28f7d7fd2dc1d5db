"""The port's device-resident query pipeline (RecallEngine.attach_device_embedder)
on the CPU, mirroring tests/test_device_query.py.

With the local encoder attached, requests arriving without an embedding are
embedded inside the search dispatch; only their double-float self-norms come
back, and escalations materialize the exact rows lazily. Certificates are
relative to the materialized bits of the forward, so the port's own oracle
(backend "oracle", float64) is fed those same bits. A failure of the card in
the forward raises instead of degrading the queries to keyword-only scoring.
"""

import random
import string
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.ingest.embedding import LocalEncoderEmbeddingClient
from omni_recall_tpu_torch.models import hash_embedder
from omni_recall_tpu_torch.models.encoder import EncoderConfig
from omni_recall_tpu_torch.search.engine import RecallEngine

DIM = 32
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)

_CFG = EncoderConfig(vocab_size=512, d_model=32, n_layers=1, n_heads=2, d_ff=64,
                     max_len=32, out_dim=DIM)


def _client() -> LocalEncoderEmbeddingClient:
    return LocalEncoderEmbeddingClient(dim=DIM, cfg=_CFG, device="cpu")


def _options(dd=True, dim=DIM, **kw):
    return EngineOptions(backend="pallas", scan_dtype="int8", embedding_dim=dim,
                         capacity_block=128, candidate_m=16, bloom_bits=256,
                         recent_window=0, device_exact_cos=dd, **kw)


def _build(rng, n=240, dd=True, client=None):
    store = InMemoryIngestionStore()
    engine = RecallEngine(store, options=_options(dd), device="cpu")
    client = client or _client()
    engine.attach_device_embedder(client)
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0),
                                 device="cpu")
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8)))
             for _ in range(40)]
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    nrng = np.random.default_rng(97)
    chunks = []
    for i in range(n):
        emb = nrng.standard_normal(DIM).astype(np.float32)
        emb /= np.linalg.norm(emb)
        chunks.append(ChunkRecord(
            id=f"d:{i:04d}", document_id="d", chunk_index=i,
            content=" ".join(rng.choices(vocab, k=rng.randint(4, 15))), embedding=emb,
            created_at_utc=T0 + timedelta(minutes=i)))
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    return engine, oracle_engine, client, vocab, chunks


def _canonical(client, queries):
    """The forward's bits for an all-device-embedded batch: the engine calls
    embed_device on exactly this text list, and the CPU forward of the same
    shapes returns the same bits."""
    rows = client.embed_device(queries).numpy()
    return {q: rows[i] for i, q in enumerate(queries)}


def _assert_oracle_match(engine, oracle_engine, client, requests, exact_scores=False):
    texts = [q for q, emb, _ in requests if emb is None and q.strip()]
    canon = _canonical(client, texts) if texts else {}
    batch = engine.search_batch(requests, now=NOW)
    for (query, emb, k), hits in zip(requests, batch):
        if emb is None and query.strip():
            emb = canon[query].tolist()
        expected = oracle_engine.search(query, emb, k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected], query
        assert [round(h.score, 4) for h in hits] == [round(e.score, 4) for e in expected]
        for h, e in zip(hits, expected):
            assert abs(h.score - e.score) < 1e-8
            if exact_scores:
                assert h.score == e.score


def test_device_query_matches_oracle_on_canonical_bits():
    rng = random.Random(23)
    engine, oracle_engine, client, vocab, _ = _build(rng)
    queries = list(dict.fromkeys(" ".join(rng.choices(vocab, k=rng.randint(1, 3)))
                                 for _ in range(10)))
    _assert_oracle_match(engine, oracle_engine, client,
                         [(q, None, rng.choice([1, 3, 10])) for q in queries])
    assert engine.stats["dd_resolved_total"] > 0


def test_device_query_mixed_batch_host_vectors_and_keyword_only():
    """Device-embedded, explicit-vector and embedding-less queries in one
    batch: the assembly of device rows and uploaded host rows on the card."""
    rng = random.Random(29)
    engine, oracle_engine, client, vocab, _ = _build(rng)
    dev_queries = list(dict.fromkeys(" ".join(rng.choices(vocab, k=2)) for _ in range(4)))
    requests = [(q, None, 5) for q in dev_queries]
    requests.insert(1, (vocab[0], hash_embedder.embed_text("host-query", DIM), 5))
    requests.insert(3, (vocab[1], [], 5))
    _assert_oracle_match(engine, oracle_engine, client, requests)
    assert engine.stats["kw_only_resolved_total"] + engine.stats["host_fallbacks_total"] > 0


def test_device_query_escalation_materializes_exact_rows():
    """Rows planted with the query's own device embedding tie exactly at
    cosine 1: the DD certificate cannot rank them and escalates to the
    bit-exact host rescore, which must see the materialized rows."""
    rng = random.Random(31)
    engine, oracle_engine, client, vocab, chunks = _build(rng, n=240)
    queries = list(dict.fromkeys(" ".join(rng.choices(vocab, k=2)) for _ in range(4)))
    canon = _canonical(client, queries)
    extra = []
    for j, q in enumerate(queries):
        for t in range(2):
            extra.append(ChunkRecord(
                id=f"d:tie{j}{t}", document_id="d", chunk_index=len(chunks) + 2 * j + t,
                content=f"tied row {j}", embedding=canon[q].tolist(),
                created_at_utc=T0 + timedelta(hours=1)))
    engine.store.upsert_chunks(chunks + extra)
    engine.on_chunks_upserted(extra, new=True)
    _assert_oracle_match(engine, oracle_engine, client, [(q, None, 2) for q in queries])
    assert engine.stats["dd_escalations_total"] > 0


def test_device_query_without_dd_mode_stays_exact():
    """Without the device-exact cosine every candidate is host-rescored:
    each batch materializes its rows, and scores equal the oracle's bits."""
    rng = random.Random(37)
    engine, oracle_engine, client, vocab, _ = _build(rng, dd=False)
    queries = list(dict.fromkeys(" ".join(rng.choices(vocab, k=2)) for _ in range(6)))
    _assert_oracle_match(engine, oracle_engine, client, [(q, None, 5) for q in queries],
                         exact_scores=True)
    assert engine.stats["dd_resolved_total"] == 0


def test_attach_device_embedder_validation():
    store = InMemoryIngestionStore()
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0),
                                 device="cpu")
    with pytest.raises(ValueError):
        oracle_engine.attach_device_embedder(_client())
    with pytest.raises(ValueError):  # dim mismatch
        RecallEngine(store, options=_options(dim=DIM + 8),
                     device="cpu").attach_device_embedder(_client())
    dev = RecallEngine(store, options=_options(), device="cpu")
    client = _client()
    dev.attach_device_embedder(client)
    assert dev._device_embedder is client
    dev.attach_device_embedder(None)
    assert dev._device_embedder is None


def test_app_wires_device_query_for_local_provider():
    """Embeddings:Provider=Local and a device engine turn the pipeline on
    (the search service stops calling the host embed); DeviceQuery=false
    keeps host embeds."""
    from omni_recall_tpu_torch.config import AppConfig
    from omni_recall_tpu_torch.server.app import OmniRecallApp

    def config(device_query):
        cfg = AppConfig()
        cfg.embeddings.provider = "Local"
        cfg.embeddings.dim = cfg.engine.embedding_dim = DIM
        cfg.embeddings.device_query = device_query
        cfg.engine.backend, cfg.engine.scan_dtype = "pallas", "int8"
        cfg.engine.capacity_block = 128
        return cfg

    client = _client()
    app = OmniRecallApp(config(True), embedding_client=client, device="cpu")
    assert app.search_service.device_query is True
    assert app.engine._device_embedder is client
    app2 = OmniRecallApp(config(False), embedding_client=_client(), device="cpu")
    assert app2.search_service.device_query is False
    assert app2.engine._device_embedder is None


def test_search_service_device_query_skips_host_embed():
    from omni_recall_tpu_torch.search.service import RecallSearchService

    rng = random.Random(41)
    engine, _, client, vocab, _ = _build(rng, n=60)
    calls = {"embed": 0}
    orig = client.embed

    def counting_embed(text):
        calls["embed"] += 1
        return orig(text)

    client.embed = counting_embed
    resp = RecallSearchService(engine, client, device_query=True).search(vocab[0], 5, now=NOW)
    assert calls["embed"] == 0
    assert len(resp.citations) == 5


class _FailingForward(LocalEncoderEmbeddingClient):
    def __init__(self, exc):
        super().__init__(dim=DIM, cfg=_CFG, device="cpu")
        self.exc = exc

    def _forward(self, texts):
        raise self.exc


def test_a_device_error_in_the_forward_fails_the_search():
    """A CUDA error in the encoder's forward raises out of the search: it is
    never turned into keyword-only scoring."""
    rng = random.Random(43)
    client = _FailingForward(RuntimeError("CUDA error: an illegal memory access was encountered"))
    engine, _, _, vocab, _ = _build(rng, n=60, client=client)
    with pytest.raises(RuntimeError, match="CUDA error"):
        engine.search_batch([(vocab[0], None, 3)], now=NOW)
    with pytest.raises(RuntimeError, match="CUDA error"):
        client.embed(vocab[0])
    with pytest.raises(RuntimeError, match="CUDA error"):
        client.embed_batch([vocab[0], vocab[1]])


def test_a_forward_failing_on_its_input_degrades_to_keyword_only():
    """A forward that fails on its input (not on the card) keeps the
    reference's embed-failure semantics: the batch's queries score keyword
    and recency only, and the client answers an ERROR status."""
    rng = random.Random(47)
    client = _FailingForward(ValueError("bad token ids"))
    engine, oracle_engine, _, vocab, _ = _build(rng, n=60, client=client)
    requests = [(vocab[0], None, 3), (vocab[1] + " " + vocab[2], None, 3)]
    batch = engine.search_batch(requests, now=NOW)
    for (query, _, k), hits in zip(requests, batch):
        expected = oracle_engine.search(query, [], k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
    assert engine.stats["kw_only_resolved_total"] + engine.stats["host_fallbacks_total"] == 2
    result = client.embed(vocab[0])
    assert result.status.value == "error" and result.vector == []


def test_ingestion_lets_a_device_error_of_the_batch_embed_through():
    from omni_recall_tpu_torch.config import IngestionOptions
    from omni_recall_tpu_torch.index.store import InMemoryRawDocumentStore
    from omni_recall_tpu_torch.ingest.service import DocumentIngestionService

    client = _FailingForward(RuntimeError("CUDA error: out of memory"))
    svc = DocumentIngestionService(InMemoryIngestionStore(), InMemoryRawDocumentStore(),
                                   client, IngestionOptions())
    with pytest.raises(RuntimeError, match="CUDA error"):
        svc.ingest("a.txt", "some words to embed here", "file")
