"""The port's compacting rebuild (RecallEngine.rebuild_index over
DeviceIndex.append_from_index) on the CPU: the counterparts of
tests/test_compacted_rebuild.py — reuse of the old index's derived columns
must be invisible (bit-identical columns and results against an index built
by plain append) — and the JAX package's rebuild on the same store: the
host mirrors and the device planes of both rebuilds are bitwise equal, and
so are the served results."""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from omni_recall_tpu.config import EngineOptions as JOptions
from omni_recall_tpu.index.records import ChunkRecord as JChunk
from omni_recall_tpu.index.records import DocumentRecord as JDoc
from omni_recall_tpu.index.store import InMemoryIngestionStore as JStore
from omni_recall_tpu.search.engine import RecallEngine as JEngine
from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.index.device_index import PLANES, DeviceIndex
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.models import hash_embedder
from omni_recall_tpu_torch.search.engine import RecallEngine

T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
DIM = 32


def _options(opts_cls, **opt_kw):
    opt_kw.setdefault("backend", "xla")
    return opts_cls(embedding_dim=DIM, recent_window=300, candidate_m=8,
                    capacity_block=128, bloom_bits=128, **opt_kw)


def _fill(store, engine, chunk_cls, doc_cls, n, n_docs, dim=DIM):
    chunks = []
    for d in range(n_docs):
        doc_id = f"doc{d}"
        store.upsert_document(doc_cls(id=doc_id, file_name=f"{doc_id}.txt", created_at_utc=T0))
        doc_chunks = [
            chunk_cls(
                id=f"{doc_id}:{i:04d}", document_id=doc_id, chunk_index=i,
                content=f"chunk {i} of {doc_id} about recall topics",
                embedding=hash_embedder.embed_text(f"{doc_id} chunk {i}", dim),
                created_at_utc=T0 + timedelta(minutes=d * n + i),
            )
            for i in range(n)
        ]
        store.upsert_chunks(doc_chunks)
        engine.on_chunks_upserted(doc_chunks, new=True)
        chunks.extend(doc_chunks)
    return chunks


def _mk_engine(n=24, n_docs=3, **opt_kw):
    store = InMemoryIngestionStore()
    engine = RecallEngine(store, options=_options(EngineOptions, **opt_kw), device="cpu")
    return store, engine, _fill(store, engine, ChunkRecord, DocumentRecord, n, n_docs)


def _mk_jax_engine(n=24, n_docs=3, **opt_kw):
    store = JStore()
    engine = JEngine(store, options=_options(JOptions, **opt_kw))
    return store, engine, _fill(store, engine, JChunk, JDoc, n, n_docs)


def _fresh_copy(store, engine):
    """An engine over the same store whose index was built with plain
    append (the derivation path): the bit-identity oracle."""
    fresh = RecallEngine(store, options=engine.options, device="cpu")
    chunks = []
    for doc in store.list_documents(2**31 - 1):
        chunks.extend(store.get_chunks_by_document_id(doc.id))
    chunks.sort(key=lambda c: c.seq)
    fresh.device_index.append(chunks)
    return fresh


def _assert_index_equal(a, b):
    assert a.n_rows == b.n_rows
    n = a.n_rows
    for name in ("bloom", "emb", "raw_emb", "raw_norm_sq", "created", "created_us",
                 "created_ts", "seqs"):
        np.testing.assert_array_equal(getattr(a, name)[:n], getattr(b, name)[:n], name)
    np.testing.assert_array_equal(a.content_off[: n + 1], b.content_off[: n + 1])
    assert bytes(a._arena[: a.content_off[n]]) == bytes(b._arena[: b.content_off[n]])
    assert [c.id for c in a.meta] == [c.id for c in b.meta]
    assert a._row_by_chunk_id == b._row_by_chunk_id


def _hits(engine, query):
    return [(h.chunk.id, h.score) for h in engine.search(query, None, 5, now=NOW)]


def test_rebuild_compacts_tombstones_bit_identically():
    store, engine, _ = _mk_engine()
    store.delete_document("doc1")
    engine.on_document_deleted("doc1")
    assert engine.rebuild_index() == "upload"  # xla: f32 planes, dirty before the rebuild
    fresh = _fresh_copy(store, engine)
    _assert_index_equal(engine.device_index, fresh.device_index)
    assert engine.device_index.n_rows == 48  # doc1's 24 rows compacted away
    assert _hits(engine, "chunk 3 of doc2") == _hits(fresh, "chunk 3 of doc2")


def test_rebuild_reflects_inplace_embedding_update():
    """update_embedding mutates arrays in place and keeps the meta object:
    the identity test holds AND the reused columns carry the new values."""
    store, engine, chunks = _mk_engine(n_docs=1)
    new_emb = hash_embedder.embed_text("completely different text", DIM)
    target = chunks[5]
    target.embedding = new_emb
    engine.device_index.update_embedding(target.id, new_emb)
    engine.rebuild_index()
    fresh = _fresh_copy(store, engine)
    _assert_index_equal(engine.device_index, fresh.device_index)
    row = engine.device_index._row_by_chunk_id[target.id]
    np.testing.assert_array_equal(engine.device_index.raw_emb[row],
                                  np.asarray(new_emb, np.float32))


def test_rebuild_rederives_replaced_records():
    """A store upsert replaces record objects: those chunks re-derive and
    land between reused rows (mixed hit/miss arena assembly)."""
    store, engine, chunks = _mk_engine(n_docs=3)
    replaced = [
        ChunkRecord(
            id=c.id, document_id=c.document_id, chunk_index=c.chunk_index,
            content=f"REWRITTEN {c.chunk_index} with new words entirely",
            embedding=hash_embedder.embed_text(f"rewritten {c.chunk_index}", DIM),
            created_at_utc=c.created_at_utc, seq=c.seq,
        )
        for c in chunks if c.document_id == "doc1"
    ]
    store.upsert_chunks(replaced)
    assert engine.rebuild_index() == "upload"  # misses: no on-device gather
    fresh = _fresh_copy(store, engine)
    _assert_index_equal(engine.device_index, fresh.device_index)
    hits = engine.search("rewritten with new words", None, 3, now=NOW)
    assert hits and hits[0].chunk.document_id == "doc1"
    assert "REWRITTEN" in hits[0].chunk.content


def test_rebuild_adopts_device_planes_when_all_rows_reused(monkeypatch):
    """All rows reused and the planes current: the quantized planes are
    gathered on the device, equal to a from-scratch build."""
    store, engine, _ = _mk_engine(n_docs=2, scan_dtype="int8", backend="pallas")
    engine.device_index.device_arrays()
    store.delete_document("doc0")
    engine.on_document_deleted("doc0")
    engine.device_index.device_arrays()  # sync the tombstones first
    calls = []
    orig = DeviceIndex._adopt_compacted_planes
    monkeypatch.setattr(
        DeviceIndex, "_adopt_compacted_planes",
        lambda self, odev, src: (calls.append(1), orig(self, odev, src))[1],
    )
    assert engine.rebuild_index() == "device"
    new_index = engine.device_index
    assert calls and new_index._device is not None and not new_index._dirty_blocks

    fresh = _fresh_copy(store, engine)
    dev_a = new_index.device_arrays()
    dev_b = fresh.device_index.device_arrays()
    n = new_index.n_rows
    for name in ("emb", "bloom", "scale", "err", "created"):
        assert torch.equal(getattr(dev_a, name)[:n], getattr(dev_b, name)[:n]), name
    assert bool(dev_a.valid[:n].all()) and not bool(dev_a.valid[n:].any())
    assert _hits(engine, "chunk 7 of doc1") == _hits(fresh, "chunk 7 of doc1")


def test_rebuild_falls_back_when_planes_dirty(monkeypatch):
    """Un-synced host mutations block the plane adoption (stale planes
    could resurrect old values); the rebuild still works by the upload."""
    store, engine, _ = _mk_engine(n_docs=2, scan_dtype="int8", backend="pallas")
    engine.device_index.device_arrays()
    store.delete_document("doc0")
    engine.on_document_deleted("doc0")  # marks blocks dirty, no sync
    assert engine.device_index._dirty_blocks
    calls = []
    monkeypatch.setattr(DeviceIndex, "_adopt_compacted_planes",
                        lambda self, odev, src: calls.append(1))
    assert engine.rebuild_index() == "upload"
    assert not calls
    fresh = _fresh_copy(store, engine)
    _assert_index_equal(engine.device_index, fresh.device_index)
    assert _hits(engine, "chunk 3 of doc1") == _hits(fresh, "chunk 3 of doc1")


def test_append_from_index_rejects_parameter_mismatch():
    _, engine, chunks = _mk_engine(n_docs=1)
    other = DeviceIndex(DIM, bloom_bits=256, device="cpu")
    with pytest.raises(ValueError):
        other.append_from_index(engine.device_index, chunks)
    nonempty = engine.device_index
    with pytest.raises(ValueError, match="empty"):
        nonempty.append_from_index(nonempty, chunks)


@pytest.mark.parametrize("refine, backend, sync", [
    (True, "pallas", True),    # int8 with the residual planes, gathered on the device
    (False, "pallas", True),   # int8 without them
    (True, "pallas", False),   # dirty planes: the upload path
    (False, "xla", True),      # f32 storage
])
def test_rebuild_planes_bitwise_equal_the_jax_rebuild(refine, backend, sync):
    opts = dict(n_docs=3, backend=backend, refine=refine,
                scan_dtype="int8" if backend == "pallas" else "f32")
    store, engine, _ = _mk_engine(**opts)
    jstore, jengine, _ = _mk_jax_engine(**opts)
    for st, eng in ((store, engine), (jstore, jengine)):
        eng.device_index.device_arrays()
        st.delete_document("doc1")
        eng.on_document_deleted("doc1")
        if sync:
            eng.device_index.device_arrays()
    route = engine.rebuild_index()
    jengine.rebuild_index()
    assert route == ("device" if sync else "upload")
    t, j = engine.device_index, jengine.device_index
    _assert_index_equal(t, j)
    tdev, jdev = t.device_arrays(), j.device_arrays()
    for name in PLANES:
        a, b = getattr(tdev, name), getattr(jdev, name)
        assert (a is None) == (b is None), name
        if a is not None:
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and np.array_equal(
                a.numpy().view(np.uint8), b.view(np.uint8)), name
    for q in ("chunk 3 of doc2", "recall topics doc0", "chunk 11"):
        emb = hash_embedder.embed_text(q, DIM)
        got = [(h.chunk.id, round(h.score, 4)) for h in engine.search(q, emb, 5, now=NOW)]
        want = [(h.chunk.id, round(h.score, 4)) for h in jengine.search(q, emb, 5, now=NOW)]
        assert got == want


def test_rebuild_refuses_a_compact_engine():
    """A compact bulk store is serving-only: its store holds the bulk
    document but no chunk records, so a rebuild would swap an empty index
    in. rebuild_index raises and leaves the index in place."""
    from omni_recall_tpu_torch.index import compact

    n = 1 << 12
    engine, make_requests, now, _ = compact.build_compact_engine(
        n, DIM, slab=1 << 10, device="cpu")
    old = engine.device_index
    reqs = make_requests(0, 4)

    def served():
        return [[(h.chunk.id, h.score) for h in hits]
                for hits in engine.search_batch(reqs, now=now)]

    before = served()
    assert all(before)
    with pytest.raises(RuntimeError, match="serving-only"):
        engine.rebuild_index()
    assert engine.device_index is old
    assert old.n_rows == n and old.n_valid == n
    assert served() == before


def test_rebuild_lets_device_errors_through(monkeypatch):
    """An out-of-memory error of the on-device adoption is not swallowed
    into an upload (which would need the same memory while old's planes are
    still held): it propagates, and the old index stays in place."""
    store, engine, _ = _mk_engine(n_docs=2, scan_dtype="int8", backend="pallas")
    engine.device_index.device_arrays()
    store.delete_document("doc0")
    engine.on_document_deleted("doc0")
    engine.device_index.device_arrays()
    old = engine.device_index
    before = _hits(engine, "chunk 5 of doc1")

    def out_of_memory(self, odev, src):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(DeviceIndex, "_adopt_compacted_planes", out_of_memory)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        engine.rebuild_index()
    assert engine.device_index is old
    assert _hits(engine, "chunk 5 of doc1") == before
