"""The port's snapshot/restore (omni_recall_tpu_torch/index/snapshot.py) on
the CPU: the counterparts of tests/test_snapshot.py (all but the sharded
case, which waits for the port's sharding), and the crossing between the
packages — a snapshot the JAX package writes restores into the port through
the slab fast path with DTO-identical results, and the other way round; the
v1 and v2 archives load in both; a failure of the card propagates through
the restore's fallback while a malformed archive takes the rebuild."""

import json
import random
import string
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from omni_recall_tpu.config import EngineOptions as JOptions
from omni_recall_tpu.index import snapshot as jsnap
from omni_recall_tpu.index.records import ChunkRecord as JChunk
from omni_recall_tpu.index.records import DocumentRecord as JDoc
from omni_recall_tpu.index.store import InMemoryIngestionStore as JStore
from omni_recall_tpu.search.engine import RecallEngine as JEngine
from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.index import device_index as dix_mod
from omni_recall_tpu_torch.index import snapshot as snap
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.snapshot import (
    load_snapshot,
    load_snapshot_full,
    restore_engine,
    save_snapshot,
)
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.models import hash_embedder
from omni_recall_tpu_torch.search.engine import RecallEngine

DIM = 32
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
INT8 = dict(backend="pallas", embedding_dim=DIM, recent_window=0, candidate_m=16,
            bloom_bits=256, scan_dtype="int8", capacity_block=512, refine=True)


def _build_store(rng, store_cls=InMemoryIngestionStore, doc_cls=DocumentRecord,
                 chunk_cls=ChunkRecord):
    store = store_cls()
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=5)) for _ in range(30)]
    for d in range(3):
        store.upsert_document(
            doc_cls(
                id=f"doc_{d}", file_name=f"f{d}.txt", content_hash=f"h{d}",
                chunk_count=10, created_at_utc=T0 + timedelta(hours=d),
            )
        )
        chunks = [
            chunk_cls(
                id=f"doc_{d}:{i:04d}", document_id=f"doc_{d}", chunk_index=i,
                content=" ".join(rng.choices(vocab, k=8)),
                embedding=hash_embedder.embed_text(f"{d}-{i}", DIM) if i % 4 else None,
                created_at_utc=T0 + timedelta(hours=d, minutes=i),
            )
            for i in range(10)
        ]
        store.upsert_chunks(chunks)
    return store, vocab


def _int8_engine(**overrides):
    return RecallEngine(InMemoryIngestionStore(), options=EngineOptions(**{**INT8, **overrides}),
                        device="cpu")


def _seq_chunks(store):
    chunks = []
    for doc in store.list_documents(1 << 30):
        chunks.extend(store.get_chunks_by_document_id(doc.id))
    chunks.sort(key=lambda c: c.seq)
    return chunks


def _engine_with_store(store):
    eng = _int8_engine()
    eng.store = store
    chunks = _seq_chunks(store)
    eng.device_index.append(chunks)
    return eng, chunks


def _queries(rng, vocab, n=12):
    reqs = []
    for i in range(n):
        emb = hash_embedder.embed_text(f"q{i}", DIM) if i % 3 else None
        reqs.append((" ".join(rng.choices(vocab, k=2)), emb, 5))
    return reqs


def _same(out_a, out_b):
    for ha, hb in zip(out_a, out_b):
        assert [h.chunk.id for h in ha] == [h.chunk.id for h in hb]
        assert [h.score for h in ha] == [h.score for h in hb]


def _dto(batch):
    return [[(h.chunk.id, round(h.score, 4)) for h in hits] for hits in batch]


def test_snapshot_roundtrip_identical_rankings(tmp_path):
    rng = random.Random(42)
    store, vocab = _build_store(rng)
    save_snapshot(store, tmp_path / "snap")

    restored = load_snapshot(tmp_path / "snap")
    assert len(restored.list_documents(100)) == 3
    orig_recent = [c.id for c in store.get_recent_chunks(1000)]
    rest_recent = [c.id for c in restored.get_recent_chunks(1000)]
    assert orig_recent == rest_recent  # seq ordering survives

    opts = EngineOptions(backend="xla", embedding_dim=DIM, capacity_block=128)
    engine_a = RecallEngine(store, options=opts, device="cpu")
    assert restore_engine(store, engine_a) == "rebuild"
    engine_b = RecallEngine(restored, options=opts, device="cpu")
    restore_engine(restored, engine_b)

    for _ in range(5):
        query = " ".join(rng.choices(vocab, k=2))
        emb = hash_embedder.embed_text(query, DIM)
        _same([engine_a.search(query, emb, 7, now=NOW)],
              [engine_b.search(query, emb, 7, now=NOW)])


def test_snapshot_preserves_embeddings_and_missing(tmp_path):
    rng = random.Random(1)
    store, _ = _build_store(rng)
    save_snapshot(store, tmp_path / "s")
    restored = load_snapshot(tmp_path / "s")
    orig = {c.id: c for c in store.get_recent_chunks(1000)}
    rest = {c.id: c for c in restored.get_recent_chunks(1000)}
    assert orig.keys() == rest.keys()
    for cid, c in orig.items():
        r = rest[cid]
        assert (c.embedding is None) == (r.embedding is None)
        if c.embedding is not None:
            assert list(map(float, c.embedding)) == list(map(float, r.embedding))
        assert c.created_at_utc == r.created_at_utc
        assert c.content == r.content


def test_snapshot_new_ingests_after_restore_get_fresh_seqs(tmp_path):
    rng = random.Random(2)
    store, _ = _build_store(rng)
    save_snapshot(store, tmp_path / "s")
    restored = load_snapshot(tmp_path / "s")
    max_seq = max(c.seq for c in restored.get_recent_chunks(1000))
    restored.upsert_chunks([
        ChunkRecord(id="new:0000", document_id="new", chunk_index=0,
                    content="fresh", created_at_utc=NOW)
    ])
    fresh = [c for c in restored.get_recent_chunks(1) if c.id == "new:0000"]
    assert fresh and fresh[0].seq == max_seq + 1


def test_snapshot_preserves_float64_embeddings(tmp_path):
    """The oracle and host paths score raw embeddings in float64: a
    snapshot round-trip returns the exact values, not f32-rounded ones."""
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="d1", file_name="a.txt"))
    vec = [0.1234567890123456789, -1.0000000000000002, 3.141592653589793]
    store.upsert_chunks([ChunkRecord(
        id="d1:0", document_id="d1", chunk_index=0, content="x", embedding=vec,
    )])
    save_snapshot(store, tmp_path)
    restored = load_snapshot(tmp_path)
    assert list(restored.get_chunks_by_document_id("d1")[0].embedding) == vec


def test_snapshot_single_atomic_archive(tmp_path):
    """ONE archive directory swapped in by rename: no temp or old residue."""
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="d1", file_name="a.txt"))
    save_snapshot(store, tmp_path)
    save_snapshot(store, tmp_path)  # overwrite works and leaves no residue
    assert sorted(p.name for p in tmp_path.iterdir()) == ["snapshot.d"]
    assert "meta.json" in {p.name for p in (tmp_path / "snapshot.d").iterdir()}
    assert snap.snapshot_exists(tmp_path) and not snap.snapshot_exists(tmp_path / "none")


def test_slab_snapshot_fast_restore_bit_identical(tmp_path):
    """The slab restore (no re-hash, no re-quantize) reproduces the results
    of the source and of a full rebuild bit for bit, and takes the fast path
    (staged planes, consumed by the first upload)."""
    rng = random.Random(5)
    store, vocab = _build_store(rng)
    src, chunks = _engine_with_store(store)

    save_snapshot(store, tmp_path / "s", device_index=src.device_index)
    restored_store, aux = load_snapshot_full(tmp_path / "s")
    assert aux is not None and aux["slabs"] is not None

    fast = _int8_engine()
    fast.store = restored_store
    assert restore_engine(restored_store, fast, aux=aux) == "slabs"
    assert fast.device_index._preconverted is not None
    assert fast.device_index.n_rows == len(chunks)

    slow = _int8_engine()
    slow.store = restored_store
    assert restore_engine(restored_store, slow) == "rebuild"

    reqs = _queries(rng, vocab)
    out_src = src.search_batch(reqs, now=NOW)
    out_fast = fast.search_batch(reqs, now=NOW)
    out_slow = slow.search_batch(reqs, now=NOW)
    _same(out_src, out_fast)
    _same(out_fast, out_slow)
    assert fast.device_index._preconverted is None  # consumed by the upload

    # host mirrors bit-identical to the rebuilt index (exact-rescore inputs)
    df, dl = fast.device_index, slow.device_index
    n = dl.n_rows
    assert np.array_equal(df.emb[:n], dl.emb[:n])
    assert np.array_equal(df.bloom[:n], dl.bloom[:n])
    assert np.array_equal(df.raw_emb[:n], dl.raw_emb[:n])
    assert np.array_equal(df.raw_norm_sq[:n], dl.raw_norm_sq[:n])
    assert np.array_equal(df.created_us[:n], dl.created_us[:n])
    assert bytes(df._arena) == bytes(dl._arena)
    # and the uploaded planes are the slow path's
    for name in ("emb", "scale", "err", "emb2", "scale2", "err2", "bloom", "created"):
        a = getattr(df.device_arrays(), name)[:n]
        b = getattr(dl.device_arrays(), name)[:n]
        assert torch.equal(a, b), name


def test_slab_restore_rejects_tampered_or_mismatched(tmp_path):
    """A corrupted slab or mismatched engine parameters fall back to the
    rebuild (never an unsound index)."""
    rng = random.Random(6)
    store, vocab = _build_store(rng)
    src, chunks = _engine_with_store(store)
    save_snapshot(store, tmp_path / "s", device_index=src.device_index)

    restored_store, aux = load_snapshot_full(tmp_path / "s")
    aux_bad = dict(aux)
    aux_bad["slabs"] = dict(aux["slabs"])
    bad_bloom = np.array(aux["slabs"]["bloom"])
    bad_bloom[3, 0] ^= 0xFF
    aux_bad["slabs"]["bloom"] = bad_bloom
    eng = _int8_engine()
    eng.store = restored_store
    assert restore_engine(restored_store, eng, aux=aux_bad) == "rebuild"
    assert eng.device_index._preconverted is None
    assert eng.device_index.n_rows == len(chunks)

    # mismatched params (another bloom width) -> fallback, still correct
    eng2 = _int8_engine(bloom_bits=512)
    eng2.store = restored_store
    assert restore_engine(restored_store, eng2, aux=aux) == "rebuild"
    assert eng2.device_index._preconverted is None
    assert eng2.device_index.n_rows == len(chunks)

    reqs = _queries(rng, vocab)
    out_src = src.search_batch(reqs, now=NOW)
    for eng_x in (eng, eng2):
        _same(out_src, eng_x.search_batch(reqs, now=NOW))


def test_save_reads_back_device_planes(tmp_path):
    """After a device sync the save reads the live device planes back
    (deriv "device"); a save after a restore reuses the staged planes
    ("staged"); a mutation since the restore re-quantizes on the host."""
    rng = random.Random(9)
    store, vocab = _build_store(rng)
    src, chunks = _engine_with_store(store)
    src.device_index.device_arrays()

    def deriv(name):
        return json.loads((tmp_path / name / "snapshot.d" / "meta.json").read_text())[
            "slabs"]["deriv"]

    save_snapshot(store, tmp_path / "s", device_index=src.device_index)
    assert deriv("s") == "device"

    restored_store, aux = load_snapshot_full(tmp_path / "s")
    eng = _int8_engine()
    eng.store = restored_store
    assert restore_engine(restored_store, eng, aux=aux) == "slabs"
    assert eng.device_index._preconverted is not None

    save_snapshot(restored_store, tmp_path / "s2", device_index=eng.device_index)
    assert deriv("s2") == "staged"

    reqs = _queries(rng, vocab)
    _same(src.search_batch(reqs, now=NOW), eng.search_batch(reqs, now=NOW))

    # the search uploaded and consumed the staged planes; a mutation then
    # leaves dirty blocks, so neither the staged nor the device planes serve
    live = next(c for c in chunks if c.embedding is not None)
    eng.device_index.update_embedding(live.id, [float(i) for i in range(DIM)])
    save_snapshot(restored_store, tmp_path / "s3", device_index=eng.device_index)
    assert deriv("s3") == "host"


def test_slab_restore_rejects_unsound_quantization(tmp_path):
    """A plane whose stored error bound understates the true residual (or
    carries NaN) fails the integrity sample and falls back."""
    rng = random.Random(11)
    store, vocab = _build_store(rng)
    src, chunks = _engine_with_store(store)
    save_snapshot(store, tmp_path / "s", device_index=src.device_index)
    restored_store, aux = load_snapshot_full(tmp_path / "s")

    def restore_with(key, mutate):
        aux_bad = dict(aux)
        aux_bad["slabs"] = dict(aux["slabs"])
        arr = np.array(aux["slabs"][key])
        mutate(arr)
        aux_bad["slabs"][key] = arr
        eng = _int8_engine()
        eng.store = restored_store
        assert restore_engine(restored_store, eng, aux=aux_bad) == "rebuild"
        return eng

    def shrink(e1):
        e1[:] = 0.0

    def poison(s1):
        s1[5] = np.nan

    def corrupt(q1):
        q1[2] = 127

    eng = restore_with("e1", shrink)
    assert eng.device_index._preconverted is None
    assert eng.device_index.n_rows == len(chunks)
    for key, mutate in (("s1", poison), ("q1", corrupt), ("e2", shrink)):
        assert restore_with(key, mutate).device_index._preconverted is None

    reqs = _queries(rng, vocab)
    _same(src.search_batch(reqs, now=NOW), eng.search_batch(reqs, now=NOW))


def test_save_device_planes_subset_rows(tmp_path):
    """A device-plane save with tombstoned rows gathers exactly the live
    rows on the device; the restore reproduces the source's results."""
    rng = random.Random(13)
    store, vocab = _build_store(rng)
    src, chunks = _engine_with_store(store)
    store.delete_document("doc_1")
    src.device_index.delete_document("doc_1")
    src.device_index.device_arrays()

    save_snapshot(store, tmp_path / "s", device_index=src.device_index)
    meta = json.loads((tmp_path / "s" / "snapshot.d" / "meta.json").read_text())
    assert meta["slabs"]["deriv"] == "device"

    restored_store, aux = load_snapshot_full(tmp_path / "s")
    assert aux["slabs"]["q1"].shape[0] == 20  # 3 docs x 10 minus doc_1
    eng = _int8_engine()
    eng.store = restored_store
    assert restore_engine(restored_store, eng, aux=aux) == "slabs"
    reqs = _queries(rng, vocab)
    _same(src.search_batch(reqs, now=NOW), eng.search_batch(reqs, now=NOW))


def test_slab_restore_rejects_tampered_recency_and_arena(tmp_path):
    """The integrity sample covers the recency column, the tie-break
    timestamps and the lowercased arena; malformed shapes and offsets
    degrade to the rebuild instead of raising out of restore_engine."""
    rng = random.Random(7)
    store, vocab = _build_store(rng)
    src, chunks = _engine_with_store(store)
    save_snapshot(store, tmp_path / "s", device_index=src.device_index)
    restored_store, aux = load_snapshot_full(tmp_path / "s")

    def tampered(key, mutate):
        bad = dict(aux)
        bad["slabs"] = dict(aux["slabs"])
        arr = np.array(aux["slabs"][key])
        mutate(arr)
        bad["slabs"][key] = arr
        return bad

    def older_day(a):
        a[5] -= 30.0

    def shift_ts(a):
        a[5] += 1.0

    def flip_byte(a):
        a[1] ^= 0x20

    def truncate(key):
        bad = dict(aux)
        bad["slabs"] = dict(aux["slabs"])
        bad["slabs"][key] = np.array(aux["slabs"][key])[:-2]
        return bad

    def off_past_arena(a):
        a[-1] += 7

    cases = [
        tampered("created", older_day),
        tampered("created_ts", shift_ts),
        tampered("lower_arena", flip_byte),
        truncate("created"),
        tampered("lower_off", off_past_arena),
    ]
    reqs = _queries(rng, vocab)
    out_src = src.search_batch(reqs, now=NOW)
    for bad_aux in cases:
        eng = _int8_engine()
        eng.store = restored_store
        assert restore_engine(restored_store, eng, aux=bad_aux) == "rebuild"
        assert eng.device_index._preconverted is None
        assert eng.device_index.n_rows == len(chunks)
        _same(out_src, eng.search_batch(reqs, now=NOW))


def test_restore_orders_doc_chunks_by_chunk_index(tmp_path):
    """A document whose chunk id was replaced mid-list gets a fresh seq for
    that chunk; the restored store still returns the doc's chunks in
    chunk_index order."""
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="doc_x", file_name="x.txt", content_hash="hx",
                                         chunk_count=5, created_at_utc=T0))

    def mk(cid, i):
        return ChunkRecord(id=cid, document_id="doc_x", chunk_index=i, content=f"content {i}",
                           embedding=hash_embedder.embed_text(f"x-{i}", DIM),
                           created_at_utc=T0 + timedelta(minutes=i))

    store.upsert_chunks([mk(f"doc_x:{i:04d}", i) for i in range(5)])
    store.upsert_chunks([mk("doc_x:0002-v2" if i == 2 else f"doc_x:{i:04d}", i)
                         for i in range(5)])
    save_snapshot(store, tmp_path / "s")
    got = load_snapshot(tmp_path / "s").get_chunks_by_document_id("doc_x")
    assert [c.chunk_index for c in got] == [0, 1, 2, 3, 4]
    assert [c.id for c in got] == [
        "doc_x:0000", "doc_x:0001", "doc_x:0002-v2", "doc_x:0003", "doc_x:0004"]


def test_upload_slabbed_tick_and_abort():
    """A long upload ticks its caller at every slab boundary, so a
    deadline-aware caller can abort between slabs; the result is bitwise."""
    host = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    slab_bytes = host.itemsize * 32 * 8
    ticks = []
    out = dix_mod.upload_slabbed(host, "cpu", slab_bytes=slab_bytes,
                                 tick=lambda: ticks.append(1))
    assert np.array_equal(out.numpy(), host) and len(ticks) == 8

    class Abort(RuntimeError):
        pass

    calls = {"n": 0}

    def tick():
        calls["n"] += 1
        if calls["n"] >= 3:
            raise Abort("deadline")

    with pytest.raises(Abort):
        dix_mod.upload_slabbed(host, "cpu", slab_bytes=slab_bytes, tick=tick)
    assert calls["n"] == 3
    # a memmap (the restore's arrays) and the single-slab path, no tick
    ticks.clear()
    out = dix_mod.upload_slabbed(host, "cpu", tick=lambda: ticks.append(1))
    assert np.array_equal(out.numpy(), host) and not ticks


def test_upload_slabbed_reads_copy_on_write_memmaps(tmp_path):
    host = np.random.default_rng(0).integers(-127, 128, (4096, 48), dtype=np.int8)
    np.save(tmp_path / "a.npy", host)
    mm = np.load(tmp_path / "a.npy", mmap_mode="c")
    out = dix_mod.upload_slabbed(mm, "cpu", slab_bytes=48 * 100)
    assert out.dtype == torch.int8 and np.array_equal(out.numpy(), host)
    ro = np.load(tmp_path / "a.npy", mmap_mode="r")  # read-only pages too
    assert np.array_equal(dix_mod.upload_slabbed(ro, "cpu", slab_bytes=48 * 100).numpy(), host)


# ---- the two packages read each other's snapshots ----


def _jax_int8_engine(store):
    eng = JEngine(JStore(), options=JOptions(**INT8))
    eng.store = store
    eng.device_index.append(_seq_chunks(store))
    return eng


def test_jax_snapshot_restores_into_the_port_by_the_fast_path(tmp_path):
    rng = random.Random(21)
    jstore, vocab = _build_store(rng, JStore, JDoc, JChunk)
    jsrc = _jax_int8_engine(jstore)
    jsrc.device_index.device_arrays()  # the save reads the device planes back
    jsnap.save_snapshot(jstore, tmp_path / "s", device_index=jsrc.device_index)

    store, aux = load_snapshot_full(tmp_path / "s")
    assert aux["meta"]["slabs"]["deriv"] == "device"
    eng = _int8_engine()
    eng.store = store
    assert restore_engine(store, eng, aux=aux) == "slabs"
    reqs = _queries(rng, vocab)
    assert _dto(eng.search_batch(reqs, now=NOW)) == _dto(jsrc.search_batch(reqs, now=NOW))
    # the restored planes are the JAX engine's
    jdev, dev = jsrc.device_index.device_arrays(), eng.device_index.device_arrays()
    n = eng.device_index.n_rows
    for name in ("emb", "scale", "err", "emb2", "scale2", "err2", "bloom", "created"):
        assert np.array_equal(np.asarray(getattr(jdev, name))[:n],
                              getattr(dev, name)[:n].numpy()), name


def test_port_snapshot_restores_into_jax_by_the_fast_path(tmp_path):
    rng = random.Random(22)
    store, vocab = _build_store(rng)
    src, _ = _engine_with_store(store)
    src.device_index.device_arrays()
    save_snapshot(store, tmp_path / "s", device_index=src.device_index)

    jstore, jaux = jsnap.load_snapshot_full(tmp_path / "s")
    jeng = JEngine(JStore(), options=JOptions(**INT8))
    jeng.store = jstore
    jsnap.restore_engine(jstore, jeng, aux=jaux)
    assert jeng.device_index._preconverted is not None  # the JAX fast path
    reqs = _queries(rng, vocab)
    assert _dto(jeng.search_batch(reqs, now=NOW)) == _dto(src.search_batch(reqs, now=NOW))


def _v2_archive(src_dir, dst, keep_mirrors: bool):
    """A v2 single-archive snapshot.npz from a v3 directory: meta_json plus
    every array; without the persisted mirrors (emb_norm, raw_emb,
    raw_norm_sq), as v2 archives were written."""
    meta = json.loads((src_dir / "meta.json").read_text())
    meta["version"] = 2
    arrays = {p.stem: np.load(p) for p in src_dir.glob("*.npy")}
    if not keep_mirrors:
        for k in ("slab_emb_norm", "slab_raw_emb", "slab_raw_norm_sq"):
            arrays.pop(k)
    dst.mkdir(parents=True)
    np.savez(dst / "snapshot.npz", meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **arrays)


def test_v2_archive_loads_and_restores_in_both_packages(tmp_path):
    rng = random.Random(23)
    store, vocab = _build_store(rng)
    src, _ = _engine_with_store(store)
    save_snapshot(store, tmp_path / "v3", device_index=src.device_index)
    _v2_archive(tmp_path / "v3" / "snapshot.d", tmp_path / "v2", keep_mirrors=False)
    assert snap.snapshot_exists(tmp_path / "v2")

    reqs = _queries(rng, vocab)
    want = _dto(src.search_batch(reqs, now=NOW))
    st, aux = load_snapshot_full(tmp_path / "v2")
    eng = _int8_engine()
    eng.store = st
    assert restore_engine(st, eng, aux=aux) == "slabs"  # mirrors derived from the store
    assert _dto(eng.search_batch(reqs, now=NOW)) == want
    jst, jaux = jsnap.load_snapshot_full(tmp_path / "v2")
    jeng = JEngine(JStore(), options=JOptions(**INT8))
    jeng.store = jst
    jsnap.restore_engine(jst, jeng, aux=jaux)
    assert jeng.device_index._preconverted is not None
    assert _dto(jeng.search_batch(reqs, now=NOW)) == want


def _v1_meta(store):
    chunks = _seq_chunks(store)
    meta = {"version": 1, "documents": [
        {"id": d.id, "fileName": d.file_name, "sourceType": d.source_type,
         "blobPath": d.blob_path, "contentHash": d.content_hash,
         "chunkCount": d.chunk_count, "createdAtUtc": d.created_at_utc.isoformat()}
        for d in store.list_documents(100)],
        "chunks": [{"id": c.id, "documentId": c.document_id, "chunkIndex": c.chunk_index,
                    "content": c.content, "createdAtUtc": c.created_at_utc.isoformat(),
                    "seq": c.seq} for c in chunks]}
    vecs = [np.asarray(c.embedding or [], dtype=np.float64) for c in chunks]
    offsets = np.concatenate([[0], np.cumsum([v.size for v in vecs])]).astype(np.int64)
    arrays = {"emb_flat": np.concatenate(vecs), "offsets": offsets,
              "has_emb": np.asarray([c.embedding is not None for c in chunks])}
    return meta, arrays


@pytest.mark.parametrize("layout", ["two_file", "single_archive"])
def test_v1_snapshots_load_in_both_packages(tmp_path, layout):
    rng = random.Random(24)
    store, _ = _build_store(rng)
    meta, arrays = _v1_meta(store)
    if layout == "two_file":
        (tmp_path / "meta.json").write_text(json.dumps(meta))
        np.savez(tmp_path / "embeddings.npz", **arrays)
    else:
        np.savez(tmp_path / "snapshot.npz",
                 meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    assert snap.snapshot_exists(tmp_path)
    restored, aux = load_snapshot_full(tmp_path)
    assert aux is None
    jrestored = jsnap.load_snapshot(tmp_path)
    want = {c.id: (c.seq, c.content, c.created_at_utc, c.embedding)
            for c in store.get_recent_chunks(1000)}
    for st in (restored, jrestored):
        got = {c.id: (c.seq, c.content, c.created_at_utc, c.embedding)
               for c in st.get_recent_chunks(1000)}
        assert got.keys() == want.keys()
        for cid, (seq, content, created, emb) in want.items():
            assert got[cid][:3] == (seq, content, created)
            assert (got[cid][3] is None) == (emb is None)
            if emb is not None:
                assert list(map(float, got[cid][3])) == list(map(float, emb))
    eng = _int8_engine()
    assert restore_engine(restored, eng, aux) == "rebuild"
    assert eng.device_index.n_rows == len(want)


def test_restore_lets_device_errors_through(tmp_path, monkeypatch):
    """The fallback is for malformed archives and mismatches: a failure of
    the card (out of memory, a failed launch) propagates."""
    rng = random.Random(25)
    store, _ = _build_store(rng)
    src, _ = _engine_with_store(store)
    save_snapshot(store, tmp_path / "s", device_index=src.device_index)
    st, aux = load_snapshot_full(tmp_path / "s")

    def raising(exc):
        def fail(*args, **kwargs):
            raise exc
        return fail

    for exc in (torch.cuda.OutOfMemoryError("CUDA out of memory"),
                RuntimeError("omni_int8_coarse_topt: CUDA launch failed: unspecified (719)")):
        monkeypatch.setattr(snap, "_try_restore_slabs", raising(exc))
        with pytest.raises(type(exc)):
            restore_engine(st, _int8_engine(), aux=aux)
    monkeypatch.setattr(snap, "_try_restore_slabs", raising(ValueError("bad shape")))
    eng = _int8_engine()
    assert restore_engine(st, eng, aux=aux) == "rebuild"
    assert eng.device_index.n_rows == 30
