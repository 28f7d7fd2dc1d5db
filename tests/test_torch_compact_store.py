"""The port's compact host store (omni_recall_tpu_torch/index/compact.py,
DeviceIndex.bulk_load_compact) against the JAX package's, on the CPU.

- ``rows_torch`` is bitwise equal to ``rows_np`` and to JAX's ``rows_jnp``
  (N = 2^15, D = 128, several ``lo``, one past 2^24, one at the top of the
  uint32 row range);
- the port's compact engine and the JAX package's give DTO-identical
  results (ids, order, ``round(score, 4)``) for the same
  ``make_requests(seed, nb)``, from bitwise-equal planes;
- the counterparts of tests/test_compact_store.py: host and device
  generation bit-identical, CompactMeta, the serving-only guards, hybrid
  serving against a standard-path engine over the same rows, the keyword
  term live;
- the exact host scan (``_search_full_host``) runs on a compact index
  through the same rows, and the numpy rescore (``materialize_raw_rows``)
  equals the native int8 rescore bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.index import compact as jcompact
from omni_recall_tpu_torch.index import compact

N = 1 << 15
D = 128


@pytest.fixture(scope="module")
def built():
    return compact.build_compact_engine(N, D, slab=1 << 13, device="cpu")


@pytest.fixture(scope="module")
def jbuilt():
    return jcompact.build_compact_engine(N, D, slab=1 << 13)


def _dto(hits):
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


@pytest.mark.parametrize("lo", [0, 12345, (1 << 24) + 77, (1 << 32) - N])
def test_rows_torch_bitwise_to_rows_np_and_rows_jnp(lo):
    n_clusters = N // 64
    center8, noise8 = compact.make_tables(n_clusters, D)
    want = compact.rows_np(lo, lo + N, center8, noise8)
    got = compact.rows_torch(lo, N, torch.from_numpy(center8), torch.from_numpy(noise8),
                             n_clusters, noise8.shape[0])
    jax_rows = np.asarray(jcompact.rows_jnp(
        lo, N, jnp.asarray(center8), jnp.asarray(noise8), n_clusters, noise8.shape[0]))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(jax_rows, want)
    # the tables and the recipe are the JAX package's
    jc8, jn8 = jcompact.make_tables(n_clusters, D)
    assert np.array_equal(jc8, center8) and np.array_equal(jn8, noise8)
    assert np.array_equal(jcompact.rows_np(lo, lo + N, jc8, jn8), want)


def test_recipe_guards():
    center8, noise8 = compact.make_tables(64, 8, noise_k=64)
    with pytest.raises(ValueError, match="power of two"):
        compact.row_ids_np(0, 8, 64, 48)
    with pytest.raises(ValueError, match="power of two"):
        compact.rows_torch(0, 8, torch.from_numpy(center8), torch.from_numpy(noise8), 64, 48)
    with pytest.raises(ValueError, match="uint32"):
        compact.rows_torch((1 << 32) - 4, 8, torch.from_numpy(center8),
                           torch.from_numpy(noise8), 64, 64)
    with pytest.raises(ValueError, match="127"):
        compact.make_tables(8, 8, amp_center=120, amp_noise=8)


def test_host_device_generation_bit_identical(built):
    engine, _, _, _ = built
    dix = engine.device_index
    dev = dix.device_arrays()
    assert dev.emb.dtype == torch.int8
    assert np.array_equal(dev.emb.numpy(), dix.emb8_host)
    assert np.array_equal(dev.scale.numpy(), dix.scale_host)
    assert np.array_equal(dev.created.numpy(), dix.created)
    assert bool(dev.valid.all()) and dev.raw is None and dev.emb2 is None


def test_planes_and_columns_equal_the_jax_packages(built, jbuilt):
    dix, jdix = built[0].device_index, jbuilt[0].device_index
    dev, jdev = dix.device_arrays(), jdix.device_arrays()
    for name in ("emb", "bloom", "created", "valid", "scale", "err"):
        j = np.asarray(getattr(jdev, name))
        t = getattr(dev, name).numpy()
        assert j.dtype == t.dtype and np.array_equal(j.view(np.uint8), t.view(np.uint8)), name
    for name in ("emb8_host", "scale_host", "raw_norm_sq", "created", "created_us",
                 "created_ts", "seqs", "content_off"):
        assert np.array_equal(getattr(dix, name), getattr(jdix, name)), name
    assert bytes(dix._arena) == bytes(jdix._arena)
    assert built[3] == jbuilt[3] and built[2] == jbuilt[2]


def test_compact_meta_materializes_records(built):
    engine, _, _, n_clusters = built
    dix = engine.device_index
    meta = dix.meta
    assert len(meta) == N
    r = 12345
    rec = meta[r]
    assert rec.id == f"bulk:{r:08d}"
    assert rec.chunk_index == r and rec.seq == r
    cid = compact.row_ids_np(r, r + 1, n_clusters, 4096)[0][0]
    assert rec.content == compact.cluster_contents(n_clusters)[cid]
    want = dix.emb8_host[r].astype(np.float32) * dix.scale_host[r]
    assert np.array_equal(np.asarray(rec.embedding, dtype=np.float32), want)
    from omni_recall_tpu_torch.index.device_index import to_micros

    assert to_micros(rec.created_at_utc) == dix.created_us[r]
    # slices work (dim-mismatch fallback path)
    assert [c.id for c in meta[5:8]] == [f"bulk:{i:08d}" for i in range(5, 8)]
    assert meta[-1].id == f"bulk:{N - 1:08d}"
    with pytest.raises(IndexError):
        meta[N]


def test_serving_only_guards(built, tmp_path):
    engine, _, _, _ = built
    from omni_recall_tpu_torch.index.device_index import DeviceIndex
    from omni_recall_tpu_torch.index.records import ChunkRecord
    from omni_recall_tpu_torch.index.snapshot import save_snapshot

    dix = engine.device_index
    chunk = ChunkRecord(id="x", document_id="d", chunk_index=0, content="c")
    with pytest.raises(RuntimeError, match="serving-only"):
        dix.append([chunk])
    with pytest.raises(RuntimeError, match="serving-only"):
        dix.update_embedding("bulk:00000001", [0.0] * D)
    with pytest.raises(RuntimeError, match="serving-only"):
        save_snapshot(engine.store, tmp_path, device_index=dix)
    with pytest.raises(RuntimeError, match="serving-only"):
        dix.append_from_index(DeviceIndex(D, device="cpu"), [chunk])
    assert dix.delete_document("bulk") == 0  # no id map: a no-op
    assert dix.n_valid == N


def _reference_engine(compact_engine):
    """Standard-path engine over the SAME data: materialized f32 rows +
    real per-row records through bulk_load."""
    from omni_recall_tpu_torch.index.records import DocumentRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine

    dix = compact_engine.device_index
    ref_opts = dataclasses.replace(compact_engine.options)
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="bulk", file_name="bulk.txt"))
    ref = RecallEngine(store, options=ref_opts, device="cpu")
    emb = dix.emb8_host.astype(np.float32) * dix.scale_host[:, None]
    meta = [dix.meta[i] for i in range(N)]
    for m, row in zip(meta, emb):
        m.embedding = row  # exact f32 rows, zero-copy views
    bloom = dix.device_arrays().bloom.numpy()
    ref.device_index.bulk_load(np.ascontiguousarray(emb), bloom, dix.created.copy(), meta)
    return ref


def test_hybrid_serving_matches_standard_engine(built):
    engine, make_requests, now, _ = built
    ref = _reference_engine(engine)
    reqs = make_requests(3, 16, kw_frac=0.5)
    out_c = engine.search_batch(reqs, now=now)
    out_r = ref.search_batch(reqs, now=now)
    assert sum(len(h) for h in out_c) == 16 * 10
    for hc, hr in zip(out_c, out_r):
        assert [h.chunk.id for h in hc] == [h.chunk.id for h in hr]
        for a, b in zip(hc, hr):
            # identical ranking; scores agree to the storage contract:
            # compact raw_norm_sq = scale^2 * S2 differs from the
            # reference's sum(fl32(q8*scale)^2) by O(2^-24) relative per
            # element (index/compact.py soundness note)
            assert a.score == pytest.approx(b.score, rel=2e-7)


def test_hybrid_keyword_term_is_live(built):
    """The keyword term must contribute: a query whose text names the
    target cluster outranks the same embedding without it."""
    engine, _, now, n_clusters = built
    c = 7
    center8, _ = compact.make_tables(n_clusters, D)
    base = center8[c].astype(np.float32)
    base /= np.linalg.norm(base)
    with_kw = engine.search_batch([(f"c{c:07d}x topic", base, 5)], now=now)[0]
    without = engine.search_batch([("zz qq", base, 5)], now=now)[0]
    assert f"c{c:07d}x" in with_kw[0].chunk.content
    assert with_kw[0].score > without[0].score


@pytest.mark.parametrize("seed, kw_frac", [(3, 0.75), (11, 1.0), (29, 0.0)])
def test_compact_engines_of_both_packages_agree(built, jbuilt, seed, kw_frac):
    engine, make_requests, now, _ = built
    jengine, jmake_requests, jnow, _ = jbuilt
    reqs = make_requests(seed, 24, kw_frac=kw_frac)
    jreqs = jmake_requests(seed, 24, kw_frac=kw_frac)
    for (t, e, k), (jt, je, jk) in zip(reqs, jreqs):
        assert t == jt and k == jk and np.array_equal(e, je)
    out = engine.search_batch(reqs, now=now)
    jout = jengine.search_batch(jreqs, now=jnow)
    assert [_dto(h) for h in out] == [_dto(h) for h in jout]
    assert all(len(h) == 10 for h in out)


def test_full_host_scan_on_compact_index(built, jbuilt):
    """The exact host scan reads the compact rows (materialized int8 *
    scale), as the JAX package's does, and agrees with the served batch."""
    engine, make_requests, now, _ = built
    jengine = jbuilt[0]
    reqs = make_requests(41, 6, kw_frac=0.5)
    served = engine.search_batch(reqs, now=now)
    for (text, emb, k), hits in zip(reqs, served):
        full = engine._search_full_host(text, emb, k, 0, now)
        jfull = jengine._search_full_host(text, emb, k, 0, now)
        assert _dto(full) == _dto(jfull) == _dto(hits)


def test_numpy_rescore_equals_native_int8_rescore(built, monkeypatch):
    engine, make_requests, now, _ = built
    from omni_recall_tpu_torch.ops import native

    dix = engine.device_index
    reqs = make_requests(5, 4, kw_frac=0.5)
    queries = [(t, e) for t, e, _ in reqs]
    rows = [np.arange(i * 1000, i * 1000 + 700, dtype=np.int64) for i in range(4)]
    assert native.rescore_available()
    got = engine._exact_rescore_rows(queries, rows, now, dix=dix)
    monkeypatch.setattr(native, "rescore_available", lambda: False)
    want = engine._exact_rescore_rows(queries, rows, now, dix=dix)
    for (ra, sa), (rb, sb) in zip(got, want):
        assert np.array_equal(ra, rb) and np.array_equal(sa.view(np.int64), sb.view(np.int64))
    sel = rows[0][:5]
    assert np.array_equal(
        dix.materialize_raw_rows(sel),
        dix.emb8_host[sel].astype(np.float32) * dix.scale_host[sel, None])
