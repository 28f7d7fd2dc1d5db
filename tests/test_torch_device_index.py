"""The port's DeviceIndex against the JAX DeviceIndex (int8 layout, raw
plane for the device-exact cosine; without and with the residual refine
planes; f32 and bf16 scan storage), on the CPU. bf16 planes are compared
through their bits (uint16)."""

from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.index import device_index as jdi
from omni_recall_tpu.index.records import ChunkRecord as JChunk
from omni_recall_tpu_torch.index import device_index as tdi
from omni_recall_tpu_torch.index.records import ChunkRecord as TChunk

DIM = 64
T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _rows(seed, n, start=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(start, start + n):
        emb = rng.standard_normal(DIM).astype(np.float32)
        if i % 17 == 5:
            emb = np.zeros(DIM, np.float32)  # zero-norm chunk
        out.append((f"c{i}", f"doc{i % 5}", f"chunk {i} text {i * 7 % 13}",
                    emb.tolist(), T0 + timedelta(hours=i)))
    return out


def _chunks(cls, rows):
    return [cls(id=cid, document_id=doc, chunk_index=i, content=text, embedding=emb,
                created_at_utc=ts, seq=i) for i, (cid, doc, text, emb, ts) in enumerate(rows)]


def _pair(capacity_block=256, refine=False, scan_dtype="int8"):
    kw = dict(capacity_block=capacity_block, bloom_bits=256, ngram=4, bloom_hashes=2,
              scan_dtype=scan_dtype, refine=refine, exact_cos=True)
    return jdi.DeviceIndex(DIM, **kw), tdi.DeviceIndex(DIM, device="cpu", **kw)


def _planes_equal(jdev, tdev, err_ulps=0):
    for name in tdi.PLANES:
        j, t = getattr(jdev, name), getattr(tdev, name)
        assert (j is None) == (t is None), name
        if j is None:
            continue
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert j.dtype.name == "bfloat16", name
            j, t = j.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16)
        else:
            t = t.numpy()
        if name in ("err", "err2") and err_ulps:
            assert np.all(np.abs(j - t) <= err_ulps * np.spacing(j)), name
        else:
            assert _eq(j, t), name


@pytest.mark.parametrize("d", [768, 128])
def test_device_quantize_matches_jax(d):
    """The full-upload quantizer (large indexes): emb and scale bitwise; err
    within 2 ulp — XLA's CPU compiler orders the fused sum of squares its
    own way, and any order is sound (the bound's 1e-4 relative slack is
    ~1000x an ulp)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((512, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[3] = 0.0
    j = jdi._device_quantize_keep(jnp.asarray(x), False)
    t = tdi.device_quantize(torch.from_numpy(x), slab_rows=200)
    for name in ("emb", "scale"):
        assert _eq(np.asarray(j[name]), t[name].numpy()), name
    je, te = np.asarray(j["err"]), t["err"].numpy()
    assert np.all(np.abs(je - te) <= 2 * np.spacing(je))
    assert (je == te).mean() > 0.95


def test_append_delete_window_match_jax():
    jix, tix = _pair()
    rows = _rows(1, 300)
    jix.append(_chunks(JChunk, rows[:200]))
    tix.append(_chunks(TChunk, rows[:200]))
    _planes_equal(jix.device_arrays(), tix.device_arrays())
    jix.append(_chunks(JChunk, rows[200:]))  # grows capacity: full re-upload
    tix.append(_chunks(TChunk, rows[200:]))
    assert jix.delete_document("doc2") == tix.delete_document("doc2") > 0
    _planes_equal(jix.device_arrays(), tix.device_arrays())
    more = _rows(2, 20, start=300)
    jix.append(_chunks(JChunk, more))  # dirty-slab sync, in place
    tix.append(_chunks(TChunk, more))
    jix.delete_document("doc4")
    tix.delete_document("doc4")
    assert (jix.n_rows, jix.n_valid, jix.update_seq) == (tix.n_rows, tix.n_valid, tix.update_seq)
    _planes_equal(jix.device_arrays(), tix.device_arrays())
    for name in ("raw_emb", "raw_norm_sq", "created_us", "created_ts", "seqs", "valid",
                 "content_off"):
        assert _eq(getattr(jix, name), getattr(tix, name)), name
    assert bytes(jix._arena) == bytes(tix._arena)
    for window in (0, 1, 7, 50, 199, 250, 10_000):
        assert jix.window_start_row(window) == tix.window_start_row(window), window


def test_update_embedding_bumps_seq_and_syncs_in_place():
    jix, tix = _pair()
    rows = _rows(3, 40)
    jix.append(_chunks(JChunk, rows))
    tix.append(_chunks(TChunk, rows))
    tdev = tix.device_arrays()
    jix.device_arrays()
    new = np.random.default_rng(4).standard_normal(DIM).astype(np.float32).tolist()
    assert jix.update_embedding("c7", new) and tix.update_embedding("c7", new)
    assert tix.update_seq == jix.update_seq == 1
    tdev2 = tix.device_arrays()
    assert tdev2.emb is tdev.emb  # dirty blocks are copied into the same tensors
    _planes_equal(jix.device_arrays(), tdev2)


def test_from_numpy_planes_holds_the_same_bits():
    jix, _ = _pair(capacity_block=128)
    rows = _rows(5, 300)
    jchunks = _chunks(JChunk, rows)
    jix.append(jchunks)
    jix.delete_document("doc1")
    jdev = jix.device_arrays()
    planes = {k: np.asarray(getattr(jdev, k)) for k in tdi.PLANES
              if getattr(jdev, k) is not None}
    by_id = {c.id: c for c in _chunks(TChunk, rows)}
    meta = [None if m is None else by_id[m.id] for m in jix.meta]
    tix = tdi.DeviceIndex.from_numpy_planes(
        planes, meta, device="cpu", capacity_block=128, bloom_bits=256, ngram=4,
        bloom_hashes=2)
    _planes_equal(jdev, tix.device_arrays())
    # host mirrors: equal on live rows (tombstones carry no record to
    # re-derive from; they are never read — valid is False there)
    live = [r for r, m in enumerate(jix.meta) if m is not None]
    for name in ("raw_emb", "raw_norm_sq", "created_us", "created_ts", "seqs", "valid",
                 "bloom", "emb", "created"):
        assert _eq(getattr(jix, name)[live], getattr(tix, name)[live]), name
    assert _eq(jix.valid, tix.valid)
    assert (tix.n_rows, tix.n_valid) == (jix.n_rows, jix.n_valid)
    for r in live[:20]:
        lo, hi = tix.content_off[r], tix.content_off[r + 1]
        assert bytes(tix._arena[lo:hi]) == jix.meta[r].content_lower_utf8()
    assert tix.window_start_row(100) == jix.window_start_row(100)
    # a later append re-quantizes only its dirty block, from the same mirrors
    more = _rows(6, 10, start=300)
    jix.append(_chunks(JChunk, more))
    tix.append(_chunks(TChunk, more))
    _planes_equal(jix.device_arrays(), tix.device_arrays())


def test_bulk_load_quantizes_on_device_above_threshold(monkeypatch):
    """Full uploads at >= the threshold quantize with device_quantize (the
    JAX _device_quantize_impl) and keep the aliased raw plane."""
    monkeypatch.setattr(tdi.DeviceIndex, "_DEVICE_QUANTIZE_MIN_ROWS", 256)
    monkeypatch.setattr(jdi.DeviceIndex, "_DEVICE_QUANTIZE_MIN_ROWS", 256)
    rng = np.random.default_rng(7)
    n = 512
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bloom = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    created = np.linspace(0, 30, n).astype(np.float32)
    out = []
    for mod, cls, kw in ((jdi, JChunk, {}), (tdi, TChunk, {"device": "cpu"})):
        ix = mod.DeviceIndex(DIM, capacity_block=256, bloom_bits=256, scan_dtype="int8",
                             exact_cos=True, **kw)
        meta = [cls(id=f"b{i}", document_id="b", chunk_index=i, content=f"row {i}",
                    embedding=emb[i], created_at_utc=T0, seq=i) for i in range(n)]
        ix.bulk_load(emb.copy(), bloom, created, meta)
        out.append(ix.device_arrays())
    _planes_equal(*out, err_ulps=2)


def test_refine_planes_follow_every_write_path():
    """refine=True: the residual plane (emb2, scale2, err2) is installed by
    the full upload, the dirty-block sync, update_embedding and deletes,
    bit for bit the JAX index's (host quantizer below the device-quantize
    threshold)."""
    jix, tix = _pair(refine=True)
    assert tix.refine
    rows = _rows(11, 300)
    jix.append(_chunks(JChunk, rows[:200]))
    tix.append(_chunks(TChunk, rows[:200]))
    tdev = tix.device_arrays()
    assert tdev.emb2 is not None and tdev.emb2.dtype == torch.int8
    _planes_equal(jix.device_arrays(), tdev)
    jix.append(_chunks(JChunk, rows[200:]))  # grows capacity: full re-upload
    tix.append(_chunks(TChunk, rows[200:]))
    _planes_equal(jix.device_arrays(), tix.device_arrays())
    more = _rows(12, 20, start=300)
    jix.append(_chunks(JChunk, more))  # dirty-slab sync, in place
    tix.append(_chunks(TChunk, more))
    new = np.random.default_rng(13).standard_normal(DIM).astype(np.float32).tolist()
    assert jix.update_embedding("c9", new) and tix.update_embedding("c9", new)
    assert jix.delete_document("doc3") == tix.delete_document("doc3") > 0
    tdev2 = tix.device_arrays()
    assert tdev2.emb2 is tix.device_arrays().emb2
    _planes_equal(jix.device_arrays(), tdev2)


def test_from_numpy_planes_carries_the_residual_plane():
    jix, _ = _pair(capacity_block=128, refine=True)
    rows = _rows(14, 200)
    jix.append(_chunks(JChunk, rows))
    jdev = jix.device_arrays()
    planes = {k: np.asarray(getattr(jdev, k)) for k in tdi.PLANES}
    by_id = {c.id: c for c in _chunks(TChunk, rows)}
    tix = tdi.DeviceIndex.from_numpy_planes(
        planes, [by_id[m.id] for m in jix.meta], device="cpu", capacity_block=128,
        bloom_bits=256, ngram=4, bloom_hashes=2)
    assert tix.refine
    _planes_equal(jdev, tix.device_arrays())
    more = _rows(15, 10, start=200)
    jix.append(_chunks(JChunk, more))
    tix.append(_chunks(TChunk, more))
    _planes_equal(jix.device_arrays(), tix.device_arrays())


def test_bulk_load_quantizes_residual_plane_on_device(monkeypatch):
    """refine=True full uploads at >= the threshold: device_quantize's
    residual plane against _device_quantize_impl(refine=True)."""
    monkeypatch.setattr(tdi.DeviceIndex, "_DEVICE_QUANTIZE_MIN_ROWS", 256)
    monkeypatch.setattr(jdi.DeviceIndex, "_DEVICE_QUANTIZE_MIN_ROWS", 256)
    rng = np.random.default_rng(16)
    n = 512
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bloom = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    created = np.linspace(0, 30, n).astype(np.float32)
    out = []
    for mod, cls, kw in ((jdi, JChunk, {}), (tdi, TChunk, {"device": "cpu"})):
        ix = mod.DeviceIndex(DIM, capacity_block=256, bloom_bits=256, scan_dtype="int8",
                             refine=True, exact_cos=True, **kw)
        meta = [cls(id=f"b{i}", document_id="b", chunk_index=i, content=f"row {i}",
                    embedding=emb[i], created_at_utc=T0, seq=i) for i in range(n)]
        ix.bulk_load(emb.copy(), bloom, created, meta)
        out.append(ix.device_arrays())
    assert out[1].emb2 is not None
    _planes_equal(*out, err_ulps=2)


@pytest.mark.parametrize("scan_dtype", ["f32", "bf16"])
def test_scan_storage_follows_every_write_path(scan_dtype):
    """f32 / bf16 scan storage: the full upload, a capacity growth, the
    dirty-block sync, update_embedding and deletes leave the scan plane bit
    for bit the JAX index's (bf16: rounded to nearest, ties to even). Neither
    storage carries scale/err or the residual planes, even when refine is
    asked for: refine is int8-only in both packages."""
    jix, tix = _pair(refine=True, scan_dtype=scan_dtype)
    assert tix.refine is jix.refine is False
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[scan_dtype]
    rows = _rows(21, 300)
    jix.append(_chunks(JChunk, rows[:200]))
    tix.append(_chunks(TChunk, rows[:200]))
    tdev = tix.device_arrays()
    assert tdev.emb.dtype == dt
    assert tdev.scale is tdev.err is tdev.emb2 is None
    _planes_equal(jix.device_arrays(), tdev)
    jix.append(_chunks(JChunk, rows[200:]))  # grows capacity: full re-upload
    tix.append(_chunks(TChunk, rows[200:]))
    _planes_equal(jix.device_arrays(), tix.device_arrays())
    more = _rows(22, 20, start=300)
    jix.append(_chunks(JChunk, more))  # dirty-slab sync, in place
    tix.append(_chunks(TChunk, more))
    new = np.random.default_rng(23).standard_normal(DIM).astype(np.float32).tolist()
    assert jix.update_embedding("c9", new) and tix.update_embedding("c9", new)
    assert jix.update_embedding("c10", None) and tix.update_embedding("c10", None)
    assert jix.delete_document("doc2") == tix.delete_document("doc2") > 0
    emb_before = tix.device_arrays().emb
    _planes_equal(jix.device_arrays(), tix.device_arrays())
    assert tix.device_arrays().emb is emb_before  # synced in place


@pytest.mark.parametrize("scan_dtype", ["f32", "bf16"])
def test_bulk_load_converts_on_device_above_threshold(monkeypatch, scan_dtype):
    """Full uploads at >= the threshold: bf16 rows are rounded on the device,
    a slab at a time, to the bits the JAX index rounds on the host."""
    monkeypatch.setattr(tdi.DeviceIndex, "_DEVICE_QUANTIZE_MIN_ROWS", 256)
    monkeypatch.setattr(tdi.DeviceIndex, "_BF16_SLAB_ROWS", 192)
    rng = np.random.default_rng(24)
    n = 512
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    # values half-way between bf16 neighbours: ties go to the even one
    emb[0, :4] = [1 + 2.0**-8, 1 + 3 * 2.0**-8, -(1 + 2.0**-8), 0.5 + 2.0**-10]
    bloom = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    created = np.linspace(0, 30, n).astype(np.float32)
    out = []
    for mod, cls, kw in ((jdi, JChunk, {}), (tdi, TChunk, {"device": "cpu"})):
        ix = mod.DeviceIndex(DIM, capacity_block=256, bloom_bits=256,
                             scan_dtype=scan_dtype, **kw)
        meta = [cls(id=f"b{i}", document_id="b", chunk_index=i, content=f"row {i}",
                    embedding=emb[i], created_at_utc=T0, seq=i) for i in range(n)]
        ix.bulk_load(emb.copy(), bloom, created, meta)
        out.append(ix.device_arrays())
    _planes_equal(*out)


@pytest.mark.parametrize("scan_dtype", ["f32", "bf16"])
def test_from_numpy_planes_takes_f32_and_bf16_planes(scan_dtype):
    """The JAX index's f32 or bf16 (ml_dtypes) planes install bit for bit,
    and later appends keep matching."""
    jix, _ = _pair(capacity_block=128, scan_dtype=scan_dtype)
    rows = _rows(25, 200)
    jix.append(_chunks(JChunk, rows))
    jdev = jix.device_arrays()
    planes = {k: np.asarray(v) for k in tdi.PLANES if (v := getattr(jdev, k)) is not None}
    by_id = {c.id: c for c in _chunks(TChunk, rows)}
    tix = tdi.DeviceIndex.from_numpy_planes(
        planes, [by_id[m.id] for m in jix.meta], device="cpu", capacity_block=128,
        bloom_bits=256, ngram=4, bloom_hashes=2)
    assert tix.scan_dtype == scan_dtype and not tix.refine
    _planes_equal(jdev, tix.device_arrays())
    more = _rows(26, 10, start=200)
    jix.append(_chunks(JChunk, more))
    tix.append(_chunks(TChunk, more))
    _planes_equal(jix.device_arrays(), tix.device_arrays())
