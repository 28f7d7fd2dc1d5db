"""``UPLOAD_TICK`` and ``install_device_planes`` in the port's device index
(omni_recall_tpu_torch/index/device_index.py), as the JAX package's are held
in tests/test_snapshot.py: one tick a slab with the result bitwise, an abort
that propagates at tick 3, no tick on a single slab; an abort inside
``device_arrays()`` that leaves the host mirrors intact and the next
``device_arrays()`` bitwise a fresh index's; ``install_device_planes``
refusing a row count other than the capacity and clearing the dirty
blocks."""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.index import device_index as tdi
from omni_recall_tpu_torch.index.records import ChunkRecord

T0 = datetime(2025, 1, 1, tzinfo=timezone.utc)
DIM, BITS = 32, 256


class Abort(RuntimeError):
    pass


@pytest.fixture
def tick_hook():
    """Set ``UPLOAD_TICK`` for one test, and take it off after."""
    def put(fn):
        tdi.UPLOAD_TICK = fn
    yield put
    tdi.UPLOAD_TICK = None


def _abort_at(k: int, calls: dict):
    def tick():
        calls["n"] += 1
        if calls["n"] >= k:
            raise Abort("deadline")
    return tick


def test_upload_slabbed_ticks_once_a_slab_and_aborts(tick_hook):
    host = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    ticks = []
    tick_hook(lambda: ticks.append(1))
    # tiny slab_bytes forces many slabs; the result is bit-identical
    out = tdi.upload_slabbed(host, "cpu", slab_bytes=host.itemsize * 32 * 8)
    assert np.array_equal(out.numpy().view(np.uint32), host.view(np.uint32))
    assert len(ticks) == 8  # one tick a slab
    calls = {"n": 0}
    tick_hook(_abort_at(3, calls))
    with pytest.raises(Abort):
        tdi.upload_slabbed(host, "cpu", slab_bytes=host.itemsize * 32 * 8)
    assert calls["n"] == 3
    # a tick passed by the caller takes the hook's place
    own = []
    tdi.upload_slabbed(host, "cpu", slab_bytes=host.itemsize * 32 * 8,
                       tick=lambda: own.append(1))
    assert len(own) == 8 and calls["n"] == 3


def test_single_slab_and_no_hook_do_not_tick(tick_hook):
    host = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    assert tdi.UPLOAD_TICK is None  # off by default
    out = tdi.upload_slabbed(host, "cpu", slab_bytes=host.itemsize * 32 * 8)
    assert np.array_equal(out.numpy(), host)
    ticks = []
    tick_hook(lambda: ticks.append(1))
    out = tdi.upload_slabbed(host, "cpu")  # one slab: the fast path
    assert np.array_equal(out.numpy(), host) and not ticks


def _rows(seed: int, n: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _loaded(emb: np.ndarray, **kw) -> tdi.DeviceIndex:
    n = emb.shape[0]
    ix = tdi.DeviceIndex(DIM, capacity_block=256, bloom_bits=BITS, scan_dtype="int8",
                         refine=True, exact_cos=True, device="cpu", **kw)
    bloom = np.random.default_rng(1).integers(0, 256, size=(n, BITS // 8), dtype=np.uint8)
    meta = [ChunkRecord(id=f"c{i}", document_id="d", chunk_index=i, content=f"row {i}",
                        embedding=emb[i], created_at_utc=T0, seq=i) for i in range(n)]
    ix.bulk_load(emb, bloom, np.linspace(0, 30, n).astype(np.float32), meta)
    return ix


def _planes(dev) -> dict:
    return {f.name: getattr(dev, f.name).clone() for f in dataclasses.fields(dev)
            if getattr(dev, f.name) is not None}


def _same_planes(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("device_quantize", [False, True])
def test_abort_inside_device_arrays_leaves_the_index_dirty(tick_hook, monkeypatch,
                                                           device_quantize):
    """A full upload aborted at its third slab: the exception reaches the
    caller, the host mirrors are untouched, no planes are installed, and
    the next ``device_arrays()`` gives a fresh index's planes bitwise (by
    the host quantizer, and by ``device_quantize`` as at 2^16 rows and
    more)."""
    n = 512
    if device_quantize:
        monkeypatch.setattr(tdi.DeviceIndex, "_DEVICE_QUANTIZE_MIN_ROWS", 256)
    # slabs of 64 rows of DIM f32: every full plane upload takes 8 slabs
    real = tdi.upload_slabbed
    monkeypatch.setattr(tdi, "upload_slabbed",
                        lambda host, device, slab_bytes=64 << 20, tick=None: real(
                            host, device, slab_bytes=64 * DIM * 4, tick=tick))
    emb = _rows(2, n)
    ix = _loaded(emb.copy())
    mirrors = {k: np.array(getattr(ix, k), copy=True)
               for k in ("emb", "raw_emb", "bloom", "created", "valid", "raw_norm_sq")}
    calls = {"n": 0}
    tick_hook(_abort_at(3, calls))
    with pytest.raises(Abort):
        ix.device_arrays()
    assert calls["n"] == 3
    assert ix._device is None and ix._device_cap != ix._cap  # device-dirty
    for k, v in mirrors.items():
        assert np.array_equal(getattr(ix, k), v), k
    tick_hook(None)
    dev = ix.device_arrays()
    _same_planes(dev, _loaded(emb.copy()).device_arrays())
    # the planes stay installed: no re-upload
    assert ix.device_arrays() is dev


def test_abort_mid_reupload_after_a_growth_recovers(tick_hook, monkeypatch):
    """A capacity growth re-uploads everything (the growth drops the old
    planes); aborted, the index stays device-dirty, and the next call gives
    a fresh index's planes."""
    real = tdi.upload_slabbed
    monkeypatch.setattr(tdi, "upload_slabbed",
                        lambda host, device, slab_bytes=64 << 20, tick=None: real(
                            host, device, slab_bytes=64 * DIM * 4, tick=tick))
    emb = _rows(3, 300)
    ix = tdi.DeviceIndex(DIM, capacity_block=256, bloom_bits=BITS, scan_dtype="int8",
                         device="cpu")
    chunks = [ChunkRecord(id=f"c{i}", document_id="d", chunk_index=i, content=f"row {i}",
                          embedding=emb[i].tolist(), created_at_utc=T0, seq=i)
              for i in range(300)]
    ix.append(chunks[:200])
    ix.device_arrays()
    ix.append(chunks[200:])  # 256 -> 512 rows of capacity
    tick_hook(_abort_at(2, {"n": 0}))
    with pytest.raises(Abort):
        ix.device_arrays()
    assert ix._device is None and ix._device_cap != ix._cap == 512
    tick_hook(None)
    fresh = tdi.DeviceIndex(DIM, capacity_block=256, bloom_bits=BITS, scan_dtype="int8",
                            device="cpu")
    fresh.append(chunks)
    _same_planes(ix.device_arrays(), fresh.device_arrays())


def test_install_device_planes_checks_rows_and_clears_dirty_blocks():
    n = 300  # capacity 512: pad rows
    emb = _rows(4, n)
    ix = _loaded(emb.copy())
    assert ix._cap == 512 and ix._dirty_blocks
    want = _planes(_loaded(emb.copy()).device_arrays())
    short = tdi.DeviceArrays(**{k: v[:n] for k, v in want.items()})
    with pytest.raises(ValueError, match="capacity"):
        ix.install_device_planes(short)
    assert ix._device is None and ix._dirty_blocks  # nothing adopted
    planes = tdi.DeviceArrays(**want)
    ix.install_device_planes(planes)
    assert not ix._dirty_blocks and ix._device_cap == ix._cap
    # adopted as they are: the sync path short-circuits
    assert ix.device_arrays() is planes
    assert planes.emb.data_ptr() == want["emb"].data_ptr()
