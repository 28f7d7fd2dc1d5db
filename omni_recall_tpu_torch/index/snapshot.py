"""Index snapshot / restore (PyTorch port of omni_recall_tpu/index/snapshot.py).

The reference delegates durability to Cosmos/Blob and loses the in-memory
store on restart. Here persistence is first-class: ONE atomically renamed
archive holds the store AND, optionally, the device index's derived arrays,
so a restore is an array upload instead of a re-derivation.

Layout v3 (``FORMAT_VERSION``): a directory ``snapshot.d`` holding
``meta.json`` (documents, version, per-chunk string dictionaries) and one
``.npy`` per array, swapped in with directory renames:
- chunk columns — ids/contents as byte arenas + offsets, doc index, chunk
  index, seq, exact integer-microsecond timestamps, and all chunk
  embeddings as a flat f64 array + offsets (ragged-safe). f64 keeps the
  oracle/host float64 scoring bit-identical across a restore; restored
  records hold zero-copy views into the flat array.
- optional device slabs (``save_snapshot(..., device_index=...)``) — the
  bloom planes, int8 quantization planes (+ the residual refine plane), the
  exact-rescore mirrors and the recency/tie-break columns, in store seq
  order, with the producing parameters (``SLAB_VERSION``). Restoring them
  (``restore_engine``) skips bloom hashing and re-quantization entirely. A
  sampled integrity check verifies K random rows (bloom signatures,
  recency/tie-break columns and the lowercased arena bit-compared against a
  re-derivation; quantization planes checked for SOUNDNESS — f64 residual
  norms within the stored error bounds) and falls back to the full rebuild
  on any mismatch or malformed array, so a stale or foreign slab can never
  produce an unsound index. A failure of the card is no such mismatch: it
  propagates (``device.is_device_error``).

Arrays load as copy-on-write memmaps: restore pays page-in only for what it
touches. The JAX package reads and writes the same layout, so either
package restores the other's snapshots. The legacy layouts (v1/v2
single-archive ``snapshot.npz``, and the two-file meta.json +
embeddings.npz) still load.

``load_snapshot`` rebuilds the host store with identical seq ordering, so a
restored device index reproduces bit-identical rankings (rows are appended
in (created_at, seq) order)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np

from omni_recall_tpu_torch.contracts import iso_utc
from omni_recall_tpu_torch.device import is_device_error
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore

FORMAT_VERSION = 3
# bumped when the signature/quantization derivation changes incompatibly —
# slabs from another derivation version fall back to the full rebuild
# (v2: f32-evaluated quantization error bounds, ops/quantize.py)
SLAB_VERSION = 2

_EPOCH70 = datetime(1970, 1, 1, tzinfo=timezone.utc)
_INTEGRITY_SAMPLE = 64

logger = logging.getLogger(__name__)


def _parse_dt(value: str | None) -> datetime | None:
    if not value:
        return None
    return datetime.fromisoformat(value.replace("Z", "+00:00"))


def _collect(store: InMemoryIngestionStore):
    # one consistent read: the store's lock makes the documents and their
    # chunk lists a single atomic view (no ghost document whose chunks a
    # concurrent delete removed)
    lock = getattr(store, "_lock", None) or contextlib.nullcontext()
    with lock:
        documents = store.list_documents(2**31 - 1)
        chunks: list[ChunkRecord] = []
        for doc in documents:
            chunks.extend(store.get_chunks_by_document_id(doc.id))
    chunks.sort(key=lambda c: c.seq)
    return documents, chunks


def _byte_arena(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in items], out=off[1:])
    return np.frombuffer(b"".join(items), dtype=np.uint8), off


def save_snapshot(
    store: InMemoryIngestionStore,
    path: str | Path,
    device_index=None,
) -> None:
    """Write ``<path>/snapshot.d`` atomically. When ``device_index`` is
    given and covers every live chunk, its derived arrays are embedded so a
    matching engine restores without re-deriving (see restore_engine). A
    compact bulk index (serving-only) cannot be snapshotted."""
    if device_index is not None and device_index.host_compact:
        raise RuntimeError("compact bulk index is serving-only (bulk_load_compact)")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    documents, chunks = _collect(store)
    n = len(chunks)

    ids_arena, ids_off = _byte_arena([c.id.encode("utf-8") for c in chunks])
    contents_arena, contents_off = _byte_arena(
        [c.content.encode("utf-8", errors="surrogatepass") for c in chunks]
    )
    doc_order = {d.id: i for i, d in enumerate(documents)}
    doc_idx = np.asarray([doc_order[c.document_id] for c in chunks], dtype=np.int32)
    chunk_index = np.asarray([c.chunk_index for c in chunks], dtype=np.int32)
    seq = np.asarray([c.seq for c in chunks], dtype=np.int64)
    has_created = np.asarray([c.created_at_utc is not None for c in chunks], dtype=bool)
    created_us = np.asarray(
        [_to_us(c.created_at_utc) if c.created_at_utc is not None else 0 for c in chunks],
        dtype=np.int64,
    )
    # string dictionaries for the (practically constant) cosmos-shape fields
    pk_values = sorted({c.partition_key for c in chunks}) or ["user:default"]
    type_values = sorted({c.type for c in chunks}) or ["chunk"]
    pk_idx = np.asarray([pk_values.index(c.partition_key) for c in chunks], dtype=np.int16)
    type_idx = np.asarray([type_values.index(c.type) for c in chunks], dtype=np.int16)

    flat: list[np.ndarray] = []
    offsets = np.zeros(n + 1, dtype=np.int64)
    has_emb = np.zeros(n, dtype=bool)
    for i, chunk in enumerate(chunks):
        # f64: the oracle/host paths score the RAW embedding values in
        # float64, so an f32 round-trip would shift post-restore scores in
        # the low bits (near-ties could swap rank across a restart)
        e = chunk.embedding
        has_emb[i] = e is not None
        vec = (
            np.asarray(e, dtype=np.float64)
            if e is not None else np.zeros(0, dtype=np.float64)
        )
        flat.append(vec)
        offsets[i + 1] = offsets[i] + vec.size
    emb_flat = np.concatenate(flat) if flat else np.zeros(0, dtype=np.float64)

    meta = {
        "version": FORMAT_VERSION,
        "documents": [
            {
                "id": d.id, "fileName": d.file_name, "sourceType": d.source_type,
                "blobPath": d.blob_path, "contentHash": d.content_hash,
                "chunkCount": d.chunk_count,
                "createdAtUtc": iso_utc(d.created_at_utc) if d.created_at_utc else None,
            }
            for d in documents
        ],
        "pk_values": pk_values,
        "type_values": type_values,
        "n_chunks": n,
    }

    arrays = {
        "ids_arena": ids_arena, "ids_off": ids_off,
        "contents_arena": contents_arena, "contents_off": contents_off,
        "doc_idx": doc_idx, "chunk_index": chunk_index, "seq": seq,
        "has_created": has_created, "created_us": created_us,
        "pk_idx": pk_idx, "type_idx": type_idx,
        "emb_flat": emb_flat, "offsets": offsets, "has_emb": has_emb,
    }

    slabs = _gather_slabs(device_index, chunks) if device_index is not None else None
    if slabs is not None:
        meta["slabs"] = slabs.pop("params")
        arrays.update({f"slab_{k}": v for k, v in slabs.items()})

    # ONE archive directory + directory renames: meta and arrays are
    # written fully into a temp dir, then swapped in — a crash mid-save
    # leaves the previous good snapshot untouched (at worst a fully written
    # snapshot.d.old survives alongside, which the loader also accepts).
    # Uncompressed .npy members let the loader memmap them.
    tmp = path / f".snapshot.{os.getpid()}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    (tmp / "meta.json").write_text(json.dumps(meta), encoding="utf-8")
    for k, v in arrays.items():
        np.save(tmp / f"{k}.npy", v)
    final = path / "snapshot.d"
    old = path / f"snapshot.d.old.{os.getpid()}"
    if final.exists():
        os.replace(final, old)
    os.replace(tmp, final)
    if old.exists():
        shutil.rmtree(old)
    # clean up legacy layouts so stale versions can't be loaded
    for legacy in ("meta.json", "embeddings.npz", "snapshot.npz"):
        with contextlib.suppress(OSError):
            (path / legacy).unlink()


def _to_us(dt: datetime | None) -> int:
    from omni_recall_tpu_torch.index.device_index import to_micros

    return to_micros(dt)


def _gather_slabs(dix, chunks: list[ChunkRecord]) -> dict | None:
    """Derived arrays for the store's live chunks, in seq order, from the
    device index. Returns None (slabs omitted, restore falls back to the
    rebuild) when the index doesn't cover the chunk list exactly.

    The quantization planes come from (cheapest first):
    1. the planes a snapshot restore staged (``_preconverted``), while no
       mutation has touched them — no work;
    2. the LIVE device planes, read back with one ``.cpu()`` per plane (a
       gather on the device first when the snapshot covers a subset of the
       rows) — exactly what the scan and refine kernels score against;
    3. host re-quantization of the normalized mirrors (rows mutated since
       the last device sync)."""
    import torch

    from omni_recall_tpu_torch.index.device_index import _QUANT_PLANES
    from omni_recall_tpu_torch.ops.quantize import (
        quantize_rows_int8,
        quantize_rows_int8_residual,
    )

    if dix.scan_dtype != "int8":
        return None  # f32/bf16 restores re-upload the mirrors anyway
    # the archive's plane keys, in the quantizers' output order
    keys = ("q1", "s1", "e1", "q2", "s2", "e2")[: 6 if dix.refine else 3]
    names = _QUANT_PLANES[: len(keys)]
    with dix._lock:
        rows = []
        for c in chunks:
            r = dix._row_by_chunk_id.get(c.id)
            if r is None or not dix.valid[r]:
                return None
            rows.append(r)
        rows = np.asarray(rows, dtype=np.int64)
        emb_norm = dix.emb[rows]
        bloom = dix.bloom[rows]
        created = dix.created[rows]
        created_ts = dix.created_ts[rows]
        raw_emb = dix.raw_emb[rows]
        raw_norm_sq = dix.raw_norm_sq[rows]
        lower = [
            bytes(dix._arena[dix.content_off[r] : dix.content_off[r + 1]])
            for r in rows
        ]
        # capture the plane sources under the lock; the readback runs
        # outside it. A staged plane set is stale once a mutation since the
        # restore left dirty blocks; the device planes must be current.
        pre = dix._preconverted
        if pre is not None and (
            pre["emb"].shape[0] < dix.n_rows
            or bool(dix.refine) != ("emb2" in pre)
            or dix._dirty_blocks
        ):
            pre = None
        dev = None
        if pre is None:
            dev = dix._device
            # a row-sharded index's snapshot quantizes its mirrors on the
            # host, the quantizer of its own uploads
            if (
                dev is None or dix.mesh is not None or dix._device_cap != dix._cap
                or dix._dirty_blocks or dev.scale is None
                or (dix.refine and dev.emb2 is None)
            ):
                dev = None
            else:
                dev_planes = [getattr(dev, k) for k in names]
        n_rows_snap = dix.n_rows
    lower_arena, lower_off = _byte_arena(lower)
    out = {
        "emb_norm": emb_norm, "bloom": bloom,
        "created": created, "created_ts": created_ts,
        # persisted exact-rescore mirrors: a v3 restore adopts these as
        # copy-on-write memmaps instead of re-deriving them from the store
        "raw_emb": raw_emb, "raw_norm_sq": raw_norm_sq,
        "lower_arena": lower_arena, "lower_off": lower_off,
    }
    if pre is not None:
        deriv = "staged"
        out.update({k: pre[name][rows] for k, name in zip(keys, names)})
    elif dev is not None:
        deriv = "device"
        if len(rows) == n_rows_snap and np.array_equal(rows, np.arange(n_rows_snap)):
            parts = [p[:n_rows_snap] for p in dev_planes]
        else:
            # the snapshot covers a subset of the index rows: gather ON THE
            # DEVICE so the readback moves only the snapshot's rows
            rows_d = torch.from_numpy(rows).to(dev_planes[0].device)
            parts = [p.index_select(0, rows_d) for p in dev_planes]
        out.update({k: p.cpu().numpy() for k, p in zip(keys, parts)})
    elif dix.refine:
        deriv = "host"
        out.update(zip(keys, quantize_rows_int8_residual(emb_norm)))
    else:
        deriv = "host"
        out.update(zip(keys, quantize_rows_int8(emb_norm)))
    out["params"] = {
        "deriv": deriv,
        "slab_version": SLAB_VERSION,
        "dim": dix.dim, "bloom_bits": dix.bloom_bits, "ngram": dix.ngram,
        "bloom_hashes": dix.bloom_hashes, "scan_dtype": dix.scan_dtype,
        "refine": dix.refine,
    }
    return out


def snapshot_exists(path: str | Path) -> bool:
    """True when ``path`` holds a loadable snapshot in ANY supported layout
    (v3 directory, crash-leftover .old directory, v1/v2 archives)."""
    path = Path(path)
    return (
        (path / "snapshot.d").is_dir()
        or any(path.glob("snapshot.d.old.*"))
        or (path / "snapshot.npz").is_file()
        or (path / "meta.json").is_file()
    )


def load_snapshot(path: str | Path) -> InMemoryIngestionStore:
    store, _ = load_snapshot_full(path)
    return store


def load_snapshot_full(path: str | Path):
    """Returns (store, aux). ``aux`` is None for v1 snapshots; for v2/v3 it
    carries the raw arrays (chunk list in seq order, flat f64 embeddings,
    slab arrays when present) that restore_engine uses for the fast path."""
    path = Path(path)
    snap_dir = path / "snapshot.d"
    if not snap_dir.is_dir():
        # crash between the two save renames: accept a fully written .old
        olds = sorted(path.glob("snapshot.d.old.*"))
        if olds:
            snap_dir = olds[-1]
    bundle = path / "snapshot.npz"
    if snap_dir.is_dir():
        meta = json.loads((snap_dir / "meta.json").read_text(encoding="utf-8"))
        # copy-on-write memmap: opening is O(1); pages fault in on first
        # touch and writes never reach the snapshot files
        arrays = {p.stem: np.load(p, mmap_mode="c") for p in snap_dir.glob("*.npy")}
    elif bundle.is_file():
        # v1/v2 single-archive layout (the NpzFile is closed on exit)
        with np.load(bundle) as npz:
            meta = json.loads(bytes(npz["meta_json"].tobytes()).decode("utf-8"))
            arrays = {k: npz[k] for k in npz.files if k != "meta_json"}
    else:  # legacy two-file layout (pre-atomic-save snapshots)
        meta = json.loads((path / "meta.json").read_text(encoding="utf-8"))
        with np.load(path / "embeddings.npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
    version = meta.get("version")
    if version == 1:
        return _load_v1(meta, arrays), None
    if version not in (2, FORMAT_VERSION):
        raise ValueError(f"Unsupported snapshot version: {version}")

    documents = [
        DocumentRecord(
            id=d["id"], file_name=d["fileName"], source_type=d["sourceType"],
            blob_path=d["blobPath"], content_hash=d["contentHash"],
            chunk_count=d["chunkCount"], created_at_utc=_parse_dt(d["createdAtUtc"]),
        )
        for d in meta["documents"]
    ]
    n = int(meta["n_chunks"])
    ids_b = arrays["ids_arena"].tobytes()
    ids_off = arrays["ids_off"]
    contents_b = arrays["contents_arena"].tobytes()
    contents_off = arrays["contents_off"]
    doc_idx = arrays["doc_idx"]
    chunk_index = arrays["chunk_index"]
    seq = arrays["seq"]
    has_created = arrays["has_created"]
    created_us = arrays["created_us"]
    pk_values = meta["pk_values"]
    type_values = meta["type_values"]
    pk_idx = arrays["pk_idx"]
    type_idx = arrays["type_idx"]
    emb_flat, offsets, has_emb = arrays["emb_flat"], arrays["offsets"], arrays["has_emb"]

    doc_ids = [d.id for d in documents]
    chunks: list[ChunkRecord] = []
    chunks_by_doc: dict[str, list[ChunkRecord]] = {d.id: [] for d in documents}
    for i in range(n):
        cid = ids_b[ids_off[i] : ids_off[i + 1]].decode("utf-8")
        content = contents_b[contents_off[i] : contents_off[i + 1]].decode(
            "utf-8", errors="surrogatepass"
        )
        # exact integer-microsecond reconstruction (timedelta arithmetic:
        # no float rounding, unlike fromtimestamp)
        created = (
            _EPOCH70 + timedelta(microseconds=int(created_us[i]))
            if has_created[i] else None
        )
        doc_id = doc_ids[doc_idx[i]]
        rec = ChunkRecord(
            id=cid, document_id=doc_id, chunk_index=int(chunk_index[i]),
            content=content,
            # zero-copy f64 view: every consumer handles array sequences
            embedding=emb_flat[offsets[i] : offsets[i + 1]] if has_emb[i] else None,
            created_at_utc=created,
            partition_key=pk_values[pk_idx[i]],
            type=type_values[type_idx[i]],
            seq=int(seq[i]),
        )
        chunks.append(rec)
        chunks_by_doc.setdefault(doc_id, []).append(rec)

    store = InMemoryIngestionStore()
    # per-document lists were accumulated in global seq order; the store
    # contract wants chunk_index order (they differ for documents whose
    # chunk ids were ever replaced). sorted() is stable.
    for doc_chunks in chunks_by_doc.values():
        doc_chunks.sort(key=lambda c: c.chunk_index)
    store.bulk_restore(documents, chunks_by_doc, next_seq=int(seq.max()) + 1 if n else 0)

    aux = {
        "meta": meta,
        "chunks": chunks,  # seq order (save order)
        "emb_flat": emb_flat, "offsets": offsets, "has_emb": has_emb,
        "seq": seq, "created_us": created_us, "has_created": has_created,
        "slabs": (
            {k[5:]: v for k, v in arrays.items() if k.startswith("slab_")}
            | {"params": meta["slabs"]}
            if "slabs" in meta else None
        ),
    }
    return store, aux


def _load_v1(meta: dict, arrays: dict) -> InMemoryIngestionStore:
    emb_flat, offsets, has_emb = arrays["emb_flat"], arrays["offsets"], arrays["has_emb"]
    store = InMemoryIngestionStore()
    for d in meta["documents"]:
        store.upsert_document(
            DocumentRecord(
                id=d["id"], file_name=d["fileName"], source_type=d["sourceType"],
                blob_path=d["blobPath"], content_hash=d["contentHash"],
                chunk_count=d["chunkCount"], created_at_utc=_parse_dt(d["createdAtUtc"]),
            )
        )
    chunks: list[ChunkRecord] = []
    for i, c in enumerate(meta["chunks"]):
        vec = emb_flat[offsets[i] : offsets[i + 1]]
        chunks.append(
            ChunkRecord(
                id=c["id"], document_id=c["documentId"], chunk_index=c["chunkIndex"],
                content=c["content"],
                embedding=vec.tolist() if bool(has_emb[i]) else None,
                created_at_utc=_parse_dt(c["createdAtUtc"]),
                seq=c["seq"],
            )
        )
    store.upsert_chunks(chunks)  # seq preserved: records carry their seq
    store._seq = max((c.seq for c in chunks), default=-1) + 1
    return store


def restore_engine(store: InMemoryIngestionStore, engine, aux=None) -> str:
    """Rebuild the engine's device index from a restored store, preserving
    row order, and return the route taken: ``"slabs"`` (bulk-loaded from
    the persisted derived arrays — no bloom hashing, no re-quantization, no
    per-chunk append) or ``"rebuild"`` (the exact rebuild).

    The slab route needs ``aux`` from load_snapshot_full (v2/v3 with slabs),
    matching engine parameters and a passing integrity sample; a mismatch
    or a malformed array falls back to the rebuild. A failure of the card
    (out of memory, a failed launch) propagates instead."""
    if aux is not None and aux.get("slabs") is not None:
        try:
            ok = _try_restore_slabs(store, engine, aux)
        except Exception as exc:
            if is_device_error(exc):
                raise
            # malformed/truncated arrays raise (shape errors from
            # load_slabs, decode errors, ...): degrade to the exact rebuild.
            # load_slabs validates shapes BEFORE mutating, so the index is
            # still empty here and the rebuild below is safe.
            logger.exception("snapshot slab restore raised; rebuilding")
            ok = False
        if ok:
            return "slabs"
        logger.warning(
            "snapshot slabs unusable (parameter/integrity mismatch); "
            "falling back to full index rebuild"
        )
    chunks: list[ChunkRecord] = []
    for doc in store.list_documents(2**31 - 1):
        chunks.extend(store.get_chunks_by_document_id(doc.id))
    chunks.sort(key=lambda c: c.seq)
    engine.on_chunks_upserted(chunks, new=True)
    return "rebuild"


def _try_restore_slabs(store, engine, aux) -> bool:
    from omni_recall_tpu_torch.index.device_index import _aware, to_days
    from omni_recall_tpu_torch.ops import hashing
    from omni_recall_tpu_torch.ops.oracle import lower_invariant

    dix = engine.device_index
    if dix is None or dix.n_rows != 0 or dix.host_compact:
        return False
    slabs = aux["slabs"]
    p = slabs["params"]
    if (
        p.get("slab_version") != SLAB_VERSION
        or p.get("dim") != dix.dim
        or p.get("bloom_bits") != dix.bloom_bits
        or p.get("ngram") != dix.ngram
        or p.get("bloom_hashes") != dix.bloom_hashes
        or p.get("scan_dtype") != dix.scan_dtype
        or bool(p.get("refine")) != dix.refine
    ):
        return False
    chunks = aux["chunks"]
    n = len(chunks)
    if n == 0:
        return True  # nothing to load
    if slabs["q1"].shape[0] != n:
        return False
    emb_flat, offsets, has_emb = aux["emb_flat"], aux["offsets"], aux["has_emb"]
    sizes = np.diff(offsets)
    uniform = bool(np.all(sizes[has_emb] == dix.dim)) if has_emb.any() else True
    if not uniform:
        return False  # mixed-dimension embeddings: rare, use the rebuild

    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(n, size=min(_INTEGRITY_SAMPLE, n), replace=False))

    if "raw_emb" in slabs:
        # v3: mirrors persisted (adopted as copy-on-write memmaps). The
        # device bounds derive from emb_norm while the exact rescore reads
        # raw_emb, so the sample checks the raw <-> f64 store and raw <->
        # emb_norm relations as well as the derived planes below.
        emb_norm, raw_emb, raw_norm_sq = (
            slabs["emb_norm"], slabs["raw_emb"], slabs["raw_norm_sq"],
        )
        if emb_norm.shape != (n, dix.dim) or raw_emb.shape != (n, dix.dim):
            return False
        for i in sample:
            seg = emb_flat[offsets[i] : offsets[i + 1]].astype(np.float32)
            if has_emb[i] and seg.size == dix.dim:
                if not np.array_equal(seg, raw_emb[i]):
                    return False
                nsq = float(np.sum(seg * seg, dtype=np.float64))
                if nsq != float(raw_norm_sq[i]):
                    return False
                if nsq > 0.0:
                    unit = seg.astype(np.float64) / np.sqrt(nsq)
                    # tolerate the <= ~2-ulp difference between the f64
                    # divide and the f32 reciprocal normalization; the
                    # scan/refine error budgets cover far more
                    if not np.allclose(emb_norm[i].astype(np.float64), unit,
                                       rtol=5e-7, atol=1e-9):
                        return False
            elif np.any(raw_emb[i]) or raw_norm_sq[i] != 0.0 or np.any(emb_norm[i]):
                return False
    else:
        # v2 archives: derive the mirrors from the f64 store, as
        # DeviceIndex._normalize does (f32 cast -> f64 norm -> f64 divide)
        raw_emb = np.zeros((n, dix.dim), dtype=np.float32)
        raw_norm_sq = np.zeros(n, dtype=np.float64)
        emb_norm = np.zeros((n, dix.dim), dtype=np.float32)
        if has_emb.any():
            rows = np.nonzero(has_emb)[0]
            # emb-less chunks occupy zero-size segments, so emb_flat is the
            # concatenation of the embedded rows' vectors
            a = emb_flat.astype(np.float32).reshape(len(rows), dix.dim)
            nsq = np.sum(a * a, axis=1, dtype=np.float64)
            ok = nsq > 0.0
            normed = np.zeros_like(a)
            normed[ok] = (a[ok].astype(np.float64) / np.sqrt(nsq[ok])[:, None]).astype(
                np.float32)
            raw_emb[rows] = a
            raw_norm_sq[rows] = nsq
            emb_norm[rows] = normed

    # integrity sample: re-derive K rows and bit-compare against the slabs
    if (
        slabs["bloom"].shape != (n, dix.bloom_bits // 8)
        or slabs["created"].shape != (n,)
        or slabs["created_ts"].shape != (n,)
        or slabs["lower_off"].shape != (n + 1,)
        or int(slabs["lower_off"][0]) != 0
        or not bool(np.all(np.diff(slabs["lower_off"]) >= 0))
        or int(slabs["lower_off"][n]) != slabs["lower_arena"].shape[0]
    ):
        return False
    lows = [lower_invariant(chunks[i].content) for i in sample]
    sig = hashing.chunk_signatures_batch(lows, dix.bloom_bits, dix.ngram, dix.bloom_hashes)
    if not np.array_equal(sig, slabs["bloom"][sample]):
        return False
    # the recency column, the tie-break timestamps and the lowercased arena
    # feed the device recency term, the ranking and the exact keyword
    # rescore — a stale created column understates the scan's upper bound,
    # so they are part of the sample, not trusted from the archive
    lower_b = slabs["lower_arena"].tobytes()
    lower_off = slabs["lower_off"]
    for i, low in zip(sample, lows):
        c = chunks[i]
        if np.float32(to_days(c.created_at_utc)) != np.float32(slabs["created"][i]):
            return False
        if _aware(c.created_at_utc).timestamp() != float(slabs["created_ts"][i]):
            return False
        if (lower_b[int(lower_off[i]) : int(lower_off[i + 1])]
                != low.encode("utf-8", errors="surrogatepass")):
            return False
    # Quantization planes: SOUNDNESS, not bit-equality. Planes from the host
    # quantizer, the on-device quantizer or a device readback are
    # interchangeable but not bit-identical; the bounds stay sound for ANY
    # planes with
    #   || emb_norm[i] - q1[i]*s1[i] ||                <= e1[i]
    #   || emb_norm[i] - q1[i]*s1[i] - q2[i]*s2[i] ||  <= e2[i]
    # so the sample evaluates the residual norms in f64 against the bounds.
    plane_names = ("q1", "s1", "e1") + (("q2", "s2", "e2") if dix.refine else ())
    for name in plane_names:
        a = slabs.get(name)
        if a is None or a.shape[0] != n:
            return False
        if name[0] == "q":
            if a.dtype != np.int8 or a.shape != (n, dix.dim):
                return False
        elif a.dtype != np.float32 or a.ndim != 1:
            return False
    x = emb_norm[sample].astype(np.float64)
    q1 = slabs["q1"][sample].astype(np.float64)
    s1 = slabs["s1"][sample].astype(np.float64)[:, None]
    r1 = x - q1 * s1
    # `<=` (not `not >`): a NaN scale or bound must FAIL the check
    if not np.all(
        np.sqrt(np.sum(r1 * r1, axis=1)) <= slabs["e1"][sample].astype(np.float64)
    ) or not all(np.all(np.isfinite(slabs[k][sample])) for k in ("s1", "e1")):
        return False
    converted = {"emb": slabs["q1"], "scale": slabs["s1"], "err": slabs["e1"]}
    if dix.refine:
        q2 = slabs["q2"][sample].astype(np.float64)
        s2 = slabs["s2"][sample].astype(np.float64)[:, None]
        r2 = r1 - q2 * s2
        if not np.all(
            np.sqrt(np.sum(r2 * r2, axis=1)) <= slabs["e2"][sample].astype(np.float64)
        ) or not all(np.all(np.isfinite(slabs[k][sample])) for k in ("s2", "e2")):
            return False
        converted.update(emb2=slabs["q2"], scale2=slabs["s2"], err2=slabs["e2"])

    # the device mirror wants to_micros(None) (datetime.min) for missing stamps
    created_us = np.where(aux["has_created"], aux["created_us"], _to_us(None)).astype(np.int64)

    dix.load_slabs(
        chunks,
        emb_norm=emb_norm, raw_emb=raw_emb, raw_norm_sq=raw_norm_sq,
        bloom=slabs["bloom"], created=slabs["created"],
        created_us=created_us, created_ts=slabs["created_ts"],
        seqs=np.asarray(aux["seq"], dtype=np.int64),
        lower_arena=slabs["lower_arena"].tobytes(),
        lower_off=np.asarray(slabs["lower_off"], dtype=np.int64),
        converted=converted,
    )
    return True
