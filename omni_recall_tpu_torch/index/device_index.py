"""Device-resident chunk index (structure-of-arrays), PyTorch port of
omni_recall_tpu/index/device_index.py.

Rows are append-only in (created_at, seq) order, so the reference's
"N most recent chunks" candidate window (RecallSearchService.cs:26) is a
row threshold computed on the host. Deletions clear the valid mask
(tombstones); reindex overwrites embeddings in place.

Per row the device holds (``DeviceArrays``):
- ``emb``     the scan plane, per ``scan_dtype``: the L2-normalized
              embedding (zero rows for chunks without a usable embedding)
              as ``f32`` [cap, d], rounded to ``bf16`` (nearest, ties to
              even) [cap, d], or as ``int8`` [cap, d], a symmetric per-row
              quantization with
- ``scale``   f32[cap]      per-row dequantization scale (int8 only),
- ``err``     f32[cap]      sound bound on the quantization error norm
                            (int8 only),
- ``emb2``, ``scale2``, ``err2``  the residual int8 plane, its scale and
                            its error bound (only int8 with ``refine``: the
                            refine stage, K3, ops/refine.py):
                            emb ~= emb*scale + emb2*scale2,
                            ||resid|| <= err2,
- ``raw``     f32[cap, d]   bitwise copy of the raw embedding (only with
                            ``exact_cos``: the device-exact cosine, K2),
- ``bloom``   u8[cap, W]    char-n-gram bloom signature (ops/hashing.py),
- ``created`` f32[cap]      days since EPOCH (recency term),
- ``valid``   bool[cap]    liveness mask.

Host mirrors live in numpy (the exact host rescore reads them). Capacity
grows in ``capacity_block`` row blocks; a capacity change re-uploads
everything (new tensors — searches in flight keep the old ones), otherwise
dirty capacity blocks are copied in place into the device planes
(``Tensor.copy_``, ordered on the current stream after any scan already
queued). Large host arrays go up in 64 MiB slabs through pinned staging
buffers (``upload_slabbed``).

Besides ``append``, rows arrive by ``bulk_load``, by ``load_slabs`` (the
snapshot fast restore, index/snapshot.py: every host mirror adopted from
persisted arrays, the pre-quantized planes staged for the first upload), by
``append_from_index`` (the compaction of ``RecallEngine.rebuild_index``:
derived columns reused, the device planes gathered on the device) and by
``bulk_load_compact`` (the compact store, index/compact.py: serving-only).

With a ``mesh`` (parallel/mesh.py) the device planes are row-sharded: each
is a ``RowSharded`` whose shard l holds its n_local rows on the shard's
device, and the capacity is a multiple of the shard count. A sharded index
quantizes on the host (the device quantizer is single-device), rebuilds by
upload (no device-side compaction), and cannot take a compact bulk load.

The entry point runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from datetime import datetime, timezone

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.index.records import ChunkRecord
from omni_recall_tpu_torch.ops import hashing, oracle
from omni_recall_tpu_torch.ops.quantize import (
    quantize_rows_int8,
    quantize_rows_int8_residual,
)
from omni_recall_tpu_torch.ops.refine import _int8_plane
from omni_recall_tpu_torch.ops.scorer import _fma32, row_norm

EPOCH = datetime(2024, 1, 1, tzinfo=timezone.utc)
_EPOCH70 = datetime(1970, 1, 1, tzinfo=timezone.utc)
_MIN_UTC = datetime.min.replace(tzinfo=timezone.utc)
_MIN_TS = _MIN_UTC.timestamp()

logger = logging.getLogger(__name__)


def _aware(dt: datetime | None) -> datetime:
    if dt is None:
        return _MIN_UTC
    return dt if dt.tzinfo is not None else dt.replace(tzinfo=timezone.utc)


def to_micros(dt: datetime | None) -> int:
    """Exact integer epoch microseconds (the vectorized recency rescore's
    exact age source)."""
    td = _aware(dt) - _EPOCH70
    return (td.days * 86400 + td.seconds) * 1_000_000 + td.microseconds


# row granularity of the valid-count blocks backing window_start_row
VALID_BLOCK = 4096


def to_days(dt: datetime | None) -> float:
    if dt is None:
        return 0.0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return (dt - EPOCH).total_seconds() / 86400.0


def device_quantize(x: torch.Tensor, refine: bool = False,
                    slab_rows: int = 1 << 18) -> dict[str, torch.Tensor]:
    """int8 (+ residual) quantization ON DEVICE (device_index.py
    _device_quantize_impl), slab by slab to bound the temporaries. The
    operations are those of the JAX graph as its jit compiles it (a
    multiply by fl32(1/127) for each scale, fused multiply-adds for the
    residuals and the bounds), so emb, scale, emb2 and scale2 are bitwise
    equal to it; err and err2 can differ in their last bit where XLA orders
    the sum of squares otherwise. Soundness of the f32-evaluated error
    norms: the residual elements carry <= u*|x| absolute representation
    error and the f32 norm <= d*u relative error, so
    ``norm * (1 + 1e-4) + 3e-7`` is >= the true residual norm (the same
    constants as the host quantizer, ops/quantize.py)."""
    n = x.shape[0]
    suffixes = ("", "2") if refine else ("",)  # plane 1, then the residual plane
    out = {}
    for sfx in suffixes:
        out["emb" + sfx] = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        out["scale" + sfx] = torch.empty(n, dtype=torch.float32, device=x.device)
        out["err" + sfx] = torch.empty(n, dtype=torch.float32, device=x.device)
    for lo in range(0, n, slab_rows):
        hi = lo + slab_rows
        r = x[lo:hi]
        for suffix in suffixes:
            q, s = _int8_plane(r)
            # the residual and its bound in the form XLA's jit contracts
            r = _fma32(-q.to(torch.float32), s, r)
            out["emb" + suffix][lo:hi] = q
            out["scale" + suffix][lo:hi] = s[:, 0]
            out["err" + suffix][lo:hi] = _fma32(row_norm(r), 1.0 + 1e-4, 3e-7)
    return out


@dataclass
class DeviceArrays:
    emb: torch.Tensor            # f32 | bf16 | int8 rows, per scan_dtype
    bloom: torch.Tensor
    created: torch.Tensor
    valid: torch.Tensor
    scale: torch.Tensor | None = None  # int8: per-row dequant scale
    err: torch.Tensor | None = None    # int8: per-row quantization error norm
    # residual int8 plane for the refine stage (ops/refine.py, refine=True)
    emb2: torch.Tensor | None = None
    scale2: torch.Tensor | None = None
    err2: torch.Tensor | None = None
    raw: torch.Tensor | None = None  # raw f32 rows (exact_cos)


# planes an index may carry (from_numpy_planes' keys)
PLANES = ("emb", "bloom", "created", "valid", "scale", "err",
          "emb2", "scale2", "err2", "raw")
# the planes the row quantizer writes (with refine: the residual ones too)
_QUANT_PLANES = ("emb", "scale", "err", "emb2", "scale2", "err2")
# scan storage type of each scan_dtype
SCAN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _host_tensor(a) -> torch.Tensor:
    """A host plane as a CPU tensor: numpy arrays, including the bfloat16
    arrays of the JAX package (ml_dtypes, read through their bits), or
    tensors as they are."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a JAX array's host view: PyTorch wants its own
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# Optional per-slab tick of ``upload_slabbed`` when its caller passes none
# (no arguments): a deadline-aware caller sets it to its checkpoint, so the
# full uploads that ``device_arrays()`` makes can abort at a slab boundary
# instead of overrunning a budget. The exception propagates to the caller of
# ``device_arrays()``; the host mirrors stay intact and the index stays
# device-dirty (the next ``device_arrays()`` re-derives the planes). The
# single-slab fast path does not tick.
UPLOAD_TICK = None


def upload_slabbed(host, device, slab_bytes: int = 64 << 20, tick=None) -> torch.Tensor:
    """Upload a large host array (numpy, copy-on-write memmaps included, or
    a CPU tensor) in ~64 MiB slabs assembled in one device tensor.

    Each slab is copied into one of two pinned staging buffers and sent
    with a non-blocking copy; a buffer is refilled only once the copy that
    read it has finished (its event), so the host fill of one slab overlaps
    the transfer of the last. Page faults and pinned memory cost O(slab)
    instead of O(total): a memmap pages in one slab at a time. ``tick`` (no
    arguments) is called before each slab, so a deadline-aware caller can
    abort at a slab boundary by raising; the host arrays stay intact.
    Without one, the module's ``UPLOAD_TICK`` (if set) is called instead. On
    a CPU device the slabs are copied into one CPU tensor."""
    device = torch.device(device)
    if tick is None:
        tick = UPLOAD_TICK
    rows = host.shape[0]
    row_bytes = max(1, int(np.prod(host.shape[1:], dtype=np.int64)) * host.itemsize)
    slab = max(1 if slab_bytes < (64 << 20) else 1024, slab_bytes // row_bytes)
    if rows <= slab:
        return _host_tensor(host).to(device, copy=True)
    out = None
    staging: list[torch.Tensor] = []
    done: list[torch.cuda.Event] = []
    try:
        for k, lo in enumerate(range(0, rows, slab)):
            if tick is not None:
                tick()
            piece = _host_tensor(host[lo : lo + slab])
            if out is None:
                out = torch.empty((rows, *piece.shape[1:]), dtype=piece.dtype, device=device)
            hi = lo + piece.shape[0]
            if device.type != "cuda":
                out[lo:hi].copy_(piece)
                continue
            b = k % 2
            if len(staging) <= b:
                staging.append(torch.empty((slab, *piece.shape[1:]), dtype=piece.dtype,
                                           pin_memory=True))
                done.append(torch.cuda.Event())
            else:
                done[b].synchronize()  # the copy that last read this buffer is done
            buf = staging[b][: hi - lo]
            buf.copy_(piece)
            out[lo:hi].copy_(buf, non_blocking=True)
            done[b].record()
    finally:
        for event in done:  # no copy may still read a buffer freed below
            event.synchronize()
    return out


class DeviceIndex:
    def __init__(
        self,
        dim: int,
        *,
        capacity_block: int = 8192,
        bloom_bits: int = 1024,
        ngram: int = 4,
        bloom_hashes: int = 1,
        scan_dtype: str = "int8",
        refine: bool = False,
        exact_cos: bool = False,
        device: str | torch.device = "cuda",
        mesh=None,
    ) -> None:
        if bloom_bits % 8 != 0:
            raise ValueError("bloom_bits must be a multiple of 8")
        if scan_dtype not in SCAN_DTYPES:
            raise ValueError(f"unsupported scan_dtype: {scan_dtype}")
        # a sharded index's replicated operands and merged results live on
        # its first shard's device
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.dim = dim
        self.scan_dtype = scan_dtype
        # keep the residual int8 plane (K3): int8 storage only
        self.refine = bool(refine) and scan_dtype == "int8"
        self.exact_cos = bool(exact_cos)
        capacity_block = max(128, capacity_block)
        if mesh is not None:
            # even row sharding: the capacity must divide by the shard count
            s = mesh.n_shards
            capacity_block = ((capacity_block + s - 1) // s) * s
        self.capacity_block = capacity_block
        self.bloom_bits = bloom_bits
        self.ngram = ngram
        self.bloom_hashes = bloom_hashes

        self._cap = 0
        self._n = 0  # rows allocated (including tombstones)
        self._n_valid = 0
        self.emb = np.zeros((0, dim), dtype=np.float32)
        self.bloom = np.zeros((0, bloom_bits // 8), dtype=np.uint8)
        self.created = np.zeros((0,), dtype=np.float32)
        self.valid = np.zeros((0,), dtype=bool)
        # host mirrors for the vectorized exact rescore (raw f32 + exact f64
        # norms reproduce the oracle cosine; exact micros its recency;
        # timestamp()/seq drive the tie-break)
        self.raw_emb = np.zeros((0, dim), dtype=np.float32)
        self.raw_norm_sq = np.zeros((0,), dtype=np.float64)
        self.created_us = np.full((0,), to_micros(None), dtype=np.int64)
        self.created_ts = np.zeros((0,), dtype=np.float64)
        self.seqs = np.zeros((0,), dtype=np.int64)
        # content arena: lowercased UTF-8 contents, row r at
        # [content_off[r], content_off[r+1]); read only under self._lock
        # (bytearray growth reallocates)
        self._arena = bytearray()
        self.content_off = np.zeros((1,), dtype=np.int64)
        self.meta: list[ChunkRecord | None] = []
        self._row_by_chunk_id: dict[str, int] = {}
        # bumped (under _lock) on every in-place embedding update; the
        # engine compares it across a search to detect reindex races
        self._update_seq = 0
        self._block_valid = np.zeros((0,), dtype=np.int64)
        self._rows_by_doc: dict[str, list[int]] = {}
        # compact bulk mode (bulk_load_compact): int8+scale embedding
        # columns replace the f32 mirrors; serving-only
        self.host_compact = False
        self.emb8_host: np.ndarray | None = None
        self.scale_host: np.ndarray | None = None
        self._device: DeviceArrays | None = None
        # one-shot pre-quantized planes staged by load_slabs (snapshot fast
        # restore); consumed by the next full upload
        self._preconverted: dict[str, np.ndarray] | None = None
        # emb and raw_emb may share storage after an exact-fit bulk_load
        self._raw_aliased = False
        self._dirty_blocks: set[int] = set()
        self._device_cap = -1
        self._lock = threading.RLock()

    # ---- sizing ----

    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def n_valid(self) -> int:
        return self._n_valid

    @property
    def update_seq(self) -> int:
        return self._update_seq

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self._cap:
            return
        needed = max(needed, self._cap + self._cap // 8)
        new_cap = ((needed + self.capacity_block - 1) // self.capacity_block) * self.capacity_block
        grow = new_cap - self._cap
        if self._n == 0:
            self.emb = np.zeros((new_cap, self.dim), dtype=np.float32)
            self.bloom = np.zeros((new_cap, self.bloom_bits // 8), dtype=np.uint8)
            self.created = np.zeros(new_cap, dtype=np.float32)
            self.valid = np.zeros(new_cap, dtype=bool)
            self.raw_emb = np.zeros((new_cap, self.dim), dtype=np.float32)
            self.raw_norm_sq = np.zeros(new_cap, dtype=np.float64)
            self.created_us = np.full(new_cap, to_micros(None), dtype=np.int64)
            self.created_ts = np.full(new_cap, _MIN_TS, dtype=np.float64)
            self.seqs = np.zeros(new_cap, dtype=np.int64)
        else:

            def pad(a: np.ndarray) -> np.ndarray:
                return np.pad(a, [(0, grow)] + [(0, 0)] * (a.ndim - 1))

            self.emb = pad(self.emb)
            self.bloom = pad(self.bloom)
            self.created = pad(self.created)
            self.valid = pad(self.valid)
            self.raw_emb = pad(self.raw_emb)
            self._raw_aliased = False  # the two pads are independent copies
            self.raw_norm_sq = pad(self.raw_norm_sq)
            self.created_us = np.concatenate(
                [self.created_us, np.full(grow, to_micros(None), dtype=np.int64)]
            )
            self.created_ts = np.concatenate(
                [self.created_ts, np.full(grow, _MIN_TS, dtype=np.float64)]
            )
            self.seqs = pad(self.seqs)
        off = np.full(new_cap + 1, self.content_off[self._n], dtype=np.int64)
        off[: self.content_off.shape[0]] = self.content_off
        self.content_off = off
        n_blocks = (new_cap + VALID_BLOCK - 1) // VALID_BLOCK
        if n_blocks > self._block_valid.shape[0]:
            self._block_valid = np.pad(
                self._block_valid, (0, n_blocks - self._block_valid.shape[0])
            )
        self._cap = new_cap
        self._device = None  # capacity changed -> full re-upload
        self._device_cap = -1

    def _count_valid_added(self, lo: int, hi: int) -> None:
        """Credit rows [lo, hi) — all newly valid — to their blocks."""
        if hi <= lo:
            return
        b_lo, b_hi = lo // VALID_BLOCK, (hi - 1) // VALID_BLOCK
        if b_lo == b_hi:
            self._block_valid[b_lo] += hi - lo
            return
        self._block_valid[b_lo] += (b_lo + 1) * VALID_BLOCK - lo
        self._block_valid[b_lo + 1 : b_hi] += VALID_BLOCK
        self._block_valid[b_hi] += hi - b_hi * VALID_BLOCK

    def _mark_dirty(self, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        block = self.capacity_block
        self._dirty_blocks.update(range(lo // block, (hi + block - 1) // block))

    # ---- mutation ----

    def _normalize(self, embedding: list[float] | None) -> np.ndarray | None:
        if embedding is None or len(embedding) != self.dim:
            return None
        vec = np.asarray(embedding, dtype=np.float32)
        norm_sq = float(np.sum((vec * vec).astype(np.float64)))
        if norm_sq <= 0.0:
            return None
        return (vec.astype(np.float64) / np.sqrt(norm_sq)).astype(np.float32)

    def _require_mutable(self) -> None:
        if self.host_compact:
            raise RuntimeError(
                "compact bulk index is serving-only (bulk_load_compact)"
            )

    def append(self, chunks: list[ChunkRecord]) -> None:
        if not chunks:
            return
        self._require_mutable()
        with self._lock:
            self._append_locked(chunks)

    def _derive_columns(self, chunks: list[ChunkRecord]) -> dict:
        """Batch-derive every per-chunk column an append installs (lowercased
        UTF-8, bloom signatures, timestamps, seqs, normalized/raw embeddings
        and exact norms). Pure: no index state is touched, so a failure
        cannot break the meta-index == row-index alignment."""
        nc = len(chunks)
        lows = [oracle.lower_invariant(c.content) for c in chunks]
        encs = []
        for c, low in zip(chunks, lows):
            if c._lower_utf8 is None:  # prepopulate the record's lazy cache
                c._lower_utf8 = low.encode("utf-8", errors="surrogatepass")
            encs.append(c._lower_utf8)
        sigs = hashing.chunk_signatures_batch(
            lows, self.bloom_bits, self.ngram, self.bloom_hashes
        )
        days = np.fromiter(
            (to_days(c.created_at_utc) for c in chunks), dtype=np.float64, count=nc
        )
        us = np.fromiter(
            (to_micros(c.created_at_utc) for c in chunks), dtype=np.int64, count=nc
        )
        ts = np.fromiter(
            (_aware(c.created_at_utc).timestamp() for c in chunks),
            dtype=np.float64, count=nc,
        )
        seqs = np.fromiter((c.seq for c in chunks), dtype=np.int64, count=nc)
        lens = np.fromiter((len(e) for e in encs), dtype=np.int64, count=nc)
        dim_ok = [
            offset for offset, c in enumerate(chunks)
            if c.embedding is not None and len(c.embedding) == self.dim
        ]
        n_mismatched = sum(
            1 for c in chunks
            if c.embedding is not None and len(c.embedding) not in (0, self.dim)
        )
        if n_mismatched:
            logger.warning(
                "%d chunk embedding(s) do not match the index dim %d; "
                "stored as zero vectors (cosine contributes 0). Check "
                "Embeddings:Dim vs Engine:EmbeddingDim.",
                n_mismatched, self.dim,
            )
        a = normed = norm_sq = None
        if dim_ok:
            a = np.asarray([chunks[o].embedding for o in dim_ok], dtype=np.float32)
            norm_sq = np.sum(a * a, axis=1, dtype=np.float64)
            # f32 reciprocal-multiply normalization (the scan bounds budget
            # the ~2 ulp difference to an f64 divide; the exact rescore
            # reads raw_emb / raw_norm_sq)
            with np.errstate(divide="ignore"):
                inv = np.where(
                    norm_sq > 0.0, 1.0 / np.sqrt(norm_sq), 0.0
                ).astype(np.float32)
            normed = a * inv[:, None]
        return {
            "encs": encs, "sigs": sigs, "days": days, "us": us, "ts": ts,
            "seqs": seqs, "lens": lens, "dim_ok": dim_ok,
            "a": a, "normed": normed, "norm_sq": norm_sq,
        }

    def _append_locked(self, chunks: list[ChunkRecord]) -> None:
        start = self._n
        nc = len(chunks)
        end = start + nc
        self._ensure_capacity(end)
        # every fallible per-chunk value first, then the mutation
        d = self._derive_columns(chunks)
        dim_ok = d["dim_ok"]
        arena_add = b"".join(d["encs"])
        ids = [c.id for c in chunks]
        rows_ok = np.asarray(dim_ok, dtype=np.int64) + start if dim_ok else None

        self.bloom[start:end] = d["sigs"]
        if dim_ok:
            if len(dim_ok) == nc:
                self.emb[start:end] = d["normed"]
                self.raw_emb[start:end] = d["a"]
                self.raw_norm_sq[start:end] = d["norm_sq"]
            else:
                self.emb[rows_ok] = d["normed"]
                self.raw_emb[rows_ok] = d["a"]
                self.raw_norm_sq[rows_ok] = d["norm_sq"]
        self.created[start:end] = d["days"]
        self.created_us[start:end] = d["us"]
        self.created_ts[start:end] = d["ts"]
        self.seqs[start:end] = d["seqs"]
        base = len(self._arena)
        self._arena.extend(arena_add)
        self.content_off[start + 1 : end + 1] = base + np.cumsum(d["lens"])
        self.valid[start:end] = True
        self.meta.extend(chunks)
        self._row_by_chunk_id.update(zip(ids, range(start, end)))
        for offset, c in enumerate(chunks):
            self._rows_by_doc.setdefault(c.document_id, []).append(start + offset)
        self._n = end
        self._n_valid += nc
        self._count_valid_added(start, end)
        self._mark_dirty(start, end)

    def append_from_index(self, old: "DeviceIndex", chunks: list[ChunkRecord]) -> str:
        """Compaction fast path for RecallEngine.rebuild_index: fill this
        (empty) index from ``chunks``, REUSING ``old``'s derived columns —
        bloom signatures, normalized/raw embeddings, f64 norms, timestamp
        columns and arena bytes — for every chunk whose record OBJECT is the
        one ``old`` indexed (in-place embedding updates keep the object and
        the arrays in sync; a store upsert that replaces a record fails the
        identity test, so that chunk re-derives through the append path).
        When every row is reused and ``old``'s device planes are current,
        the new planes are one on-device ``index_select`` of each of old's
        planes: no host quantization, no upload.

        Returns the route of the device planes: ``"device"`` (gathered on
        the device) or ``"upload"`` (built by the next ``device_arrays``).
        Requirements: ``chunks`` in (created_at, seq) order; this index
        empty; derivation parameters matching ``old``'s; neither index a
        compact bulk store (its chunks are not records, so ``old`` cannot be
        rebuilt from them)."""
        self._require_mutable()
        old._require_mutable()
        nc = len(chunks)
        if nc == 0:
            return "upload"
        params = lambda x: (x.dim, x.bloom_bits, x.ngram, x.bloom_hashes,  # noqa: E731
                            x.scan_dtype)
        if params(self) != params(old):
            raise ValueError("append_from_index requires matching index parameters")
        with self._lock:
            if self._n != 0:
                raise ValueError("append_from_index requires an empty index")
            self._ensure_capacity(nc)

            src = np.full(nc, -1, dtype=np.int64)
            with old._lock:
                row_of, ometa, ovalid = old._row_by_chunk_id, old.meta, old.valid
                for i, c in enumerate(chunks):
                    r = row_of.get(c.id)
                    if r is not None and ometa[r] is c and ovalid[r]:
                        src[i] = r
                hit_dst = np.nonzero(src >= 0)[0]
                hit_src = src[hit_dst]
                if hit_dst.size:
                    # gather every reused column while old's arrays are
                    # stable (the arena-read-under-lock contract)
                    self.emb[hit_dst] = old.emb[hit_src]
                    self.raw_emb[hit_dst] = old.raw_emb[hit_src]
                    self.raw_norm_sq[hit_dst] = old.raw_norm_sq[hit_src]
                    self.bloom[hit_dst] = old.bloom[hit_src]
                    self.created[hit_dst] = old.created[hit_src]
                    self.created_us[hit_dst] = old.created_us[hit_src]
                    self.created_ts[hit_dst] = old.created_ts[hit_src]
                    self.seqs[hit_dst] = old.seqs[hit_src]
                h_start = old.content_off[hit_src]
                h_len = old.content_off[hit_src + 1] - h_start
                old_arena = np.frombuffer(old._arena, dtype=np.uint8)

                miss_dst = np.nonzero(src < 0)[0]
                miss = [chunks[int(i)] for i in miss_dst]
                d = self._derive_columns(miss) if miss else None

                lens = np.zeros(nc, dtype=np.int64)
                lens[hit_dst] = h_len
                if d is not None:
                    lens[miss_dst] = d["lens"]
                out_off = np.zeros(nc + 1, dtype=np.int64)
                np.cumsum(lens, out=out_off[1:])
                arena = np.empty(int(out_off[-1]), dtype=np.uint8)
                # hit bytes: sources ascend (rows are in seq order), so
                # adjacent ranges coalesce into runs — one copy per
                # tombstone gap. A run is contiguous at BOTH ends: in the
                # source arena and in the output rows (no interleaved miss).
                if hit_dst.size:
                    brk = np.nonzero(
                        (h_start[1:] != h_start[:-1] + h_len[:-1])
                        | (hit_dst[1:] != hit_dst[:-1] + 1)
                    )[0] + 1
                    run_lo = np.concatenate(([0], brk))
                    run_hi = np.concatenate((brk, [hit_dst.size]))
                    for lo, hi in zip(run_lo, run_hi):
                        start = int(h_start[lo])
                        o = int(out_off[hit_dst[lo]])
                        ln = int(h_start[hi - 1] + h_len[hi - 1]) - start
                        arena[o : o + ln] = old_arena[start : start + ln]
                del old_arena  # release the export before old's arena may grow
                if d is not None:
                    for k, i in enumerate(miss_dst):
                        e = d["encs"][k]
                        o = int(out_off[i])
                        arena[o : o + len(e)] = np.frombuffer(e, dtype=np.uint8)

            # -- mutation outside old's lock (no more old reads) --
            if d is not None:
                self.bloom[miss_dst] = d["sigs"]
                self.created[miss_dst] = d["days"]
                self.created_us[miss_dst] = d["us"]
                self.created_ts[miss_dst] = d["ts"]
                self.seqs[miss_dst] = d["seqs"]
                if d["dim_ok"]:
                    rows_ok = miss_dst[np.asarray(d["dim_ok"], dtype=np.int64)]
                    self.emb[rows_ok] = d["normed"]
                    self.raw_emb[rows_ok] = d["a"]
                    self.raw_norm_sq[rows_ok] = d["norm_sq"]
            self._arena = bytearray(memoryview(arena))
            self.content_off[: nc + 1] = out_off
            self.valid[:nc] = True
            self.meta.extend(chunks)
            self._row_by_chunk_id.update(zip((c.id for c in chunks), range(nc)))
            for row, c in enumerate(chunks):
                self._rows_by_doc.setdefault(c.document_id, []).append(row)
            self._n = nc
            self._n_valid = nc
            self._count_valid_added(0, nc)
            self._mark_dirty(0, nc)

            # device-side plane compaction: every row reuses an old row and
            # old's planes are current. Old's tensors stay untouched
            # (searches in flight on the old index keep their data).
            if (self.mesh is None and old.mesh is None
                    and self.refine == old.refine and self.exact_cos == old.exact_cos
                    and self.device == old.device and miss_dst.size == 0):
                with old._lock:
                    odev = old._device
                    current = (odev is not None and old._device_cap == old._cap
                               and not old._dirty_blocks)
                if current:
                    self._adopt_compacted_planes(odev, src)
                    return "device"
        return "upload"

    def _adopt_compacted_planes(self, odev: DeviceArrays, src: np.ndarray) -> None:
        """Install this index's device planes as a row gather of ``odev``'s
        (src[i] = old row of new row i; pad rows gather row 0 and are masked
        by valid=False). created and valid come up from the host mirrors,
        which are authoritative for the pad rows."""
        cap = self._cap
        idx = np.zeros(cap, dtype=np.int64)
        idx[: src.shape[0]] = src
        idx_dev = torch.from_numpy(idx).to(self.device)

        def take(plane):
            return None if plane is None else plane.index_select(0, idx_dev)

        self._device = DeviceArrays(
            emb=take(odev.emb), bloom=take(odev.bloom),
            created=self._put(self.created), valid=self._put(self.valid),
            scale=take(odev.scale), err=take(odev.err),
            emb2=take(odev.emb2), scale2=take(odev.scale2), err2=take(odev.err2),
            raw=take(odev.raw),
        )
        self._device_cap = cap
        self._dirty_blocks.clear()

    def bulk_load(
        self,
        emb_normalized: np.ndarray,       # f32 [n, d], rows already L2-normalized (or zero)
        bloom: np.ndarray,                # u8 [n, W]
        created_days: np.ndarray,         # f32 [n], nondecreasing
        meta: list[ChunkRecord],
        aux: dict | None = None,
    ) -> None:
        """Bulk array injection (benchmarks, large restores): bypasses
        per-chunk hashing/normalization. Rows must be in (created, seq)
        order; the index must be empty. ``bloom`` rows must be signatures
        built with THIS index's (bloom_bits, ngram, bloom_hashes), or the
        device keyword score is not a sound upper bound. ``aux`` carries
        pre-vectorized ``created_us``, ``created_ts``, ``seqs``,
        ``lower_arena`` and ``lower_off`` columns, with the same contract as
        the record-derived values."""
        with self._lock:
            if self._n != 0:
                raise ValueError("bulk_load requires an empty index")
            n = emb_normalized.shape[0]
            if not (len(meta) == n == bloom.shape[0] == created_days.shape[0]):
                raise ValueError("bulk_load arrays must have matching row counts")
            if bloom.shape[1] != self.bloom_bits // 8:
                raise ValueError(
                    f"bloom width {bloom.shape[1]} != index bloom_bits/8 "
                    f"({self.bloom_bits // 8})"
                )
            self._ensure_capacity(n)
            if (
                self._cap == n
                and isinstance(emb_normalized, np.ndarray)
                and emb_normalized.dtype == np.float32
                and emb_normalized.flags.c_contiguous
            ):
                # exact fit: adopt the caller's array for both mirrors
                self.emb = emb_normalized
                self.raw_emb = emb_normalized
                self._raw_aliased = True
            else:
                self.emb[:n] = emb_normalized
                self.raw_emb[:n] = emb_normalized
            self.bloom[:n] = bloom
            self.created[:n] = created_days
            self.valid[:n] = True
            self.raw_norm_sq[:n] = np.sum(
                emb_normalized * emb_normalized, axis=1, dtype=np.float64
            )
            if aux is not None:
                self.created_us[:n] = aux["created_us"]
                self.created_ts[:n] = aux["created_ts"]
                self.seqs[:n] = aux["seqs"]
                self._arena.extend(aux["lower_arena"])
                self.content_off[1 : n + 1] = np.asarray(
                    aux["lower_off"], dtype=np.int64
                )[1 : n + 1]
            else:
                self.created_us[:n] = np.fromiter(
                    (to_micros(c.created_at_utc) for c in meta), dtype=np.int64, count=n
                )
                self.created_ts[:n] = np.fromiter(
                    (_aware(c.created_at_utc).timestamp() for c in meta),
                    dtype=np.float64, count=n,
                )
                self.seqs[:n] = np.fromiter((c.seq for c in meta), dtype=np.int64, count=n)
                encs = [c.content_lower_utf8() for c in meta]
                self._arena.extend(b"".join(encs))
                self.content_off[1 : n + 1] = np.cumsum(
                    np.fromiter((len(e) for e in encs), dtype=np.int64, count=n)
                )
            self.meta.extend(meta)
            self._row_by_chunk_id.update(zip((c.id for c in meta), range(n)))
            for row, c in enumerate(meta):
                self._rows_by_doc.setdefault(c.document_id, []).append(row)
            self._n = n
            self._n_valid = n
            self._count_valid_added(0, n)
            self._mark_dirty(0, n)

    def load_slabs(
        self,
        meta: list[ChunkRecord],
        *,
        emb_norm: np.ndarray,      # f32 [n, d] normalized (or zero) rows
        raw_emb: np.ndarray,       # f32 [n, d] raw mirror (exact rescore)
        raw_norm_sq: np.ndarray,   # f64 [n]
        bloom: np.ndarray,         # u8 [n, W]
        created: np.ndarray,       # f32 [n] days
        created_us: np.ndarray,    # i64 [n] exact micros
        created_ts: np.ndarray,    # f64 [n] timestamp() mirror
        seqs: np.ndarray,          # i64 [n]
        lower_arena: bytes,        # concatenated lowercased UTF-8 contents
        lower_off: np.ndarray,     # i64 [n + 1]
        converted: dict[str, np.ndarray] | None = None,
    ) -> None:
        """Snapshot fast-restore injection (index/snapshot.py): installs
        EVERY host mirror from persisted arrays — no hashing, normalization,
        quantization or per-chunk work. ``converted`` carries the
        pre-quantized planes (``_QUANT_PLANES`` keys); the first device
        upload consumes them instead of re-quantizing.

        CONTRACT: arrays mutually consistent and derived with this index's
        parameters (the snapshot layer checks a sample before calling and
        falls back to the rebuild otherwise); rows in (created_at, seq)
        order; the index empty. The arrays are ADOPTED as the index storage
        (capacity == n; the next append grows by capacity blocks as usual).
        Copy-on-write memmaps work as they are: restore pays page-in only
        for rows a later rescore or upload touches, and writes never reach
        the snapshot files."""
        self._require_mutable()
        n = len(meta)
        with self._lock:
            if self._n != 0:
                raise ValueError("load_slabs requires an empty index")
            if not (
                n == emb_norm.shape[0] == bloom.shape[0] == created.shape[0]
                == raw_emb.shape[0] == seqs.shape[0]
            ):
                raise ValueError("load_slabs arrays must have matching rows")
            if bloom.shape[1] != self.bloom_bits // 8 or emb_norm.shape[1] != self.dim:
                raise ValueError("slab geometry mismatch")
            cap = n
            if self.mesh is not None:
                # row-sharded planes need a shard-divisible capacity: pad the
                # adopted arrays with rows that are not valid. This copies
                # memmaps; only the sharded layout pays it.
                s = self.mesh.n_shards
                cap = ((n + s - 1) // s) * s
            if cap != n:
                def padr(a):
                    a = np.asarray(a)
                    out = np.zeros((cap,) + a.shape[1:], dtype=a.dtype)
                    out[:n] = a
                    return out

                emb_norm, raw_emb, bloom = map(padr, (emb_norm, raw_emb, bloom))
                created, created_us, created_ts, raw_norm_sq, seqs = map(
                    padr, (created, created_us, created_ts, raw_norm_sq, seqs))
                lower_off = np.concatenate([
                    np.asarray(lower_off, dtype=np.int64),
                    np.full(cap - n, int(lower_off[-1]), dtype=np.int64)])
                if converted is not None:
                    converted = {k: padr(v) for k, v in converted.items()}
            self.emb = emb_norm
            self.bloom = bloom
            self.created = np.asarray(created, dtype=np.float32)
            self.valid = np.zeros(cap, dtype=bool)
            self.valid[:n] = True
            self.raw_emb = raw_emb
            self._raw_aliased = False
            self.raw_norm_sq = np.asarray(raw_norm_sq, dtype=np.float64)
            self.created_us = np.asarray(created_us, dtype=np.int64)
            self.created_ts = np.asarray(created_ts, dtype=np.float64)
            self.seqs = np.asarray(seqs, dtype=np.int64)
            self._arena = bytearray(lower_arena)
            self.content_off = np.array(lower_off, dtype=np.int64)
            self.meta.extend(meta)
            self._row_by_chunk_id.update(zip((c.id for c in meta), range(n)))
            for row, c in enumerate(meta):
                self._rows_by_doc.setdefault(c.document_id, []).append(row)
            self._cap = cap
            self._device = None
            self._device_cap = -1
            self._dirty_blocks.clear()
            self._n = n
            self._n_valid = n
            nb = (cap + VALID_BLOCK - 1) // VALID_BLOCK
            self._block_valid = np.zeros(max(nb, 1), dtype=np.int64)
            self._count_valid_added(0, n)
            if converted is not None:
                self._preconverted = dict(converted)

    def bulk_load_compact(
        self,
        *,
        emb8: np.ndarray,         # i8 [n, d] — the embedding column itself
        scale: np.ndarray,        # f32 [n] dequant scales
        raw_norm_sq: np.ndarray,  # f64 [n] (see index/compact.py soundness)
        created_days: np.ndarray, # f32 [n]
        created_us: np.ndarray,   # i64 [n]
        created_ts: np.ndarray,   # f64 [n]
        arena: bytes,             # lowercased contents, concatenated
        content_off: np.ndarray,  # i64 [n+1]
        doc_id: str,
        device: DeviceArrays,     # pre-built device planes (same bits)
    ) -> None:
        """Compact bulk injection for very large corpora (index/compact.py):
        the host keeps int8+scale embedding columns, timestamp columns and
        the content arena — ~850 B/chunk instead of ~6 KB — and chunk
        metadata is a LAZY CompactMeta sequence. The device planes come in
        pre-built (generated on the device from the same integer recipe as
        the host columns, rows_np / rows_torch), so no multi-GB embedding
        transfer crosses the link.

        The index becomes SERVING-ONLY: append, update_embedding,
        append_from_index, load_slabs and snapshots raise; delete is a no-op
        (no id map). Serving reads valid and the window (real columns), the
        arena (native keyword rescore), created_us/_ts and seqs (recency and
        tie-breaks), materialize_raw_rows (exact f64 cosine of selected
        rows) and meta[row] for the hits."""
        from omni_recall_tpu_torch.index.compact import CompactMeta

        n = int(emb8.shape[0])
        if self.mesh is not None:
            raise ValueError("bulk_load_compact is single-device (shard the corpus "
                             "before building per-shard indexes)")
        with self._lock:
            if self._n != 0:
                raise ValueError("bulk_load_compact requires an empty index")
            if emb8.shape[1] != self.dim:
                raise ValueError("emb8 dim mismatch")
            if device.emb.shape[0] != n or device.emb.device.type != self.device.type:
                raise ValueError("device planes must hold the n rows on this index's device")
            self.host_compact = True
            self.emb8_host = np.ascontiguousarray(emb8)
            self.scale_host = np.asarray(scale, dtype=np.float32)
            # poison the f32 mirrors: any code path that still reads them
            # under compact mode must fail loudly, not serve zeros
            self.emb = None
            self.raw_emb = None
            self.bloom = None
            self.raw_norm_sq = np.asarray(raw_norm_sq, dtype=np.float64)
            self.created = np.asarray(created_days, dtype=np.float32)
            self.created_us = np.asarray(created_us, dtype=np.int64)
            self.created_ts = np.asarray(created_ts, dtype=np.float64)
            self.seqs = np.arange(n, dtype=np.int64)
            self.valid = np.ones(n, dtype=bool)
            self._arena = bytearray(arena)
            self.content_off = np.asarray(content_off, dtype=np.int64)
            # the arena bytearray is shared (no copy): compact mode never
            # appends, so it never reallocates under a reader
            self.meta = CompactMeta(
                doc_id, self.emb8_host, self.scale_host, self._arena,
                self.content_off, self.created_us, to_micros(EPOCH),
            )
            self._cap = n
            self._n = n
            self._n_valid = n
            nb = (n + VALID_BLOCK - 1) // VALID_BLOCK
            self._block_valid = np.zeros(max(nb, 1), dtype=np.int64)
            self._count_valid_added(0, n)
            # adopt the caller's planes: the sync path short-circuits
            # (capacity matches, no dirty blocks)
            self._device = device
            self._device_cap = n
            self._dirty_blocks.clear()

    def install_device_planes(self, dev: DeviceArrays) -> None:
        """Adopt device planes built elsewhere for a bulk-loaded index.

        CONTRACT: the planes must be bit-identical to what the standard
        upload plus ``device_quantize`` would give from this index's host
        mirrors (raw = the same f32 rows, the int8 planes by
        ``device_quantize``, bloom = the same signatures, created and valid
        the same columns, pad rows past the last one dead). Callers generate
        them on the device from a deterministic integer recipe
        (tools/e2e_engine.py ``build_e2e_engine``) to skip a multi-GB
        host-to-device transfer, and check the equality on a sample. A
        mismatch would silently break the exactness certificate (device
        bounds against the host rescore), which is why this is not a
        general setter."""
        with self._lock:
            if dev.emb.shape[0] != self._cap:
                raise ValueError(
                    f"device planes rows {dev.emb.shape[0]} != capacity {self._cap}"
                )
            self._device = dev
            self._device_cap = self._cap
            self._dirty_blocks.clear()

    def materialize_raw_rows(self, rows: np.ndarray) -> np.ndarray:
        """Compact-mode exact-rescore gather: f32 rows for the selected
        candidates, fl32(q8 * scale) — exactly the embedding column the
        compact store defines (index/compact.py soundness note)."""
        sel = self.emb8_host[rows]
        return sel.astype(np.float32) * self.scale_host[rows, None]

    @classmethod
    def from_numpy_planes(
        cls,
        planes: dict[str, np.ndarray],
        meta: list[ChunkRecord | None],
        *,
        device: str | torch.device = "cuda",
        capacity_block: int = 8192,
        bloom_bits: int | None = None,
        ngram: int = 4,
        bloom_hashes: int = 1,
    ) -> "DeviceIndex":
        """Build an index holding the same bits as another index.

        ``planes`` maps each name of ``PLANES`` to a numpy array — e.g.
        ``np.asarray`` of each field of the JAX package's ``DeviceArrays``
        (``raw`` may be absent: no device-exact cosine then) — or a CPU
        tensor. The scan storage type follows the ``emb`` plane: int8 (with
        ``scale``/``err``), f32, or bf16 (a torch.bfloat16 tensor or a numpy
        bfloat16 array). ``meta`` is that index's row list (``None`` for
        tombstoned rows). The device planes are installed bit for bit; the
        host mirrors are re-derived from the records exactly as ``append``
        derives them. Bloom parameters must be the source index's
        (``bloom_bits`` defaults to the plane width)."""
        host = {k: _host_tensor(a) for k, a in planes.items() if a is not None}
        emb = host["emb"]
        cap, dim = emb.shape
        scan_dtype = {v: k for k, v in SCAN_DTYPES.items()}.get(emb.dtype)
        if scan_dtype is None:
            raise ValueError(f"emb plane must be int8, f32 or bf16, got {emb.dtype}")
        w = host["bloom"].shape[1]
        index = cls(
            dim, capacity_block=capacity_block,
            bloom_bits=bloom_bits if bloom_bits is not None else 8 * w,
            ngram=ngram, bloom_hashes=bloom_hashes, scan_dtype=scan_dtype,
            refine=planes.get("emb2") is not None,
            exact_cos=planes.get("raw") is not None, device=device,
        )
        if index.bloom_bits // 8 != w:
            raise ValueError(f"bloom plane width {w} != bloom_bits/8")
        n = len(meta)
        valid = np.asarray(planes["valid"], dtype=bool)
        live = np.asarray([m is not None for m in meta], dtype=bool)
        if n > cap or not np.array_equal(valid[:n], live) or valid[n:].any():
            raise ValueError("meta does not match the planes' valid mask")
        with index._lock:
            index._ensure_capacity(cap)
            if index._cap != cap:
                raise ValueError(
                    f"plane rows {cap} are not a capacity this index reaches "
                    f"(capacity_block={index.capacity_block})"
                )
            rows = np.nonzero(live)[0]
            chunks = [meta[r] for r in rows]
            # bloom and created are themselves host mirrors: take their bits
            # from the planes (tombstoned rows included)
            index.bloom[:] = np.asarray(planes["bloom"])
            index.created[:] = np.asarray(planes["created"])
            if chunks:
                d = index._derive_columns(chunks)
                if not np.array_equal(index.bloom[rows], d["sigs"]):
                    raise ValueError(
                        "bloom plane does not match the records' signatures "
                        "(bloom_bits / ngram / bloom_hashes differ?)"
                    )
                index.created_us[rows] = d["us"]
                index.created_ts[rows] = d["ts"]
                index.seqs[rows] = d["seqs"]
                if d["dim_ok"]:
                    ok = rows[np.asarray(d["dim_ok"], dtype=np.int64)]
                    index.emb[ok] = d["normed"]
                    index.raw_emb[ok] = d["a"]
                    index.raw_norm_sq[ok] = d["norm_sq"]
                lens = np.zeros(n, dtype=np.int64)
                lens[rows] = d["lens"]
                index._arena.extend(b"".join(d["encs"]))
                index.content_off[1 : n + 1] = np.cumsum(lens)
                index.content_off[n + 1 :] = index.content_off[n]
            index.valid[:n] = live
            index.meta.extend(meta)
            for r, c in zip(rows, chunks):
                index._row_by_chunk_id[c.id] = int(r)
                index._rows_by_doc.setdefault(c.document_id, []).append(int(r))
            index._n = n
            index._n_valid = int(live.sum())
            for r in rows:
                index._block_valid[r // VALID_BLOCK] += 1
            index._device = DeviceArrays(**{
                k: host[k].to(index.device, copy=True) if k in host else None
                for k in PLANES})
            index._device_cap = cap
            index._dirty_blocks.clear()
        return index

    def update_embedding(self, chunk_id: str, embedding: list[float] | None) -> bool:
        self._require_mutable()
        with self._lock:
            row = self._row_by_chunk_id.get(chunk_id)
            if row is None or not self.valid[row]:
                return False
            if self._raw_aliased:  # diverging write: break the bulk alias
                self.raw_emb = self.raw_emb.copy()
                self._raw_aliased = False
            # bump BEFORE writing: a search that reads any updated value is
            # guaranteed to observe the new seq when it checks afterwards
            self._update_seq += 1
            vec = self._normalize(embedding)
            self.emb[row] = 0.0 if vec is None else vec
            if embedding is not None and len(embedding) == self.dim:
                raw = np.asarray(embedding, dtype=np.float32)
                self.raw_emb[row] = raw
                self.raw_norm_sq[row] = float(np.sum((raw * raw).astype(np.float64)))
            else:
                self.raw_emb[row] = 0.0
                self.raw_norm_sq[row] = 0.0
            meta = self.meta[row]
            if meta is not None:
                meta.embedding = embedding
            self._mark_dirty(row, row + 1)
            return True

    def delete_document(self, document_id: str) -> int:
        with self._lock:
            removed = 0
            for row in self._rows_by_doc.pop(document_id, []):
                chunk = self.meta[row]
                if chunk is not None and self.valid[row]:
                    self.valid[row] = False
                    self.emb[row] = 0.0
                    self.bloom[row] = 0
                    self.raw_emb[row] = 0.0
                    self.raw_norm_sq[row] = 0.0
                    self.meta[row] = None
                    self._row_by_chunk_id.pop(chunk.id, None)
                    self._block_valid[row // VALID_BLOCK] -= 1
                    self._mark_dirty(row, row + 1)
                    removed += 1
            self._n_valid -= removed
            return removed

    # ---- candidate window ----

    def window_start_row(self, window: int) -> int:
        """Smallest row r0 such that rows [r0, n) hold <= window valid chunks
        and they are exactly the ``window`` most recent. window <= 0 means
        no window. O(n/VALID_BLOCK) over the per-block valid counts."""
        if window <= 0 or self._n_valid <= window:
            return 0
        nb = (self._n + VALID_BLOCK - 1) // VALID_BLOCK
        counts = self._block_valid[:nb]
        suffix = np.cumsum(counts[::-1])[::-1]
        hits = np.nonzero(suffix >= window)[0]
        if hits.size == 0:
            return 0
        b = int(hits[-1])
        after = int(suffix[b + 1]) if b + 1 < nb else 0
        need = window - after
        hi = min(self._n, (b + 1) * VALID_BLOCK)
        in_block = np.nonzero(self.valid[b * VALID_BLOCK : hi])[0]
        if in_block.size == 0:
            return b * VALID_BLOCK
        need = min(need, int(in_block.size))
        return b * VALID_BLOCK + int(in_block[-need])

    # ---- device sync ----

    def _put(self, host):
        """A host plane on the device, or row-sharded over the mesh (each
        shard's rows on its device; RowSharded)."""
        if self.mesh is None:
            return upload_slabbed(host, self.device)
        from omni_recall_tpu_torch.parallel.mesh import row_sharding

        return row_sharding(self.mesh, host, upload=upload_slabbed)

    # full uploads at/above this row count quantize (or round to bf16) ON
    # DEVICE; below it the host quantizer (ops/quantize.py) keeps small
    # indexes bit-stable with it
    _DEVICE_QUANTIZE_MIN_ROWS = 1 << 16
    # f32 rows uploaded at a time when the device rounds them to bf16
    _BF16_SLAB_ROWS = 1 << 18

    def device_arrays(self) -> DeviceArrays:
        """Upload pending host changes and return the device-resident SoA.
        Thread-safe against concurrent mutation (shared lock)."""
        with self._lock:
            if self._device is None or self._device_cap != self._cap:
                self._full_upload()
            elif self._dirty_blocks:
                self._sync_dirty()
            return self._device

    def _convert_host(self, rows: np.ndarray) -> dict:
        """Host f32 rows -> the scan planes (device_index.py _convert_emb):
        the int8 planes (+ the residual plane with refine), the rows rounded
        to bf16, or the f32 rows themselves."""
        if self.scan_dtype == "bf16":
            return {"emb": torch.from_numpy(rows).to(torch.bfloat16)}
        if self.scan_dtype == "f32":
            return {"emb": rows}
        if self.refine:
            return dict(zip(_QUANT_PLANES, quantize_rows_int8_residual(rows)))
        return dict(zip(_QUANT_PLANES, quantize_rows_int8(rows)))

    def _device_bf16(self) -> torch.Tensor:
        """The bf16 scan plane rounded on the device, a slab of f32 rows at
        a time (the same round-to-nearest-even as the host conversion)."""
        out = torch.empty(self.emb.shape, dtype=torch.bfloat16, device=self.device)
        for lo in range(0, self._cap, self._BF16_SLAB_ROWS):
            hi = lo + self._BF16_SLAB_ROWS
            out[lo:hi] = self._put(self.emb[lo:hi])
        return out

    def _full_upload(self) -> None:
        raw_dev = None
        large = self._cap >= self._DEVICE_QUANTIZE_MIN_ROWS
        pre = self._preconverted
        if pre is not None and pre["emb"].shape[0] == self._cap:
            # snapshot restore: the staged planes, no re-quantization
            converted = {k: self._put(v) for k, v in pre.items()}
            if self.exact_cos:
                raw_dev = self._put(self.raw_emb)
        elif large and self.scan_dtype == "int8" and self.mesh is None:
            up = self._put(self.emb)
            converted = device_quantize(up, refine=self.refine)
            if self.exact_cos:
                raw_dev = up if self._raw_aliased else self._put(self.raw_emb)
            del up
        else:
            if large and self.scan_dtype == "bf16" and self.mesh is None:
                converted = {"emb": self._device_bf16()}
            else:
                converted = {k: self._put(v) for k, v in self._convert_host(self.emb).items()}
            if self.exact_cos:
                raw_dev = self._put(self.raw_emb)
        self._preconverted = None
        self._device = DeviceArrays(
            bloom=self._put(self.bloom), created=self._put(self.created),
            valid=self._put(self.valid), raw=raw_dev, **converted,
        )
        self._device_cap = self._cap
        self._dirty_blocks.clear()

    def _sync_dirty(self) -> None:
        block = self.capacity_block
        dev = self._device
        for b in sorted(self._dirty_blocks):
            lo = b * block
            if lo >= self._cap:
                continue
            hi = min(lo + block, self._cap)
            for name, plane in self._convert_host(self.emb[lo:hi]).items():
                _write_rows(getattr(dev, name), lo, _host_tensor(plane))
            _write_rows(dev.bloom, lo, torch.from_numpy(self.bloom[lo:hi]))
            _write_rows(dev.created, lo, torch.from_numpy(self.created[lo:hi]))
            _write_rows(dev.valid, lo, torch.from_numpy(self.valid[lo:hi]))
            if dev.raw is not None:
                _write_rows(dev.raw, lo, torch.from_numpy(self.raw_emb[lo:hi]))
        self._dirty_blocks.clear()


def _write_rows(plane, lo: int, rows: torch.Tensor) -> None:
    """Copy host ``rows`` into device rows [lo, lo + len): into the plane
    itself, or into each local shard of a row-sharded plane that holds some
    of them."""
    hi = lo + rows.shape[0]
    shards = getattr(plane, "shards", None)
    if shards is None:
        plane[lo:hi].copy_(rows)
        return
    n_local = plane.n_local
    for shard, r0 in zip(shards, plane.row0):
        a, b = max(lo, r0), min(hi, r0 + n_local)
        if a < b:
            shard[a - r0:b - r0].copy_(rows[a - lo:b - lo])
