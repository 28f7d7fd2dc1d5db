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
queued). Not in this port yet: snapshot restore, compact bulk indexes and
the sharded mesh.

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
    ) -> None:
        if bloom_bits % 8 != 0:
            raise ValueError("bloom_bits must be a multiple of 8")
        if scan_dtype not in SCAN_DTYPES:
            raise ValueError(f"unsupported scan_dtype: {scan_dtype}")
        self.device = resolve_device(device)
        self.dim = dim
        self.scan_dtype = scan_dtype
        # keep the residual int8 plane (K3): int8 storage only
        self.refine = bool(refine) and scan_dtype == "int8"
        self.exact_cos = bool(exact_cos)
        self.capacity_block = max(128, capacity_block)
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
        self._device: DeviceArrays | None = None
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

    def append(self, chunks: list[ChunkRecord]) -> None:
        if not chunks:
            return
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

    def _put(self, host) -> torch.Tensor:
        return _host_tensor(host).to(self.device, copy=True)

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
        if large and self.scan_dtype == "int8":
            up = self._put(self.emb)
            converted = device_quantize(up, refine=self.refine)
            if self.exact_cos:
                raw_dev = up if self._raw_aliased else self._put(self.raw_emb)
            del up
        else:
            if large and self.scan_dtype == "bf16":
                converted = {"emb": self._device_bf16()}
            else:
                converted = {k: self._put(v) for k, v in self._convert_host(self.emb).items()}
            if self.exact_cos:
                raw_dev = self._put(self.raw_emb)
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
                getattr(dev, name)[lo:hi].copy_(_host_tensor(plane))
            dev.bloom[lo:hi].copy_(torch.from_numpy(self.bloom[lo:hi]))
            dev.created[lo:hi].copy_(torch.from_numpy(self.created[lo:hi]))
            dev.valid[lo:hi].copy_(torch.from_numpy(self.valid[lo:hi]))
            if dev.raw is not None:
                dev.raw[lo:hi].copy_(torch.from_numpy(self.raw_emb[lo:hi]))
        self._dirty_blocks.clear()
