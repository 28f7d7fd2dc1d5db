"""Certified-exact hybrid search engine (PyTorch port of
omni_recall_tpu/search/engine.py).

The device computes a *sound upper bound* per chunk — with the int8 scans
(ops/scorer.py: K1 coarse, K4 fused, K5 keyword-only), the f32/bf16 scan
(K6), all CUDA kernels, or the plain-torch xla scorer (ops/xla_scorer.py)
— and returns the top-M candidate rows, optionally re-bounded tighter by the
residual refine stage (ops/refine.py, K3, on indexes with the residual
planes); the host exact-rescores only those candidates (float64, substring
keyword semantics) — or, with the device-exact cosine (ops/exact_cos.py,
K2), scores keyword + recency on the host and certifies the device
double-float cosines — and verifies a certificate:

    exact_score(k-th hit)  >  max upper bound over all excluded rows

If it fails, the candidate set widens (wide rescue, then the fused rescue
scan with M x4, its candidates refined by K3 where the planes exist) until
it covers the whole window, at which point the result is trivially exact;
queries still open at the escalation ceiling go to the exact host scan.
The returned ranking is identical to scoring every chunk exactly. Final
ordering: score desc, created_at desc (RecallSearchService.cs:34-35),
insertion seq desc.

A batch is split into ``_dispatch_device_batch`` (index snapshot, query
operands, the prepass scans queued on the device, non-blocking copies of
their compact results into pinned host memory) and
``_finalize_device_batch`` (host certification, rescue, oracle fill), so
``search_batches_pipelined`` overlaps one batch's host work with the next
batch's device work.

With an embedder attached (``attach_device_embedder``: the local encoder of
Embeddings:Provider=Local), requests without an embedding are embedded on
the card inside the dispatch; their rows feed the scans directly and reach
the host only when a certificate escalates (``ensure_host_q``).

Backends: ``pallas`` (the hand-written-kernel backend; the name is kept so
configurations carry over) over int8, f32 or bf16 scan storage, ``xla``
(the reference's default: the plain-torch scorer over f32 storage, which
also serves pallas f32 scans beyond K6's extraction budget) and ``oracle``
(host float64 only).

With a ``mesh`` (Engine:Shards > 0, parallel/mesh.py) the index rows are
row-sharded and every scan, the refine selection and the device-exact
cosine run per shard through parallel/sharded.py ShardedScorer, merged by
its all-gather and exact-zero combine. The sharded engine serves the same
results as the single-device one; it normalizes queries on the host (f64,
rounded to f32), never takes the direct selection or the device embedder,
and its rescue scans run without K3 (search/engine.py:486-497, 530-533).

Invariants this port preserves, word for word from the repository's working
notes ("Invariants to preserve"):

- Exactness = runtime certificate (`exact kth > max excluded upper bound`);
  any device-side approximation MUST keep scores sound UPPER bounds (see
  ops/pallas_scorer.py docstrings for the eps/error-norm derivations —
  bf16 eps counts BOTH operands' rounding (8e-3); int8 uses 4e-3 with
  explicit eq/ec folding, built ONLY via `prepare_int8_query`/
  `coarse_q_bias`/`quantize_kw_weights`, shared with parallel/sharded.py).
- Full-coverage acceptance comes from the scan itself (boundary == -inf),
  never from a separately-read row count (append races make it stale); an
  in-place embedding update bumps `DeviceIndex.update_seq` and the
  certificate re-checks it after the rescore (reindex race → host scan).
- Index rows are append-only in (created_at, seq) order — the recency window
  depends on it; never reorder or reuse rows (rebuild_index compacts).
- Bloom packing: bit j -> word `j % W`, bit `j // W` (kernel decode relies
  on it); the native C builder must stay bit-identical to ops/hashing.py.
- The coarse prepass (cosine-only scan, keyword capped at
  0.2*min(1, sum_w+bias)) is sound ONLY under the certificate — never rank
  by coarse values in the approximate profile.
- Device-exact-cosine mode (`Engine:DeviceExactCos`, ops/exact_cos.py) may
  return cosines that differ from the f64 oracle ONLY within a certified
  margin: ranking order, tie-breaks, and the round-4 DTO must be provably
  oracle-identical per query, else that query MUST escalate to the host
  float64 rescore. Never weaken the TwoSum tree (no FMA/reassociation) or
  the margin accounting (DD_SUM_REL et al.) without re-deriving the bound.
- The native hybrid rescorer must stay bit-identical to the numpy path
  (`np.sum(f32 products, dtype=f64)` pairwise summation); the loader
  self-verifies at startup and falls back to numpy if numpy's reduction
  algorithm ever changes. Compile with `-ffp-contract=off`.
- The index content arena (`_arena`/`content_off`) may only be read under
  `DeviceIndex._lock` (bytearray growth reallocates); deleted rows keep
  their bytes until rebuild_index compacts.
- Compact bulk indexes (`bulk_load_compact`, index/compact.py) define the
  stored embedding AS fl32(int8 * scale) with err_row covering
  |norm − 1| + the raw_norm_sq shortcut — re-derive that bound before
  changing scale/S2 construction. Host and device planes MUST come from
  the same integer recipe (`rows_np`/`rows_jnp` are bit-identical
  mirrors); `bulk_load_compact` callers own the same contract.
- Every DD consumer must go through `exact_cos.dd_rows` (backend
  dispatcher): single-device and sharded paths must produce the same
  bits per backend (tools/tpu_sharded_check.py asserts it on chip).
- Reference behavior mirrors carry `file:line` citations in docstrings —
  keep them accurate when changing semantics.

(In this port the DD dispatchers are ``exact_cos.exact_cos_rows``, K2 by
index, and ``exact_cos.dd_rows``, K2 over gathered rows, one fold.)
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass
from datetime import datetime, timezone

import numpy as np
import torch

from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.device import is_device_error, resolve_device
from omni_recall_tpu_torch.index.device_index import DeviceIndex, to_days, to_micros
from omni_recall_tpu_torch.index.records import ChunkRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.ops import (
    exact_cos,
    hashing,
    native,
    oracle,
    refine,
    scorer,
    xla_scorer,
)
from omni_recall_tpu_torch.utils import tracing


class _HostCopy:
    """Non-blocking device->host copies into pinned memory, started at
    dispatch and waited for at finalize (the finalize then finds the
    compact candidate slices already on the host)."""

    def __init__(self, tensors) -> None:
        self.host = []
        self.event = None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t
            self.host.append(h)
        if any(t.is_cuda for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> list[np.ndarray]:
        with tracing.span(tracing.WAIT):
            if self.event is not None:
                self.event.synchronize()
        return [h.numpy() for h in self.host]


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host -> device copy that does not block the host: staged through
    pinned memory (the caching host allocator keeps the staging buffer
    alive until the copy has run). A copy from pageable memory would wait
    for every kernel already queued, serializing dispatch behind the
    previous batch's scans."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


def _densify_kw(idx: torch.Tensor, val: torch.Tensor, bits: int) -> torch.Tensor:
    """Scatter sparse per-query keyword weights (idx i32[B, T], -1 padding;
    val f32[B, T]) into the dense [B, bits] matrix the scans take. Indices
    are unique per query, so every real cell receives exactly one add onto
    0.0 (pads add 0.0 at column 0): bit-identical to the dense builder."""
    b = idx.shape[0]
    dense = torch.zeros((b, bits), dtype=val.dtype, device=val.device)
    live = idx >= 0
    return dense.scatter_add_(
        1, torch.where(live, idx, torch.zeros_like(idx)).long(),
        torch.where(live, val, torch.zeros_like(val)),
    )


def _rehome_rows(b: int, pending: list[int], arrays_fills) -> list[np.ndarray]:
    """Scatter per-pending-row arrays back to their full-batch positions;
    other rows get the fill value (-inf bounds / -1 row ids)."""
    out = []
    for a, fill in arrays_fills:
        f = np.full((b,) + a.shape[1:], fill, a.dtype)
        f[pending] = a[: len(pending)]
        out.append(f)
    return out


def _dd_certify_batch(
    scores_s: np.ndarray,
    margins_s: np.ndarray,
    seg: np.ndarray,
    lens: np.ndarray,
    k_arr: np.ndarray,
    bnd: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized device-exact-cosine certification over a batch of queries
    (search/engine.py _dd_certify_batch, verbatim). Inputs are the
    owner-contiguous flat candidate arrays (sorted descending within each
    segment), the P+1 segment offsets, per-query candidate counts, the
    requested k and the per-query device certificate bound (-inf when the
    slice covers the whole snapshot). Returns ``(resolved, provable_fail,
    kk)``: ``provable_fail`` — the bit-exact host rescore would fail too
    (skip it, go to the scan escalation); ``resolved`` — every certificate
    holds (kth above bound with margin, adjacent ranking non-overlap or
    exact zero-margin ties, tail domination, 4-decimal DTO invariance);
    neither — escalate to the bit-exact host rescore."""
    p = len(lens)
    total = int(seg[-1])
    lmax = max(int(lens.max()), 1)
    rowix = np.arange(p)
    col = np.arange(lmax)[None, :]
    owner_flat = np.repeat(rowix, lens)
    pos_flat = np.arange(total) - np.repeat(seg[:-1], lens)
    s = np.full((p, lmax), -np.inf)
    m = np.zeros((p, lmax))
    s[owner_flat, pos_flat] = scores_s
    m[owner_flat, pos_flat] = margins_s
    kk_arr = np.minimum(k_arr, lens)

    has_b = bnd != -np.inf
    idxk = np.clip(k_arr - 1, 0, lmax - 1)
    sk, mk = s[rowix, idxk], m[rowix, idxk]
    # a sound UPPER bound on the exact kth is the kth largest of s + m
    uk = (-np.sort(-(s + m), axis=1))[rowix, idxk]
    provable = has_b & ((lens < k_arr) | (uk <= bnd))
    margin_fail = has_b & ~provable & ~(sk - mk > bnd)

    n_pairs = np.minimum(kk_arr, np.maximum(lens - 1, 0))
    if lmax > 1:
        with np.errstate(invalid="ignore"):
            gap_ok = s[:, :-1] - s[:, 1:] > m[:, :-1] + m[:, 1:]
        tie_ok = (
            (s[:, :-1] == s[:, 1:]) & (m[:, :-1] == 0.0) & (m[:, 1:] == 0.0)
        )
        pair_m = col[:, : lmax - 1] < n_pairs[:, None]
        rank_fail = (~(gap_ok | tie_ok) & pair_m).any(axis=1)
    else:
        rank_fail = np.zeros(p, dtype=bool)
    idxkk = np.clip(kk_arr - 1, 0, lmax - 1)
    top_s, top_m = s[rowix, idxkk][:, None], m[rowix, idxkk][:, None]
    tail_mask = (col >= kk_arr[:, None]) & (col < lens[:, None])
    tail_bad = ~(
        ((top_s - top_m) > s + m)
        | ((s == top_s) & (m == 0.0) & (top_m == 0.0))
    )
    tail_fail = (tail_bad & tail_mask).any(axis=1) & (kk_arr >= 1)
    r4_fail = (
        ~exact_cos.round4_certified(s, m) & (col < kk_arr[:, None])
    ).any(axis=1)

    resolved = ~provable & ~margin_fail & ~(rank_fail | tail_fail | r4_fail)
    return resolved, provable, kk_arr


@dataclass(frozen=True)
class SearchHit:
    chunk: ChunkRecord
    score: float  # exact, unrounded


def _sort_key(hit: SearchHit):
    ts = hit.chunk.created_at_utc or datetime.min.replace(tzinfo=timezone.utc)
    return (-hit.score, -ts.timestamp(), -hit.chunk.seq)


class RecallEngine:
    def __init__(
        self,
        store: InMemoryIngestionStore,
        device_index: DeviceIndex | None = None,
        options: EngineOptions | None = None,
        *,
        device: str | torch.device = "cuda",
        mesh=None,
    ) -> None:
        self.store = store
        self.options = options or EngineOptions()
        if device_index is not None:
            self.device = device_index.device
            mesh = mesh if mesh is not None else device_index.mesh
        elif mesh is not None:
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)
        if device_index is None and self.options.backend != "oracle":
            # the reference's expressions (search/engine.py:312-328): only
            # the pallas backend scans int8/bf16 storage, and the
            # device-exact cosine serves int8 refine indexes only
            pallas = self.options.backend == "pallas"
            scan_dtype = self.options.scan_dtype if pallas else "f32"
            device_index = DeviceIndex(
                self.options.embedding_dim,
                capacity_block=self.options.capacity_block,
                bloom_bits=self.options.bloom_bits,
                ngram=self.options.ngram,
                bloom_hashes=self.options.bloom_hashes,
                scan_dtype=scan_dtype,
                refine=self.options.refine,
                exact_cos=(self.options.device_exact_cos and self.options.refine
                           and pallas and self.options.scan_dtype == "int8"),
                device=self.device,
                mesh=mesh,
            )
        self.device_index = device_index
        # the row-sharded serving mode (search/engine.py:330-341)
        self.mesh = mesh
        self._sharded_scorer = None
        if mesh is not None:
            from omni_recall_tpu_torch.parallel.sharded import ShardedScorer

            self._sharded_scorer = ShardedScorer(mesh)
        if self.device_index is not None:
            if self.device_index.scan_dtype == "f32":
                # the xla scorer may serve f32 storage: fail here, not at the
                # first search, if TF32 would make its bounds unsound
                xla_scorer.check_tf32_off()
            # warm the native library (compile + bit-identity self-check)
            # outside any index lock
            native.rescore_available()
        # device-resident query pipeline (attach_device_embedder): requests
        # arriving without an embedding are embedded on the card and their
        # raw query rows cross to the host only for escalations
        self._device_embedder = None
        # written only under _stats_lock, once a batch (_add_stats)
        self.stats = {
            "searches_total": 0,          # queries served
            "coarse_resolved_total": 0,   # resolved by the coarse prepass
            "escalation_rounds_total": 0, # certificate escalation rounds
            "host_fallbacks_total": 0,    # queries finished by the host scan
            "rescore_pairs_total": 0,       # (query,row) pairs exact-rescored
            "rescore_pairs_saved_total": 0, # pairs skipped by the 2-phase prune
            "kw_only_resolved_total": 0,    # resolved by the keyword-only scan
            "dd_resolved_total": 0,         # certified via device-exact cosine
            "dd_escalations_total": 0,      # DD margin failures -> host rescore
            "rescue_sliced_total": 0,       # rescue scans run at sliced width
            "rescue_wide_total": 0,         # wide re-reads of dispatch scans
        }
        self._stats_lock = threading.Lock()
        # adaptive prepass gate (search/engine.py): disable the coarse
        # prepass while its certificate keeps failing, re-probe later
        self._coarse_outcomes: list[int] = []
        self._coarse_skip_until = 0
        self._coarse_query_count = 0
        self._coarse_gate_lock = threading.Lock()
        # adaptive DIRECT-SELECT gate (search/engine.py, same lock): the
        # direct selection's certificate bound is the (t_out+1)-th scan
        # bound; while it keeps missing, fall back to the refine selection
        # and re-probe later, with an exponential backoff of the horizon.
        # Exactness is identical either way — this gates throughput only.
        self._direct_outcomes: list[int] = []
        self._direct_skip_until = 0
        self._direct_query_count = 0
        self._direct_skip_h = 2048
        self._last_select_direct: bool | None = None
        # serializes index mutation (append/update/delete); searches never
        # take it
        self.mutation_lock = threading.RLock()

    def _add_stats(self, tally: dict) -> None:
        """Add a batch's counts (keys of ``stats``) to the totals: the
        dispatcher, the finalize worker and direct callers share them."""
        with self._stats_lock:
            for key, n in tally.items():
                if n:
                    self.stats[key] += n

    def attach_device_embedder(self, embedder) -> None:
        """Enable the device-resident query pipeline (search/engine.py:408-434):
        requests whose query_embedding is None (and whose text is non-blank)
        are embedded on the card by ``embedder.embed_device(texts) ->
        f32[B, dim]`` and chained straight into the scan dispatch: no
        per-query vector upload, no embedding readback on certified
        queries. The exactness contract is unchanged: every certificate is
        taken against the materialized bits of the forward (the canonical
        query embedding), and escalations read those bits back losslessly.
        ``None`` detaches. Requires a single-device engine whose device
        backend's index has the embedder's dim."""
        if embedder is None:
            self._device_embedder = None
            return
        if self.options.backend == "oracle" or self.device_index is None:
            raise ValueError("device embedder requires a device backend")
        if self._sharded_scorer is not None:
            # the sharded path uploads host-built operands (search/engine.py:418-427)
            raise ValueError("device embedder is single-device only")
        dim = getattr(embedder, "dim", None)
        if dim != self.device_index.dim:
            raise ValueError(f"embedder dim {dim} != index dim {self.device_index.dim}")
        self._device_embedder = embedder

    # -- index lifecycle hooks (called by the ingestion service) --

    def on_chunks_upserted(self, chunks: list[ChunkRecord], *, new: bool) -> None:
        with self.mutation_lock:
            if self.device_index is None:
                return
            if new:
                self.device_index.append(chunks)
            else:
                for chunk in chunks:
                    self.device_index.update_embedding(chunk.id, chunk.embedding)

    def on_document_deleted(self, document_id: str) -> None:
        with self.mutation_lock:
            if self.device_index is not None:
                self.device_index.delete_document(document_id)

    def rebuild_index(self) -> str:
        """Shadow rebuild + atomic swap: build a fresh device index from the
        store's current chunks (compacting tombstones; unchanged records
        reuse the old index's derived columns and, when every row is reused,
        its device planes through one on-device gather — see
        DeviceIndex.append_from_index), upload it, then swap it in. Searches
        in flight keep the old index and its tensors, which nothing writes
        to after the swap, so there is no torn state.

        Holds ``mutation_lock`` across the store read, the build and the
        swap, so a concurrent ingest lands either in the store before the
        read or in the new index after the swap. Returns the route of the
        new device planes (``"device"`` or ``"upload"``), ``"none"`` without
        an index. A compact bulk index is serving-only: its rebuild raises
        RuntimeError and leaves it in place."""
        with self.mutation_lock:
            if self.device_index is None:
                return "none"
            old = self.device_index
            shadow = DeviceIndex(
                old.dim,
                capacity_block=self.options.capacity_block,
                bloom_bits=old.bloom_bits,
                ngram=old.ngram,
                bloom_hashes=old.bloom_hashes,
                scan_dtype=old.scan_dtype,
                refine=old.refine,
                exact_cos=old.exact_cos,
                device=old.device,
                mesh=old.mesh,
            )
            chunks: list[ChunkRecord] = []
            for doc in self.store.list_documents(2**31 - 1):
                chunks.extend(self.store.get_chunks_by_document_id(doc.id))
            chunks.sort(key=lambda c: c.seq)
            route = shadow.append_from_index(old, chunks)
            shadow.device_arrays()  # upload before the swap so search never waits
            self.device_index = shadow
            return route

    # refine width ceiling: the refine gather grows with m, and beyond this
    # width the escalation path is rare anyway (search/engine.py)
    _REFINE_MAX_M = 2048
    # certificate-escalation ceiling for the device loop
    _ESCALATION_MAX_M = 2048

    def _refine_call(self, dev, q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d, m):
        """The [B, m] refined bounds of the scan's candidate rows (K3,
        ops/refine.py refine_ub_from_scan), queued on the same stream, or
        None without residual planes, on a sharded index (the reference's
        sharded rescue runs without it) or above the refine ceiling."""
        if dev.emb2 is None or self._sharded_scorer is not None or m > self._REFINE_MAX_M:
            return None
        return refine.refine_ub_from_scan(
            dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2, dev.bloom,
            dev.created, dev.valid, q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d,
        )

    def _refine_select_call(self, dev, q_dev, w_dev, bias_dev, now_dev,
                            vals_d, idxs_d, m: int, max_k: int, q_raw_dev=None):
        """``(sel, dd)``: ``sel`` the compact (rows, ubs, bound) device
        triple — the direct selection straight from the scan bounds when
        Engine:DirectSelect is on and its gate is open (or refine is
        impossible), else the refine selection (K3 + ops/refine.py
        compact_select), or on a sharded index ShardedScorer.
        refine_select_dd — or None when neither applies (the certificate
        then runs at the full scan width on the host). ``dd`` is the
        device-exact cosine triple when the sharded stage computed it
        (``q_raw_dev`` given, raw plane present), else None: single-device
        callers chain K2 themselves. Records which selection it took in
        ``_last_select_direct`` (None without Engine:DirectSelect; a
        sharded engine never takes the direct one)."""
        # t_out covers the largest requested k with phase-2 headroom, a
        # power of two
        t_base = self.options.select_t_out
        if t_base:
            t_out = max(t_base, max_k + 4)
        else:
            t_out = max(32, self.options.rescore_phase1_refined + 4, max_k + 8)
        t_out = 1 << (t_out - 1).bit_length()
        direct_opt = self.options.direct_select and self._sharded_scorer is None
        use_direct = direct_opt and (
            dev.emb2 is None or m > self._REFINE_MAX_M or self._direct_gate_open()
        )
        self._last_select_direct = use_direct if direct_opt else None
        if use_direct:
            rows, ubs, bound = refine.direct_select_from_scan(
                vals_d, idxs_d, min(t_out, max(1, m - 1))
            )
            return (rows.contiguous(), ubs, bound), None
        if dev.emb2 is None or m > self._REFINE_MAX_M:
            return None, None
        # refine width: only the top-r scan candidates are refined; the
        # (r+1)-th scan bound joins the certificate bound. The rounding to
        # a multiple of 8 (the TPU kernel's shape rule) is kept: r decides
        # that bound, so it decides results.
        r = self.options.refine_width or m
        r = max(t_out, min(r, m))
        r = ((r + 7) // 8) * 8
        if self._sharded_scorer is not None:
            want_dd = (q_raw_dev is not None and dev.raw is not None
                       and self.options.device_exact_cos)
            out = self._sharded_scorer.refine_select_dd(
                dev, q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d,
                t_out=t_out, r=min(r, m), q_raw=q_raw_dev if want_dd else None,
            )
            return (tuple(out[:3]), tuple(out[3:])) if want_dd else (tuple(out), None)
        return refine.refine_select_from_scan(
            dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2, dev.bloom,
            dev.created, dev.valid, q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d,
            t_out=t_out, r=min(r, m),
        ), None

    # -- search --

    def search(
        self,
        query: str,
        query_embedding: list[float] | None,
        top_k: int,
        now: datetime | None = None,
    ) -> list[SearchHit]:
        return self.search_batch([(query, query_embedding, top_k)], now=now)[0]

    def search_batch(
        self,
        requests: list[tuple[str, list[float] | None, int]],
        now: datetime | None = None,
    ) -> list[list[SearchHit]]:
        """Score a batch of queries in one device pass; each request is
        (query, query_embedding, top_k)."""
        now = now or datetime.now(timezone.utc)
        window = self.options.recent_window
        if not requests:
            return []
        if self.options.backend == "oracle" or self.device_index is None:
            self._add_stats({"searches_total": len(requests)})
            return [
                self._search_oracle(q, emb, max(1, k), window, now)
                for q, emb, k in requests
            ]
        # the finalize counts the device path's searches
        tracing.new_batch()
        return self._finalize_device_batch(
            self._dispatch_device_batch(requests, window, now)
        )

    def search_batches_pipelined(
        self,
        batches: list[list[tuple[str, list[float] | None, int]]],
        now: datetime | None = None,
    ) -> list[list[list[SearchHit]]]:
        """Dispatch every batch's device scans before finalizing any; one
        finalize worker thread overlaps batch i's host certification with
        batch i+1's dispatch. Semantically identical to search_batch per
        batch (each batch snapshots the index at its own dispatch)."""
        now = now or datetime.now(timezone.utc)
        window = self.options.recent_window
        if self.options.backend == "oracle" or self.device_index is None:
            return [self.search_batch(reqs, now=now) for reqs in batches]
        if len(batches) <= 1:
            ctxs = []
            for reqs in batches:
                tracing.new_batch()
                ctxs.append(self._dispatch_device_batch(reqs, window, now))
            return [self._finalize_device_batch(ctx) for ctx in ctxs]
        from concurrent.futures import ThreadPoolExecutor

        futures = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            for reqs in batches:
                tracing.new_batch()
                ctx = self._dispatch_device_batch(reqs, window, now)
                futures.append(pool.submit(self._finalize_device_batch, ctx))
            return [f.result() for f in futures]

    # -- scorer selection --

    def _select_scorer(self, m: int, n_rows_padded: int):
        """(scorer, full_coverage) for this escalation round
        (search/engine.py:688-734, single device). Under the pallas backend
        the fused scan of the storage type — K4 on int8, K6 on f32/bf16 —
        while its extraction budget covers m; it emits per-slice top-t only,
        so it never guarantees full coverage (False). Otherwise the xla
        scorer, whose top-(m+1) covers every row once m reaches the window
        (True), on f32 storage; on int8/bf16 storage nothing can feed it,
        so (None, True): the exact host scan finishes. A sharded engine
        takes ``_select_sharded_scorer``."""
        scan_dtype = self.device_index.scan_dtype
        if self._sharded_scorer is not None:
            return self._select_sharded_scorer(m, n_rows_padded, scan_dtype)
        if self.options.backend == "pallas":
            itemsize = {"int8": 1, "bf16": 2}.get(scan_dtype, 4)
            c = scorer._pick_block(n_rows_padded, itemsize)
            if c > 0:
                sub = min(512, c)
                slices = n_rows_padded // sub
                # ~2x the needed candidates per slice, floored at 4 for the
                # co-location reason of _coarse_layout
                t = min(scorer.PALLAS_BLOCK_T, sub - 1, max(4, math.ceil(2 * m / slices)))
                if m <= slices * t:
                    if scan_dtype == "int8":
                        def fused(dev, q, w, bias, now_days, r0, m):
                            return scorer.score_topm_int8(
                                dev.emb, dev.scale, dev.err, dev.bloom, dev.created,
                                dev.valid, q, w, bias, now_days, r0, m=m, t=t, sub=sub,
                            )
                        return fused, False

                    def fused_fp(dev, q, w, bias, now_days, r0, m):
                        return scorer.score_topm(
                            dev.emb, dev.bloom, dev.created, dev.valid, q, w, bias,
                            now_days, r0, m=m, t=t, sub=sub,
                        )
                    return fused_fp, False
        if scan_dtype != "f32":
            return None, True

        def xla(dev, q, w, bias, now_days, r0, m):
            return xla_scorer.score_topm(
                dev.emb, dev.bloom, dev.created, dev.valid, q, w, bias,
                now_days, r0, m=m,
            )
        return xla, True

    def _select_sharded_scorer(self, m: int, n_rows_padded: int, scan_dtype: str):
        """The sharded ``_select_scorer`` (search/engine.py:660-686): the
        shards' fused scan (K4 on int8, K6 on f32/bf16) at sub 512 while
        ``pallas_budget`` covers m, else the xla pass on f32 storage, which
        covers every local row once m reaches the window."""
        ss = self._sharded_scorer
        mode, t, sub = "xla", 8, 512
        if self.options.backend == "pallas":
            slices = ss.pallas_budget(n_rows_padded)
            if slices > 0:
                t_try = min(scorer.PALLAS_BLOCK_T, sub - 1, max(1, math.ceil(2 * m / slices)))
                if m <= slices * t_try:
                    mode = "pallas_int8" if scan_dtype == "int8" else "pallas"
                    t = t_try
        if mode == "xla" and scan_dtype != "f32":
            return None, True  # quantized storage cannot feed the xla pass

        def sharded(dev, q, w, bias, now_days, r0, m):
            return ss.score_topm(
                dev.emb, dev.bloom, dev.created, dev.valid, q, w, bias, now_days, r0,
                m=m, mode=mode, t=t, sub=sub, scale=dev.scale, err=dev.err,
            )
        return sharded, mode == "xla"

    def _coarse_gate_open(self) -> bool:
        with self._coarse_gate_lock:
            return self._coarse_query_count >= self._coarse_skip_until

    def _coarse_gate_advance(self, attempted: int) -> None:
        with self._coarse_gate_lock:
            self._coarse_query_count += attempted

    def _coarse_gate_record(self, resolved: int, attempted: int) -> None:
        with self._coarse_gate_lock:
            self._coarse_query_count += attempted
            self._coarse_outcomes.extend(
                [1] * resolved + [0] * (attempted - resolved)
            )
            if len(self._coarse_outcomes) > 128:
                self._coarse_outcomes = self._coarse_outcomes[-128:]
            if (
                len(self._coarse_outcomes) >= 32
                and sum(self._coarse_outcomes) / len(self._coarse_outcomes) < 0.5
            ):
                self._coarse_skip_until = self._coarse_query_count + 2048
                self._coarse_outcomes = []

    def _direct_gate_open(self) -> bool:
        with self._coarse_gate_lock:
            return self._direct_query_count >= self._direct_skip_until

    def _direct_gate_advance(self, attempted: int) -> None:
        with self._coarse_gate_lock:
            self._direct_query_count += attempted

    def _direct_gate_record(self, resolved: int, attempted: int) -> None:
        """Compact-certificate outcomes under DIRECT selection: close the
        gate (fall back to the refine selection) when the rolling
        resolution drops below 0.9; each consecutive closing doubles the
        skip horizon, a healthy window resets it."""
        with self._coarse_gate_lock:
            self._direct_query_count += attempted
            self._direct_outcomes.extend(
                [1] * resolved + [0] * (attempted - resolved)
            )
            if len(self._direct_outcomes) > 128:
                self._direct_outcomes = self._direct_outcomes[-128:]
            if (
                len(self._direct_outcomes) >= 32
                and sum(self._direct_outcomes) / len(self._direct_outcomes) < 0.9
            ):
                self._direct_skip_until = self._direct_query_count + self._direct_skip_h
                self._direct_skip_h = min(self._direct_skip_h * 2, 1 << 18)
                self._direct_outcomes = []
            elif len(self._direct_outcomes) >= 32:
                self._direct_skip_h = 2048  # healthy window: reset backoff

    def _select_coarse_scorer(self, m: int, n_rows_padded: int):
        """Cosine-only int8 prepass scorer (K1), or None when unavailable
        (exact profile only: the coarse bound's flat keyword cap must never
        rank results; int8 storage only)."""
        if not (
            self.options.exact
            and self.options.coarse_prepass
            and self.options.backend == "pallas"
            and self.device_index is not None
            and self.device_index.scan_dtype == "int8"
        ):
            return None
        ss = self._sharded_scorer
        # a sharded index lays out the scan of its local rows
        # (search/engine.py:815-837)
        n_rows = n_rows_padded if ss is None else ss.local_rows(n_rows_padded)
        c = scorer._pick_block_coarse(n_rows)
        if c == 0:
            return None
        layout = scorer._coarse_layout(
            n_rows, m, c,
            self.options.coarse_sub, self.options.coarse_t,
            prefer_shallow=True,
        )
        if layout is None:
            return None
        sub, t = layout
        if ss is not None:
            def sharded_coarse(dev, q, w, bias, now_days, r0, m):
                return ss.score_topm(
                    dev.emb, dev.bloom, dev.created, dev.valid, q, w, bias, now_days, r0,
                    m=m, mode="pallas_int8_coarse", t=t, sub=sub,
                    scale=dev.scale, err=dev.err,
                )
            return sharded_coarse

        def coarse(dev, q, w, bias, now_days, r0, m):
            return scorer.score_topm_int8_coarse(
                dev.emb, dev.scale, dev.err, dev.created, dev.valid,
                q, w, bias, now_days, r0, m=m, t=t, sub=sub,
            )
        return coarse

    def _select_kw_scorer(self, m: int, n_rows_padded: int):
        """Keyword-only scan (K5: bloom + recency, no emb read) for queries
        with no embedding, on every storage type (the bloom plane is u8);
        pallas only: under xla such queries take the xla scorer."""
        if not (
            self.options.exact
            and self.options.backend == "pallas"
            and self.device_index is not None
        ):
            return None
        ss = self._sharded_scorer
        n_rows = n_rows_padded if ss is None else ss.local_rows(n_rows_padded)
        c = scorer._pick_block(n_rows, 1)
        if c == 0:
            return None
        layout = scorer._coarse_layout(n_rows, m, c)
        if layout is None:
            return None
        sub, t = layout
        if ss is not None:
            def sharded_kw(dev, w, bias, now_days, r0, m):
                return ss.score_topm(
                    None, dev.bloom, dev.created, dev.valid, None, w, bias, now_days, r0,
                    m=m, mode="pallas_kw_only", t=t, sub=sub,
                )
            return sharded_kw

        def kw_only(dev, w, bias, now_days, r0, m):
            return scorer.score_topm_kw_only(
                dev.bloom, dev.created, dev.valid, w, bias, now_days, r0,
                m=m, t=t, sub=sub,
            )
        return kw_only

    # -- exact host scoring (float64, identical to ops/oracle.py) --

    def _exact_hits(
        self,
        chunks: list[ChunkRecord],
        query: str,
        query_embedding: list[float] | None,
        now: datetime,
    ) -> list[SearchHit]:
        return self._exact_hits_multi([(query, query_embedding)], [chunks], now)[0]

    def _exact_hits_multi(
        self,
        queries: list[tuple[str, list[float] | None]],
        chunk_lists: list[list[ChunkRecord]],
        now: datetime,
    ) -> list[list[SearchHit]]:
        """Exact hybrid scores for all queries' candidate sets in one pass —
        float64 math identical to ops/oracle.py."""
        nq = len(queries)
        flat_chunks: list[ChunkRecord] = []
        owner: list[int] = []
        for qi, chunks in enumerate(chunk_lists):
            flat_chunks.extend(chunks)
            owner.extend([qi] * len(chunks))
        total = len(flat_chunks)
        if total == 0:
            return [[] for _ in range(nq)]

        term_lists = [
            oracle.query_terms(q) if q.strip() else [] for q, _ in queries
        ]
        kw = np.zeros(total, dtype=np.float64)
        if any(term_lists):
            flat_terms: list[bytes] = []
            offsets = [0]
            for terms in term_lists:
                flat_terms.extend(t.encode("utf-8") for t in terms)
                offsets.append(len(flat_terms))
            scores = native.keyword_scores_multi(
                [c.content_lower_utf8() for c in flat_chunks],
                owner, flat_terms, offsets,
            )
            if scores is not None:
                kw = np.asarray(scores, dtype=np.float64)
            else:
                for i, c in enumerate(flat_chunks):
                    terms = term_lists[owner[i]]
                    if terms and c.content.strip():
                        kw[i] = oracle.keyword_score_terms(terms, oracle.lower_invariant(c.content))

        cos = np.zeros(total, dtype=np.float64)
        qvs: list[np.ndarray | None] = []
        q_norms = np.zeros(nq, dtype=np.float64)
        for q, emb in queries:
            if emb is not None and len(emb) > 0:
                qv = np.asarray(emb, dtype=np.float32)
                qvs.append(qv)
                q_norms[len(qvs) - 1] = float(np.sum((qv * qv).astype(np.float64)))
            else:
                qvs.append(None)
        dims = [qv.size if qv is not None else -1 for qv in qvs]
        rows = [
            i for i, c in enumerate(flat_chunks)
            if dims[owner[i]] > 0
            and c.embedding is not None and len(c.embedding) == dims[owner[i]]
            and q_norms[owner[i]] > 0.0
        ]
        if rows:
            same_dim = len({dims[owner[i]] for i in rows}) == 1
            if same_dim:
                a = np.asarray([flat_chunks[i].embedding for i in rows], dtype=np.float32)
                dq = a.shape[1]
                q_matrix = np.zeros((nq, dq), dtype=np.float32)
                for qi, qv in enumerate(qvs):
                    if qv is not None and qv.size == dq:
                        q_matrix[qi] = qv
                owner_rows = np.asarray(owner, dtype=np.int64)[rows]
                qm = q_matrix[owner_rows]
                dot = np.sum(a * qm, axis=1, dtype=np.float64)
                norm_a = np.sum(a * a, axis=1, dtype=np.float64)
                ok = norm_a > 0.0
                vals = np.zeros(len(rows), dtype=np.float64)
                nq_rows = q_norms[owner_rows]
                denom = np.sqrt(nq_rows[ok]) * np.sqrt(norm_a[ok])
                vals[ok] = dot[ok] / denom
                cos[rows] = vals
            else:
                for i in rows:
                    cos[i] = oracle.cosine_similarity(
                        qvs[owner[i]], flat_chunks[i].embedding
                    )

        min_dt = datetime.min.replace(tzinfo=timezone.utc)

        def _aware(dt):
            if dt is None:
                return min_dt
            return dt if dt.tzinfo is not None else dt.replace(tzinfo=timezone.utc)

        ages = np.asarray(
            [
                max(0.0, (now - _aware(c.created_at_utc)).total_seconds() / 86400.0)
                for c in flat_chunks
            ],
            dtype=np.float64,
        )
        rec = np.exp(-ages / oracle.RECENCY_HALF_LIFE_DAYS)
        scores = (
            oracle.COSINE_WEIGHT * cos
            + oracle.KEYWORD_WEIGHT * kw
            + oracle.RECENCY_WEIGHT * rec
        )
        out: list[list[SearchHit]] = [[] for _ in range(nq)]
        for i, (chunk, s) in enumerate(zip(flat_chunks, scores)):
            out[owner[i]].append(SearchHit(chunk, float(s)))
        return out

    _RESCORE_PHASE1 = 32  # candidates exact-rescored before the ub prune

    @staticmethod
    def _flat_terms(term_lists: list[list[str]]):
        flat_terms: list[bytes] = []
        q_term_off = [0]
        for terms in term_lists:
            flat_terms.extend(t.encode("utf-8") for t in terms)
            q_term_off.append(len(flat_terms))
        term_off = np.zeros(len(flat_terms) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in flat_terms], out=term_off[1:])
        return b"".join(flat_terms), term_off, np.asarray(q_term_off, dtype=np.int64)

    def _exact_rescore_rows(
        self,
        queries: list[tuple[str, list[float] | None]],
        row_lists: list[np.ndarray],
        now: datetime,
        dix=None,
        ub_lists: list[np.ndarray] | None = None,
        ks: list[int] | None = None,
        phase1: int | None = None,
        q_matrix: np.ndarray | None = None,
        q_norms: np.ndarray | None = None,
        term_lists: list[list[str]] | None = None,
        tally: dict | None = None,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Vectorized exact rescore over device-index ROW indices: per query
        (rows_sorted, scores_sorted) by the full ranking key, bit-identical
        to _exact_hits_multi / ops/oracle.py (raw f32 mirror with f64
        accumulation, exact integer-micros recency, native substring
        keyword). ``dix`` must be the caller's index snapshot. With
        ``ub_lists`` (sound, descending) and ``ks``, the two-phase prune
        rescores only the top candidates first and the tail only where its
        upper bound reaches the provisional kth (search/engine.py).
        ``tally``: the calling batch's counts (keys of ``stats``), which
        ``_finalize_device_batch`` adds to ``stats``; a direct call's are
        not counted."""
        if dix is None:
            dix = self.device_index
        if tally is None:
            tally = dict.fromkeys(self.stats, 0)
        if ub_lists is not None and ks is not None:
            if phase1 is None:
                phase1 = self.options.rescore_phase1
            p1s = [
                min(len(rows), max(phase1, ks[qi]))
                for qi, rows in enumerate(row_lists)
            ]
            if any(len(rows) > p1 for rows, p1 in zip(row_lists, p1s)):
                return self._exact_rescore_rows_pruned(
                    queries, row_lists, now, dix, ub_lists, ks, p1s,
                    q_matrix=q_matrix, q_norms=q_norms, term_lists=term_lists,
                    tally=tally,
                )
        nq = len(queries)
        lens = [len(r) for r in row_lists]
        total = int(sum(lens))
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64))
        tally["rescore_pairs_total"] += total
        if total == 0:
            return [empty] * nq
        rows = np.concatenate([np.asarray(r, dtype=np.int64) for r in row_lists])
        owner = np.repeat(np.arange(nq), lens)

        if term_lists is None:
            term_lists = [
                oracle.query_terms(q) if q.strip() else [] for q, _ in queries
            ]
        if q_matrix is None or q_norms is None:
            q_matrix = np.zeros((nq, dix.dim), dtype=np.float32)
            q_norms = np.zeros(nq, dtype=np.float64)
            for qi, (_, emb) in enumerate(queries):
                if emb is not None and len(emb) == dix.dim:
                    qv = np.asarray(emb, dtype=np.float32)
                    q_matrix[qi] = qv
                    q_norms[qi] = float(np.sum((qv * qv).astype(np.float64)))

        now_us = to_micros(now)
        age = np.maximum(
            0.0, ((now_us - dix.created_us[rows]).astype(np.float64) / 1e6) / 86400.0
        )
        rec = np.exp(-age / oracle.RECENCY_HALF_LIFE_DAYS)

        partial = None
        # compact bulk indexes (index/compact.py) hold int8+scale rows: the
        # native int8 variant dequantizes the candidates in its own scratch,
        # bit-identical to materialize_raw_rows + the numpy chain below
        compact = dix.host_compact
        if dix.dim <= 8192 and native.rescore_available():
            terms_blob, term_off, q_term_off = self._flat_terms(term_lists)
            with dix._lock:  # arena stability (appends reallocate)
                if compact:
                    partial = native.hybrid_rescore_int8(
                        dix.emb8_host, dix.scale_host, dix.raw_norm_sq,
                        dix._arena, dix.content_off, rows, owner, q_matrix,
                        q_norms, terms_blob, term_off, q_term_off,
                    )
                else:
                    partial = native.hybrid_rescore(
                        dix.raw_emb, dix.raw_norm_sq, dix._arena, dix.content_off,
                        rows, owner, q_matrix, q_norms, terms_blob, term_off,
                        q_term_off,
                    )
        if partial is not None:
            scores = partial + oracle.RECENCY_WEIGHT * rec
        else:
            kw_term = self._kw_scores_flat(rows, owner, term_lists, dix)
            raw = dix.materialize_raw_rows(rows) if compact else dix.raw_emb[rows]
            dot = np.sum(raw * q_matrix[owner], axis=1, dtype=np.float64)
            ns = dix.raw_norm_sq[rows]
            qn = q_norms[owner]
            ok = (ns > 0.0) & (qn > 0.0)
            cos = np.zeros(total, dtype=np.float64)
            cos[ok] = dot[ok] / (np.sqrt(qn[ok]) * np.sqrt(ns[ok]))
            # same f64 expression order as the oracle
            scores = (
                oracle.COSINE_WEIGHT * cos + kw_term
            ) + oracle.RECENCY_WEIGHT * rec
        order = np.lexsort((-dix.seqs[rows], -dix.created_ts[rows], -scores, owner))
        rows_s = rows[order]
        scores_s = scores[order]
        bounds = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(lens, out=bounds[1:])
        return [
            (rows_s[bounds[qi] : bounds[qi + 1]], scores_s[bounds[qi] : bounds[qi + 1]])
            if lens[qi] else empty
            for qi in range(nq)
        ]

    def _kw_scores_flat(
        self,
        rows: np.ndarray,
        owner: np.ndarray,
        term_lists: list[list[str]],
        dix,
    ) -> np.ndarray:
        """KEYWORD_WEIGHT * exact-substring keyword score per (query, row)
        pair — the host half of the device-exact-cosine path, bit-identical
        to the full host path's keyword term."""
        total = len(rows)
        nq = len(term_lists)
        if total == 0:
            return np.zeros(0, dtype=np.float64)
        if native.rescore_available():
            terms_blob, term_off, q_term_off = self._flat_terms(term_lists)
            dummy_q = np.zeros((nq, 1), dtype=np.float32)
            dummy_qn = np.zeros(nq, dtype=np.float64)
            with dix._lock:  # arena stability (bytearray growth reallocates)
                out = native.hybrid_rescore(
                    None, None, dix._arena, dix.content_off,
                    rows, owner, dummy_q, dummy_qn, terms_blob, term_off,
                    q_term_off,
                )
            if out is not None:
                return out
        kw = np.zeros(total, dtype=np.float64)
        if any(term_lists):
            meta = dix.meta
            contents = [
                m.content_lower_utf8() if (m := meta[r]) is not None else b""
                for r in rows
            ]
            flat_terms = []
            offsets = [0]
            for terms in term_lists:
                flat_terms.extend(t.encode("utf-8") for t in terms)
                offsets.append(len(flat_terms))
            kws = native.keyword_scores_multi(
                contents, owner.tolist(), flat_terms, offsets
            )
            if kws is not None:
                kw = np.asarray(kws, dtype=np.float64)
            else:
                for i, r in enumerate(rows):
                    terms = term_lists[owner[i]]
                    m = meta[r]
                    if m is not None and terms and m.content.strip():
                        kw[i] = oracle.keyword_score_terms(
                            terms, oracle.lower_invariant(m.content)
                        )
        return oracle.KEYWORD_WEIGHT * kw

    def _exact_rescore_rows_pruned(
        self,
        queries, row_lists, now, dix, ub_lists, ks, p1s,
        q_matrix=None, q_norms=None, term_lists=None, *, tally,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Two-phase body of _exact_rescore_rows: phase 1 rescores the
        top-p1 candidates by upper bound; phase 2 only tail candidates whose
        ub reaches the provisional kth exact score (ties kept)."""
        phase1 = [rows[:p1] for rows, p1 in zip(row_lists, p1s)]
        ranked1 = self._exact_rescore_rows(
            queries, phase1, now, dix=dix, q_matrix=q_matrix, q_norms=q_norms,
            term_lists=term_lists, tally=tally,
        )
        phase2 = []
        for qi, rows in enumerate(row_lists):
            p1, k = p1s[qi], ks[qi]
            _, s1 = ranked1[qi]
            kth1 = float(s1[k - 1]) if len(s1) >= k else -np.inf
            tail_rows = np.asarray(rows[p1:], dtype=np.int64)
            tail_ubs = np.asarray(ub_lists[qi][p1:], dtype=np.float64)
            phase2.append(tail_rows[tail_ubs >= kth1])
        saved = sum(len(r) - p for r, p in zip(row_lists, p1s)) - sum(
            len(p) for p in phase2
        )
        tally["rescore_pairs_saved_total"] += int(saved)
        ranked2 = self._exact_rescore_rows(
            queries, phase2, now, dix=dix, q_matrix=q_matrix, q_norms=q_norms,
            term_lists=term_lists, tally=tally,
        )
        out: list[tuple[np.ndarray, np.ndarray]] = []
        for qi in range(len(queries)):
            r1, s1 = ranked1[qi]
            r2, s2 = ranked2[qi]
            if len(r2) == 0:
                out.append((r1, s1))
                continue
            r = np.concatenate([r1, r2])
            s = np.concatenate([s1, s2])
            order = np.lexsort((-dix.seqs[r], -dix.created_ts[r], -s))
            out.append((r[order], s[order]))
        return out

    def _search_oracle(
        self,
        query: str,
        query_embedding: list[float] | None,
        k: int,
        window: int,
        now: datetime,
    ) -> list[SearchHit]:
        max_count = window if window > 0 else 2**31 - 1
        candidates = self.store.get_recent_chunks(max_count)
        hits = self._exact_hits(candidates, query, query_embedding, now)
        hits.sort(key=_sort_key)
        return hits[:k]

    def _search_full_host(
        self,
        query: str,
        query_embedding: list[float] | None,
        k: int,
        window: int,
        now: datetime,
        tally: dict | None = None,
    ) -> list[SearchHit]:
        """Exact host scan over the device index's own row list (the
        certificate-exhausted fallback, and the f64 oracle of the chip
        check): rows are in (created, seq) order, so the window is the row
        tail. ``tally`` as ``_exact_rescore_rows``'."""
        dix = self.device_index
        if dix is None:
            return self._search_oracle(query, query_embedding, k, window, now)
        r0 = dix.window_start_row(window)
        meta = dix.meta
        if query_embedding is not None and 0 < len(query_embedding) != dix.dim:
            chunks = [c for c in meta[r0:] if c is not None]
            hits = self._exact_hits(chunks, query, query_embedding, now)
            hits.sort(key=_sort_key)
            return hits[:k]
        rows = r0 + np.nonzero(dix.valid[r0 : dix.n_rows])[0].astype(np.int64)
        (rows_sorted, scores_sorted), = self._exact_rescore_rows(
            [(query, query_embedding)], [rows], now, dix=dix, tally=tally,
        )
        return [
            SearchHit(meta[int(r)], float(s))
            for r, s in zip(rows_sorted[:k], scores_sorted[:k])
            if meta[int(r)] is not None
        ]

    # -- device batch: dispatch --

    def _dispatch_device_batch(
        self,
        requests: list[tuple[str, list[float] | None, int]],
        window: int,
        now: datetime,
    ) -> dict:
        """Phase 1 of a device-batch search: snapshot the index, build the
        query operands, queue the prepass scans on the device and start the
        host copies of their compact results. No host sync happens here.
        The ``engine.dispatch`` span, whose batch number the context
        carries to the finalize."""
        with tracing.span(tracing.DISPATCH) as sp:
            ctx = self._dispatch_body(sp, requests, window, now)
            ctx["batch"] = sp.batch
            if sp and not ctx["empty"]:
                de = ctx["dev_embedded"]
                sp.set(len(requests), len(ctx["host_only"]),
                       int(de.sum()) if de is not None else 0)
            return ctx

    def _dispatch_body(self, sp, requests, window: int, now: datetime) -> dict:
        """``_dispatch_device_batch``'s work, its parts as steps of ``sp``."""
        dix = self.device_index
        assert dix is not None
        b = len(requests)
        ctx: dict = {"requests": requests, "window": window, "now": now, "dix": dix}
        if b == 0 or dix.n_rows == 0 or dix.n_valid == 0:
            ctx["empty"] = True
            return ctx
        ctx["empty"] = False
        device = dix.device

        sp.step(tracing.PREP)
        ks = [max(1, k) for _, _, k in requests]
        q_raw = np.zeros((b, dix.dim), dtype=np.float32)
        host_only: list[int] = []
        has_vec = np.zeros(b, dtype=bool)
        dev_embed_idx: list[int] = []
        for i, (query, query_embedding, _) in enumerate(requests):
            if query_embedding is not None and len(query_embedding) == dix.dim:
                q_raw[i] = query_embedding
                has_vec[i] = True
            elif query_embedding is not None and len(query_embedding) > 0:
                # an embedding the index cannot represent (dim mismatch): the
                # device cosine bound would not be sound — exact host scan
                host_only.append(i)
            elif query_embedding is None and self._device_embedder is not None \
                    and query.strip():
                # embedded on the card below. Only for None (the caller left
                # the embedding to the engine): an explicit empty vector keeps
                # the reference's embed-failure semantics, keyword-only
                # scoring (RecallSearchService.cs:70-71)
                dev_embed_idx.append(i)
        q_norms = np.sum(q_raw * q_raw, axis=1, dtype=np.float64)
        ok = has_vec & (q_norms > 0.0)
        # zero-norm vectors of matching dim also go host-only
        host_only.extend(int(i) for i in np.nonzero(has_vec & ~ok)[0])

        # one forward for the batch's embedding-less queries; the rows stay
        # on the card. A forward that fails on its input degrades those
        # queries to keyword-only scoring (the reference's embed-failure
        # semantics); a failure of the card raises
        dev_embedded = np.zeros(b, dtype=bool)
        q_enc = None
        if dev_embed_idx:
            try:
                q_enc = self._device_embedder.embed_device(
                    [requests[i][0] for i in dev_embed_idx])
            except Exception as exc:
                if is_device_error(exc):
                    raise
                logging.getLogger(__name__).warning(
                    "device query forward failed; %d queries score keyword and "
                    "recency only", len(dev_embed_idx), exc_info=True)
                q_enc = None
            if q_enc is not None:
                dev_embedded[dev_embed_idx] = True

        terms_all = [oracle.query_terms(query) for query, _, _ in requests]
        # sparse keyword weights ((bit, value) pairs, a few dozen per query)
        # scattered dense on device, bit-identical to the dense builder;
        # pathologically dense queries take the dense builder
        sparse_kw = hashing.query_bit_weights_sparse_batch(
            terms_all, dix.bloom_bits, dix.ngram, dix.bloom_hashes,
        )
        if sparse_kw is None:
            weights, bias64 = hashing.query_bit_weights_batch(
                terms_all, dix.bloom_bits, dix.ngram, dix.bloom_hashes,
            )
        else:
            kw_idx, kw_val, bias64 = sparse_kw
        biases = bias64.astype(np.float32)

        r0 = dix.window_start_row(window)
        window_rows = dix.n_valid if window <= 0 else min(window, dix.n_valid)

        sp.step(tracing.UPLOAD)
        upd_seq0 = dix.update_seq  # read BEFORE the snapshot (reindex race)
        dev = dix.device_arrays()
        qn_dd_dev = None
        if q_enc is not None:
            # device-embedded batch: assemble the raw query matrix on the
            # card (encoder rows never leave it; explicit host vectors
            # upload as a compact slab), take the double-float self-norms
            # (8 B a query read back instead of the [B, d] matrix) and
            # normalize on the card (_normalize_q_dd, search/engine.py:87-97)
            if len(dev_embed_idx) == b:
                q_raw_dev = q_enc.to(torch.float32).contiguous()
            else:
                q_raw_dev = torch.zeros((b, dix.dim), dtype=torch.float32, device=device)
                q_raw_dev[torch.as_tensor(dev_embed_idx, device=device)] = q_enc.to(
                    torch.float32)
                host_idx = np.nonzero(ok)[0]
                if len(host_idx):
                    q_raw_dev[torch.from_numpy(host_idx).to(device)] = _upload(
                        np.ascontiguousarray(q_raw[host_idx]), device)
            qhi, qlo = exact_cos.self_norm_dd(q_raw_dev)
            qn_dd_dev = _HostCopy((qhi, qlo))
            # inv = 1/sqrt(qhi) in f32 is within ~2 ulps + DD_SUM_REL/2 of the
            # host path's f32(1/sqrt(qn_f64)): inside the same documented
            # slack of the scan and refine bounds; zero rows normalize to 0
            inv_dev = torch.where(qhi > 0.0, 1.0 / torch.sqrt(qhi), torch.zeros_like(qhi))
            q_dev = q_raw_dev * inv_dev[:, None]
        elif self._sharded_scorer is not None:
            # the sharded path normalizes on the host, as the reference's
            # sharded upload does (search/engine.py:1505-1518): f32 products
            # accumulated in f64, an f64 divide, rounded to f32
            q_host = np.zeros((b, dix.dim), dtype=np.float32)
            if ok.any():
                q_host[ok] = (q_raw[ok].astype(np.float64)
                              / np.sqrt(q_norms[ok])[:, None]).astype(np.float32)
            q_raw_dev = _upload(q_raw, device)
            q_dev = _upload(q_host, device)
        else:
            # ONE raw [B, d] f32 upload + f32 inverse norms, normalized on
            # device: q_raw * f32(1/sqrt(qn)) is within ~2 ulps of the host's
            # f64 normalization, inside the scan bounds' documented slack
            inv = np.zeros(b, dtype=np.float32)
            if ok.any():
                inv[ok] = (1.0 / np.sqrt(q_norms[ok])).astype(np.float32)
            q_raw_dev = _upload(q_raw, device)
            q_dev = q_raw_dev * _upload(inv, device)[:, None]
        if sparse_kw is None:
            w_dev = _upload(weights.astype(np.float32, copy=False), device)
        else:
            w_dev = _densify_kw(_upload(kw_idx, device), _upload(kw_val, device),
                                dix.bloom_bits)
        bias_dev = _upload(biases, device)
        # a host scalar (f32-rounded, as the JAX graph's jnp.float32(now)):
        # a device scalar would cost a synchronizing copy
        now_dev = float(np.float32(to_days(now)))
        m = min(max(self.options.candidate_m, max(ks)), window_rows)

        ctx.update(
            ks=ks, q_raw=q_raw, q_norms=q_norms, terms=terms_all,
            host_only=host_only, r0=r0, window_rows=window_rows,
            upd_seq0=upd_seq0, dev=dev, q_dev=q_dev, q_raw_dev=q_raw_dev,
            w_dev=w_dev, bias_dev=bias_dev, now_dev=now_dev, m=m,
            kw_scan=None, coarse_scan=None,
            dev_embedded=dev_embedded if q_enc is not None else None,
            qn_dd_dev=qn_dd_dev,
            # rows already on the host: explicit vectors carry exact values,
            # device rows materialize on demand (ensure_host_q)
            q_ready=~dev_embedded if q_enc is not None else None,
        )
        if not self.options.exact:
            return ctx
        sp.step(tracing.LAUNCH)
        host_set = set(host_only)
        # embedding-backed queries: a nonzero host vector, or device-embedded
        q_live = ok | dev_embedded

        def chain_dd(sel, zero: bool = False):
            """Chain the device-exact cosine (K2) onto a compact selection:
            DD-dot the selected rows against the RAW query matrix, in the
            same stream. ``zero``: the keyword-only selection, whose query
            rows are exactly zero, so the triple is provably all-zero —
            finalize synthesizes it. None when the raw plane is absent."""
            if dev.raw is None or not self.options.device_exact_cos:
                return None
            if zero:
                return ("zero",)
            return _HostCopy(exact_cos.exact_cos_rows(dev.raw, sel[0], q_raw_dev))

        # keyword-only prepass: queries WITHOUT an embedding have cosine
        # exactly 0 (RecallSearchService.cs:70-71) — the bloom + recency
        # scan (K5) gives the same sound bounds with no emb stream
        kw_only = [i for i in range(b) if i not in host_set and not q_live[i]]
        if kw_only:
            kw_scorer = self._select_kw_scorer(m, int(dev.emb.shape[0]))
            if kw_scorer is not None:
                k_vals, k_idxs = kw_scorer(dev, w_dev, bias_dev, now_dev, r0, m)
                sel, _ = self._refine_select_call(
                    dev, q_dev, w_dev, bias_dev, now_dev, k_vals, k_idxs, m, max(ks),
                )
                # which selection the direct gate chose: the keyword batch's
                # compact outcomes feed the direct gate too
                ctx["kw_select_direct"] = self._last_select_direct
                if sel is not None:
                    ctx["kw_dd"] = chain_dd(sel, zero=True)
                    ctx["kw_scan"] = ("compact", kw_only, _HostCopy(sel))
                    # full [B, m+1] candidates stay device-resident for the
                    # wide rescue
                    ctx["kw_full"] = (k_vals, k_idxs)
                else:
                    # no compact selection only where refine is impossible
                    # too (no residual planes, or m above the refine
                    # ceiling): the full-width certificate has scan bounds
                    # alone
                    ctx["kw_scan"] = ("full", kw_only, _HostCopy((k_vals, k_idxs)))

        # coarse prepass (K1): cosine-only scan with a sound per-query
        # keyword cap; failures continue into the wide rescue / fused loop
        prepass = [i for i in range(b) if i not in host_set and q_live[i]]
        if prepass and not self._coarse_gate_open():
            self._coarse_gate_advance(len(prepass))
            prepass = []
        if prepass:
            coarse = self._select_coarse_scorer(m, int(dev.emb.shape[0]))
            if coarse is not None:
                c_vals, c_idxs = coarse(dev, q_dev, w_dev, bias_dev, now_dev, r0, m)
                sel, dd_inline = self._refine_select_call(
                    dev, q_dev, w_dev, bias_dev, now_dev, c_vals, c_idxs, m, max(ks),
                    q_raw_dev=q_raw_dev,
                )
                # which selection the direct gate chose for THIS batch (the
                # finalize attributes the compact outcomes to the gate)
                ctx["select_direct"] = self._last_select_direct
                if sel is not None:
                    # sharded: the DD rode the selection's dispatch
                    ctx["coarse_dd"] = (_HostCopy(dd_inline) if dd_inline is not None
                                        else chain_dd(sel))
                    ctx["coarse_scan"] = ("compact", prepass, _HostCopy(sel))
                    ctx["coarse_full"] = (c_vals, c_idxs)  # wide rescue
                else:
                    ctx["coarse_scan"] = ("full", prepass, _HostCopy((c_vals, c_idxs)))
        return ctx

    # -- device batch: finalize --

    def _finalize_device_batch(self, ctx: dict) -> list[list[SearchHit]]:
        """Phase 2: wait for the batch's device results, certify them on the
        host, and rescue what the certificate leaves open. The
        ``engine.finalize`` span; the batch's counts go to ``stats`` once,
        at its end, and onto the span."""
        tally = dict.fromkeys(self.stats, 0)
        with tracing.span(tracing.FINALIZE, ctx.get("batch")) as sp:
            try:
                return self._finalize_body(ctx, tally)
            finally:
                tally["searches_total"] = len(ctx["requests"])
                self._add_stats(tally)
                sp.set(tally["escalation_rounds_total"], tally["host_fallbacks_total"],
                       tally["dd_escalations_total"], tally["rescue_wide_total"],
                       tally["rescue_sliced_total"], tally["rescore_pairs_total"])

    def _finalize_body(self, ctx: dict, tally: dict) -> list[list[SearchHit]]:
        """``_finalize_device_batch``'s work; its counts go to ``tally``."""
        requests = ctx["requests"]
        if ctx["empty"]:
            return [[] for _ in requests]
        window, now, dix = ctx["window"], ctx["now"], ctx["dix"]
        ks, host_only = ctx["ks"], ctx["host_only"]
        window_rows, upd_seq0 = ctx["window_rows"], ctx["upd_seq0"]
        dev = ctx["dev"]
        q_dev, w_dev, bias_dev = ctx["q_dev"], ctx["w_dev"], ctx["bias_dev"]
        now_dev, r0, m = ctx["now_dev"], ctx["r0"], ctx["m"]
        b = len(requests)
        device = dix.device

        results: list[list[SearchHit] | None] = [None] * b

        # device-resident query pipeline: the raw query rows live on the
        # card; only their double-float self-norms come back eagerly. Exact
        # rows and oracle norms materialize lazily (ensure_host_q), so only
        # escalations pay that readback (search/engine.py:1812-1884)
        dev_embedded, q_ready = ctx["dev_embedded"], ctx["q_ready"]
        qn_rel: np.ndarray | None = None
        suspect_q: list[int] = []
        if dev_embedded is not None:
            qhi, qlo = ctx["qn_dd_dev"].get()
            qn_dd = qhi.astype(np.float64) + qlo.astype(np.float64)
            ctx["q_norms"][dev_embedded] = qn_dd[dev_embedded]
            # the DD certificate's margin: the device norm deviates from the
            # oracle's numpy norm by <= QN_DD_REL relative
            qn_rel = np.where(dev_embedded, exact_cos.QN_DD_REL, 0.0)
            # QN_DD_REL and the scans' device normalization are relative
            # bounds, which f32 underflow in the self-dot could break for
            # pathologically tiny rows (the encoder emits unit rows): such
            # queries take the exact host scan
            suspect_q = [int(i) for i in np.nonzero(dev_embedded & (qn_dd < 1e-26))[0]]

        def ensure_host_q(indices) -> None:
            """Materialize the exact f32 query rows and oracle f64 norms of
            device-embedded queries: a lossless copy of the forward's bits;
            np.sum matches the dispatch's host expression bit for bit."""
            if dev_embedded is None:
                return
            need = [i for i in indices if dev_embedded[i] and not q_ready[i]]
            if not need:
                return
            idx = torch.as_tensor(need, dtype=torch.long, device=device)
            with tracing.span(tracing.WAIT):
                rows = ctx["q_raw_dev"].index_select(0, idx).cpu().numpy()
            ctx["q_raw"][need] = rows
            ctx["q_norms"][need] = np.sum(rows * rows, axis=1, dtype=np.float64)
            q_ready[need] = True

        def emb_for(i):
            """The request's embedding for the host oracle: explicit vectors
            pass through; device-embedded queries hand back their
            materialized bits."""
            if dev_embedded is not None and dev_embedded[i]:
                ensure_host_q([i])
                return ctx["q_raw"][i].tolist()
            return requests[i][1]

        def oracle_fill(indices):
            with tracing.span(tracing.HOST_SCAN):
                tally["host_fallbacks_total"] += len(indices)
                ensure_host_q(indices)
                for i in indices:
                    results[i] = self._search_full_host(requests[i][0], emb_for(i), ks[i],
                                                        window, now, tally=tally)

        if host_only:
            oracle_fill(host_only)
        if suspect_q:
            oracle_fill(suspect_q)

        meta = dix.meta

        def certify(pending, ranked, boundary_of) -> list[int]:
            """Fill results where the certificate passes (or the scan itself
            proved total coverage: boundary == -inf IN THE SNAPSHOT); return
            the still-unresolved indices."""
            if dix.update_seq != upd_seq0:
                # embeddings updated in place after the device snapshot:
                # no consistent state certifies the combination — serialize
                # after the update via the exact host scan
                oracle_fill(pending)
                return []
            unresolved = []
            with tracing.span(tracing.CERTIFY):
                for pi, i in enumerate(pending):
                    k = ks[i]
                    boundary = boundary_of(i)
                    rows_sorted, scores_sorted = ranked[pi]
                    if boundary != -np.inf:
                        kth = scores_sorted[k - 1] if len(scores_sorted) >= k else -np.inf
                        if not kth > boundary:
                            unresolved.append(i)
                            continue
                    results[i] = [
                        SearchHit(meta[int(r)], float(s))
                        for r, s in zip(rows_sorted[:k], scores_sorted[:k])
                        if meta[int(r)] is not None
                    ]
            return unresolved

        def rescore(pending, row_lists, ub_lists, phase1):
            ensure_host_q(pending)  # exact query bits for the f64 rescore
            prune = self.options.rescore_prune
            with tracing.span(tracing.RESCORE):
                return self._exact_rescore_rows(
                    [(requests[i][0], requests[i][1]) for i in pending],
                    row_lists, now, dix=dix,
                    ub_lists=ub_lists if prune else None,
                    ks=[ks[i] for i in pending] if prune else None,
                    phase1=phase1,
                    q_matrix=ctx["q_raw"][pending],
                    q_norms=ctx["q_norms"][pending],
                    term_lists=[ctx["terms"][i] for i in pending],
                    tally=tally,
                )

        def rescore_and_certify(pending, all_vals, all_idxs, m, all_ref=None):
            """Exact-rescore pending queries' [B, m+1] scan candidates and
            certify against the scan boundary (entry m). ``all_ref``
            (optional [B, m]): the refined bounds of the same candidates;
            candidates are then re-sorted by min(scan bound, refined bound)
            and the two-phase prune runs at the narrow refined phase-1
            width."""
            row_lists, ub_lists = [], []
            for i in pending:
                vals, idxs = all_vals[i], all_idxs[i]
                live = vals[:m] > -np.inf
                rows = idxs[:m][live]
                ubs = vals[:m][live]  # descending: the prune relies on it
                if all_ref is not None:
                    # min of two sound upper bounds is a sound upper bound
                    ubs = np.minimum(ubs, all_ref[i][live])
                keep = rows >= 0
                rows, ubs = rows[keep], ubs[keep]
                if len(rows):
                    # rows tombstoned since the scan (concurrent delete)
                    keep = dix.valid[rows]
                    if not keep.all():
                        rows, ubs = rows[keep], ubs[keep]
                if all_ref is not None and len(rows):
                    # restore the descending-bound order under the tightened
                    # bounds (stable: scan order on ties)
                    order = np.argsort(-ubs, kind="stable")
                    rows, ubs = rows[order], ubs[order]
                row_lists.append(rows.astype(np.int64))
                ub_lists.append(ubs)
            ranked = rescore(pending, row_lists, ub_lists,
                             None if all_ref is None else self.options.rescore_phase1_refined)
            return certify(
                pending, ranked,
                lambda i: all_vals[i][m] if all_vals[i].shape[0] > m else -np.inf,
            )

        def rescore_and_certify_compact(pending, rows_a, ubs_a, bounds_a):
            """Certify from the compact selection: ``bounds_a[i]`` is the one
            sound bound over every row not in the slice."""
            row_lists, ub_lists = [], []
            for i in pending:
                rows, ubs = rows_a[i], ubs_a[i]
                live = (ubs > -np.inf) & (rows >= 0)
                rows, ubs = rows[live], ubs[live]
                if len(rows):
                    keep = dix.valid[rows]  # concurrent-delete tombstones
                    if not keep.all():
                        rows, ubs = rows[keep], ubs[keep]
                row_lists.append(rows.astype(np.int64))
                ub_lists.append(ubs)
            ranked = rescore(pending, row_lists, ub_lists,
                             self.options.rescore_phase1_refined)
            return certify(pending, ranked, lambda i: bounds_a[i])

        def rescore_and_certify_compact_dd(
            pending, rows_a, ubs_a, bounds_a, hi_a, lo_a, sabs_a
        ):
            """Certify from the compact selection with the DEVICE-exact
            cosines (K2): the host scores keyword + recency only, fuses in
            f64 and certifies that the numpy oracle could not rank or round
            differently; failing queries escalate to the bit-exact host
            rescore of the same slice."""
            pend = np.asarray(pending)
            rows_p = rows_a[pend]
            live = (ubs_a[pend] > -np.inf) & (rows_p >= 0)
            safe = np.where(live, rows_p, 0)
            live &= dix.valid[safe]  # concurrent-delete tombstones
            lens = live.sum(axis=1).astype(np.int64)
            total = int(lens.sum())
            if total == 0:
                return rescore_and_certify_compact(pending, rows_a, ubs_a, bounds_a)
            rows_flat = rows_p[live].astype(np.int64)
            owner = np.repeat(np.arange(len(pending)), lens)
            own_q = pend[owner]
            with tracing.span(tracing.RESCORE):
                cos, m_cos = exact_cos.finish_cosines(
                    hi_a[pend][live], lo_a[pend][live], sabs_a[pend][live],
                    ctx["q_norms"][own_q], dix.raw_norm_sq[rows_flat],
                    qn_rel=qn_rel[own_q] if qn_rel is not None else None,
                )
                kw_term = self._kw_scores_flat(
                    rows_flat, owner, [ctx["terms"][i] for i in pending], dix
                )
                age = np.maximum(
                    0.0,
                    ((to_micros(now) - dix.created_us[rows_flat]).astype(np.float64) / 1e6)
                    / 86400.0,
                )
                rec = np.exp(-age / oracle.RECENCY_HALF_LIFE_DAYS)
                # exactly the oracle expression order
                scores = (oracle.COSINE_WEIGHT * cos + kw_term) + oracle.RECENCY_WEIGHT * rec
                margins = np.where(
                    m_cos > 0.0,
                    oracle.COSINE_WEIGHT * m_cos + 4e-16 * (np.abs(scores) + 1.0),
                    0.0,
                )
            if dix.update_seq != upd_seq0:
                oracle_fill(pending)  # reindex race: same as the host path
                return []
            with tracing.span(tracing.CERTIFY):
                order = np.lexsort(
                    (-dix.seqs[rows_flat], -dix.created_ts[rows_flat], -scores, owner)
                )
                rows_s, scores_s, margins_s = rows_flat[order], scores[order], margins[order]
                seg = np.zeros(len(pending) + 1, dtype=np.int64)
                np.cumsum(lens, out=seg[1:])
                k_arr = np.asarray([ks[i] for i in pending], dtype=np.int64)
                bnd = np.asarray([bounds_a[i] for i in pending], dtype=np.float64)
                resolved, provable, kk_arr = _dd_certify_batch(
                    scores_s, margins_s, seg, lens, k_arr, bnd,
                )
                unresolved = [pending[pi] for pi in np.nonzero(provable)[0]]
                esc_mask = ~provable & ~resolved
                escalate = [pending[pi] for pi in np.nonzero(esc_mask)[0]]
                # both sets need exact host query bits next: one gather
                ensure_host_q(escalate + unresolved)
                tally["rescore_pairs_total"] += total - int(lens[esc_mask].sum())
                tally["dd_resolved_total"] += int(resolved.sum())
                for pi in np.nonzero(resolved)[0]:
                    i = pending[pi]
                    kk = int(kk_arr[pi])
                    lo = seg[pi]
                    results[i] = [
                        SearchHit(meta[int(row)], float(sc))
                        for row, sc in zip(rows_s[lo: lo + kk], scores_s[lo: lo + kk])
                        if meta[int(row)] is not None
                    ]
            if escalate:
                tally["dd_escalations_total"] += len(escalate)
                unresolved.extend(
                    rescore_and_certify_compact(escalate, rows_a, ubs_a, bounds_a)
                )
            return unresolved

        def consume_prepass(scan, dd=None):
            tag, pending, copy = scan
            # skip queries already resolved ahead of the prepass
            pending = [i for i in pending if results[i] is None]
            if not pending:
                return pending, []
            if tag == "compact":
                rows_h, ubs_h, bound_h = copy.get()
                if dd is not None:
                    if isinstance(dd, tuple):  # chain_dd's ("zero",) marker
                        hi_h = lo_h = sabs_h = np.zeros(rows_h.shape, dtype=np.float32)
                    else:
                        hi_h, lo_h, sabs_h = dd.get()
                    return pending, rescore_and_certify_compact_dd(
                        pending, rows_h, ubs_h, bound_h, hi_h, lo_h, sabs_h
                    )
                return pending, rescore_and_certify_compact(
                    pending, rows_h, ubs_h, bound_h
                )
            vals_h, idxs_h = copy.get()
            return pending, rescore_and_certify(pending, vals_h, idxs_h, m)

        if ctx["kw_scan"] is not None:
            kw_only, unresolved = consume_prepass(ctx["kw_scan"], ctx.get("kw_dd"))
            tally["kw_only_resolved_total"] += len(kw_only) - len(unresolved)
            # keyword-batch compact outcomes feed the direct gate (never the
            # coarse gate: these queries did not run the coarse scan)
            if ctx.get("kw_select_direct"):
                self._direct_gate_record(len(kw_only) - len(unresolved), len(kw_only))
            elif ctx.get("kw_select_direct") is False:
                self._direct_gate_advance(len(kw_only))

        if ctx["coarse_scan"] is not None:
            prepass, unresolved = consume_prepass(
                ctx["coarse_scan"], ctx.get("coarse_dd")
            )
            coarse_resolved = len(prepass) - len(unresolved)
            tally["coarse_resolved_total"] += coarse_resolved
            if ctx.get("select_direct"):
                # direct-selection misses must not poison the coarse gate
                # (the looser (t_out+1)-th bound missed, not the scan): they
                # feed the direct gate instead
                self._coarse_gate_advance(len(prepass))
                self._direct_gate_record(coarse_resolved, len(prepass))
            else:
                self._coarse_gate_record(coarse_resolved, len(prepass))
                if ctx.get("select_direct") is False:
                    # refine selection while the direct gate is closed:
                    # advance its clock toward the re-probe horizon
                    self._direct_gate_advance(len(prepass))

        def wide_rescue(full_key: str, scan_key: str) -> None:
            """Compact-prepass misses re-certified at the FULL scan width
            without a fresh scan: the [B, m+1] candidates are still on the
            device, so read back just the pending queries' rows."""
            scan = ctx.get(scan_key)
            if ctx.get(full_key) is None or scan is None:
                return
            members = set(scan[1])
            pending = [i for i, r in enumerate(results) if r is None and i in members]
            # near-full-width pending: the prepass certificate is failing
            # broadly — let the rescue scan's tighter fused bounds run
            if not pending or len(pending) > max(8, b // 2):
                return
            tally["rescue_wide_total"] += 1
            vals_d, idxs_d = ctx[full_key]
            sel_dev = torch.as_tensor(pending, dtype=torch.long, device=device)
            with tracing.span(tracing.WAIT):
                vals_p = vals_d.index_select(0, sel_dev).cpu().numpy()
                idxs_p = idxs_d.index_select(0, sel_dev).cpu().numpy()
            vf, xf = _rehome_rows(b, pending, ((vals_p, -np.inf), (idxs_p, -1)))
            rescore_and_certify(pending, vf, xf, m)

        if all(r is not None for r in results):
            return results  # type: ignore[return-value]
        # the wide rescue and the rescan loop, for what the prepass left
        # open (on an index with no prepass, the loop's first scan)
        with tracing.span(tracing.RESCUE):
            if self.options.exact:
                wide_rescue("kw_full", "kw_scan")
                wide_rescue("coarse_full", "coarse_scan")

            while any(r is None for r in results):
                pending = [i for i, r in enumerate(results) if r is None]
                scan, full_coverage = self._select_scorer(m, int(dev.emb.shape[0]))
                if scan is None:
                    # no scan layout covers m: exact host scan
                    oracle_fill(pending)
                    break
                # slice the rescue scan to the PENDING queries (pow2 bucket,
                # duplicate-of-first pads): index bytes are streamed either way,
                # but readback and host rescore scale with the width
                sliced = self.options.exact and len(pending) <= b // 2
                if sliced:
                    tally["rescue_sliced_total"] += 1
                    pb = 1 << (len(pending) - 1).bit_length()
                    sel = np.zeros(pb, dtype=np.int64)
                    sel[: len(pending)] = pending
                    sel_dev = torch.from_numpy(sel).to(device)
                    q_s = q_dev.index_select(0, sel_dev)
                    w_s = w_dev.index_select(0, sel_dev)
                    bias_s = bias_dev.index_select(0, sel_dev)
                else:
                    q_s, w_s, bias_s = q_dev, w_dev, bias_dev
                all_vals, all_idxs = scan(dev, q_s, w_s, bias_s, now_dev, r0, m)
                # refine-assisted rescue: K3 re-bounds the scan's candidates
                all_ref = (
                    self._refine_call(dev, q_s, w_s, bias_s, now_dev, all_vals, all_idxs, m)
                    if self.options.exact else None
                )
                with tracing.span(tracing.WAIT):
                    all_vals = all_vals.cpu().numpy()
                    all_idxs = all_idxs.cpu().numpy()
                    if all_ref is not None:
                        all_ref = all_ref.cpu().numpy()
                if sliced:
                    all_vals, all_idxs = _rehome_rows(
                        b, pending, ((all_vals, -np.inf), (all_idxs, -1))
                    )
                    if all_ref is not None:
                        (all_ref,) = _rehome_rows(b, pending, ((all_ref, -np.inf),))

                if not self.options.exact:
                    # approximate profile: rank by the device upper bound
                    for i in pending:
                        vals, idxs = all_vals[i], all_idxs[i]
                        live = vals[:m] > -np.inf
                        hits = []
                        for row, ub in zip(idxs[:m][live], vals[:m][live]):
                            chunk = dix.meta[int(row)]
                            if chunk is not None:
                                hits.append(SearchHit(chunk, float(ub)))
                        results[i] = hits[: ks[i]]
                    break

                unresolved = rescore_and_certify(pending, all_vals, all_idxs, m, all_ref)
                if m >= window_rows and not full_coverage:
                    # partial-coverage scan exhausted: exact host scan
                    oracle_fill(unresolved)
                    unresolved = []

                if any(r is None for r in results):
                    if m >= window_rows or m >= self._ESCALATION_MAX_M:
                        oracle_fill([i for i, r in enumerate(results) if r is None])
                        break
                    m = min(m * 4, window_rows)
                    tally["escalation_rounds_total"] += 1

        return results  # type: ignore[return-value]
