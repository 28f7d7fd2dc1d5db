"""Row-sharded scoring: per-shard top-k and an all-gather merge (PyTorch
port of omni_recall_tpu/parallel/sharded.py).

The index rows split over a 1-D ``shards`` mesh (parallel/mesh.py). Each
shard runs the port's own single-device op over its local planes with its
global ``row_offset`` — the plain-torch upper-bound pass (``xla``), the
fused scans K4 and K6 (``pallas_int8``, ``pallas``), the coarse scan K1
(``pallas_int8_coarse``) or the keyword-only scan K5 (``pallas_kw_only``) —
and takes a LOCAL top-(m+1); the small [S, B, m+1] candidate tensors are
all-gathered and merged into the global top-m and boundary. Exact because
scoring is pointwise per row: the global top-k lies in the union of the
per-shard top-k's, and the merged boundary (the max of the (m+1)-th merged
candidate and every shard's own boundary) bounds every excluded row. Ties
inside a shard go to the lowest local row; the merge re-sorts on (value,
gather order), and the final ranking comes from the host's exact rescore,
which does not depend on the shard count.

The collectives are two functions over the mesh: ``all_gather`` and
``psum``. In one process they are copies to the first shard's device (a
copy from another card is ordered after that card's queued work by
PyTorch's cross-device copy, so no host sync is added); across processes
they are ``torch.distributed.all_gather_into_tensor`` and ``all_reduce``
over the mesh's group. Each shard's kernels run on its own device's current
stream.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

from omni_recall_tpu_torch.ops import exact_cos, refine, scorer, xla_scorer
from omni_recall_tpu_torch.ops.merge import top_k_with_payload
from omni_recall_tpu_torch.parallel.mesh import ShardMesh, replicated

# local-top-k padding (sharded.py _local_xla): the index of a padded entry
_PAD_INDEX = -1 - int(1e9)


def _on(device: torch.device):
    """The shard's device as the current device (a kernel launches on the
    current device's context); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def all_gather(mesh: ShardMesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """[S, ...]: every shard's tensor in global shard order, on the first
    local shard's device (``jax.lax.all_gather`` over ``shards``)."""
    dev0 = mesh.devices[0]
    local = torch.stack([p.to(dev0, non_blocking=True) for p in parts])
    if mesh.group is None:
        return local
    import torch.distributed as dist

    out = torch.empty((mesh.n_shards, *local.shape[1:]), dtype=local.dtype, device=dev0)
    dist.all_gather_into_tensor(out, local.contiguous(), group=mesh.group)
    return out


def psum(mesh: ShardMesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """The sum over every shard (``jax.lax.psum``), on the first local
    shard's device: the local shards in order, then across processes. The
    exact-zero combine uses it where at most one shard holds a value and
    the rest hold +0.0, so the sum is that value in any order (x + 0.0 == x
    for every x but -0.0, which becomes +0.0 once any zero is added)."""
    dev0 = mesh.devices[0]
    out = parts[0].to(dev0, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(dev0, non_blocking=True)
    if mesh.group is None:
        return out
    import torch.distributed as dist

    out = out.clone() if len(parts) == 1 else out
    dist.all_reduce(out, group=mesh.group)
    return out


def _globalize_and_merge(mesh: ShardMesh, outs_v, outs_i, offsets, m: int):
    """All-gather the shards' [B, m+1] (candidates, boundary at entry m)
    and merge them into the global [B, m+1] (sharded.py
    _globalize_and_merge)."""
    gi = [torch.where(i >= 0, i + off, i) for i, off in zip(outs_i, offsets)]
    all_v = all_gather(mesh, outs_v)  # [S, B, m+1]
    all_i = all_gather(mesh, gi)
    s, b, _ = all_v.shape
    cand_v = all_v[:, :, :m].permute(1, 0, 2).reshape(b, s * m)
    cand_i = all_i[:, :, :m].permute(1, 0, 2).reshape(b, s * m)
    shard_bounds = all_v[:, :, m].amax(dim=0)  # [B]
    k = min(m + 1, s * m)
    top_v, top_i = top_k_with_payload(cand_v, cand_i, k)
    if k > m:
        boundary_emitted = top_v[:, m]
    else:
        boundary_emitted = torch.full((b,), float("-inf"), dtype=top_v.dtype,
                                      device=top_v.device)
    boundary = torch.maximum(boundary_emitted, shard_bounds)
    out_v = torch.cat([top_v[:, :m], boundary[:, None]], dim=1)
    out_i = torch.cat(
        [top_i[:, :m], torch.full((b, 1), -1, dtype=torch.int32, device=top_i.device)], dim=1)
    return out_v, out_i


class ShardedScorer:
    """Scores and refines over a row-sharded index (sharded.py
    ShardedScorer). ``calls`` counts the calls per (mode, m, t, sub) key, as
    the JAX scorer's cache of compiled functions records the modes it ran."""

    def __init__(self, mesh: ShardMesh) -> None:
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.calls: Counter = Counter()

    def _shards(self):
        """(local index, device, global shard index) of each local shard."""
        return [(l, d, self.mesh.shard_index(l)) for l, d in enumerate(self.mesh.devices)]

    # -- local shard bodies --

    def _local_xla(self, emb, bloom, created, valid, q, kw_w, kw_b, now_days,
                   window_start, m: int, row_offset: int):
        n_local = emb.shape[0]
        k_local = m + 1
        k = min(k_local, n_local)
        vals, idxs = xla_scorer.score_topm(
            emb, bloom, created, valid, q, kw_w, kw_b, now_days, window_start,
            m=k - 1, row_offset=row_offset,
        )
        if k < k_local:
            pad = k_local - k
            vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
            idxs = torch.nn.functional.pad(idxs, (0, pad), value=_PAD_INDEX)
        elif k == k_local:
            # entry m doubles as the shard boundary: the (m+1)-th local value
            # bounds every unemitted local row; -2 marks it bound-only (the
            # non-candidate sentinel, also applied to padded entries)
            idxs = idxs.clone()
            idxs[:, k_local - 1] = -2
        return vals, torch.where(idxs >= 0, idxs, torch.full_like(idxs, -2))

    def _local_kw_only(self, bloom, created, valid, kw_w, kw_b, now_days, window_start,
                       m: int, t: int, sub: int, row_offset: int):
        """Bloom + recency only, for embedding-less queries (cosine exactly
        0): no emb operand."""
        add_row = scorer.make_add_row(created, valid, now_days, window_start,
                                      row_offset=row_offset)
        kw_w8 = scorer.quantize_kw_weights(kw_w)
        vals, idxs = scorer.block_topt_kw_only(bloom, kw_w8, kw_b[:, None], add_row,
                                               t=t, sub=sub)
        return scorer._merge_topm(vals, idxs, m)

    def _local_pallas(self, emb, scale, err, bloom, created, valid, q, kw_w, kw_b,
                      now_days, window_start, m: int, t: int, sub: int, int8: bool,
                      coarse: bool, row_offset: int):
        if int8:
            # the soundness-critical bound construction shared with the
            # single-device scans (scorer.prepare_int8_query)
            q8, q_scale, eq, err_term = scorer.prepare_int8_query(q, err)
            add_row = scorer.make_add_row(created, valid, now_days, window_start,
                                          row_offset=row_offset, err_term=err_term)
            if coarse:
                q_bias = scorer.coarse_q_bias(eq, kw_w, kw_b)
                vals, idxs = scorer.block_topt_int8_coarse(
                    emb, q8, add_row, scale[None, :], q_scale, q_bias, t=t, sub=sub)
            else:
                kw_w8 = scorer.quantize_kw_weights(kw_w)
                vals, idxs = scorer.block_topt_int8(
                    emb, bloom, q8, kw_w8, kw_b[:, None], add_row, scale[None, :], q_scale,
                    scorer.COSINE_WEIGHT * eq, t=t, sub=sub)
        else:
            add_row = scorer.make_add_row(created, valid, now_days, window_start,
                                          row_offset=row_offset)
            vals, idxs = scorer.block_topt(emb, bloom, q, kw_w, kw_b[:, None], add_row,
                                           t=t, sub=sub)
        return scorer._merge_topm(vals, idxs, m)

    # -- public --

    def local_rows(self, n_rows_padded: int) -> int:
        return n_rows_padded // self.n_shards

    def pallas_budget(self, n_rows_padded: int, sub: int = 512) -> int:
        """Max m a shard's fused scan supports (its slice count at sub); 0
        when the local row count does not block-align. The block is picked
        as for int8 rows whatever the storage (sharded.py pallas_budget)."""
        n_local = self.local_rows(n_rows_padded)
        c = scorer._pick_block(n_local, 1)
        if c == 0:
            return 0
        return n_local // min(sub, c)

    def score_topm(self, emb, bloom, created, valid, q, kw_w, kw_b, now_days, window_start,
                   m: int, mode: str = "xla", t: int = 8, sub: int = 512,
                   scale=None, err=None):
        """Global (ub_values [B, m+1], row_indices [B, m+1]) over the sharded
        planes (``RowSharded``; ``q``, ``kw_w``, ``kw_b`` replicated, a
        tensor on any device). Entry m is the certificate boundary."""
        self.calls[(mode, m, t, sub)] += 1
        n_dev = self.mesh.local_shards
        q_l, kw_l, kwb_l = (replicated(self.mesh, x) if x is not None else [None] * n_dev
                            for x in (q, kw_w, kw_b))
        outs_v, outs_i, offsets = [], [], []
        for l, d, g in self._shards():
            off = g * bloom.shards[l].shape[0]
            with _on(d):
                local = dict(
                    bloom=bloom.shards[l], created=created.shards[l], valid=valid.shards[l],
                    kw_w=kw_l[l], kw_b=kwb_l[l], now_days=now_days,
                    window_start=window_start, m=m, row_offset=off)
                if mode == "pallas_kw_only":
                    v, i = self._local_kw_only(**local, t=t, sub=sub)
                elif mode in ("pallas_int8", "pallas_int8_coarse"):
                    v, i = self._local_pallas(
                        emb.shards[l], scale.shards[l], err.shards[l], q=q_l[l], t=t, sub=sub,
                        int8=True, coarse=mode.endswith("_coarse"), **local)
                elif mode == "pallas":
                    v, i = self._local_pallas(emb.shards[l], None, None, q=q_l[l], t=t,
                                              sub=sub, int8=False, coarse=False, **local)
                elif mode == "xla":
                    v, i = self._local_xla(emb.shards[l], q=q_l[l], **local)
                else:
                    raise ValueError(f"unknown sharded scan mode {mode!r}")
            outs_v.append(v)
            outs_i.append(i)
            offsets.append(off)
        return _globalize_and_merge(self.mesh, outs_v, outs_i, offsets, m)

    def refine_select_dd(self, dev, q, kw_w, kw_b, now_days, vals_full, idxs_full,
                         t_out: int, r: int, q_raw=None):
        """Sharded compact serving stage: refine the merged scan candidates,
        select compactly and, when ``q_raw`` is given and the raw plane
        exists, take the device-exact cosine triple (sharded.py
        refine_select_dd).

        The merged candidates' global rows are replicated; each row lives on
        exactly one shard. Every shard maps them to LOCAL rows (rows it does
        not own become -1, which K3 treats as dead) and runs the unchanged
        single-device refine (``refine._refine_dispatch``, K3) over its
        local planes. The refined bounds combine with ``psum``: one shard
        contributes the value and the rest exact +0.0, so the combined
        bound is the owner's bit for bit. The compact selection then runs
        once; the DD stage gathers each selected row on its owner, runs
        ``exact_cos.dd_rows`` (K2's gathered entry) and psums (hi, lo, sabs)
        the same exact-zero way, so the double-float error bounds
        (exact_cos.DD_SUM_REL et al.) hold unchanged.

        Returns (rows [B, k], ubs [B, k], bound [B]) or, with the DD,
        (rows, ubs, bound, hi, lo, sabs), on the first shard's device."""
        want_dd = q_raw is not None and dev.raw is not None
        m1 = int(vals_full.shape[1])
        self.calls[("refine_select_dd", t_out, r, want_dd, m1)] += 1
        kw_w8 = scorer.quantize_kw_weights(kw_w)
        reps = [replicated(self.mesh, x) for x in (q, kw_w8, kw_b, vals_full, idxs_full)]
        ninf = float("-inf")
        ref_parts, own_parts = [], []
        for l, d, g in self._shards():
            n_local = dev.emb.shards[l].shape[0]
            off = g * n_local
            q_l, kw8_l, kwb_l, vals_l, idxs_l = (x[l] for x in reps)
            with _on(d):
                rows_g = idxs_l[:, :r]
                loc = rows_g - off
                owned = (rows_g >= 0) & (loc >= 0) & (loc < n_local)
                rows_local = torch.where(owned, loc, torch.full_like(loc, -1))
                vals_local = torch.where(owned, vals_l[:, :r], torch.full_like(vals_l[:, :r], ninf))
                refined_local = refine._refine_dispatch(
                    dev.emb.shards[l], dev.scale.shards[l], dev.emb2.shards[l],
                    dev.scale2.shards[l], dev.err2.shards[l], dev.bloom.shards[l],
                    dev.created.shards[l], dev.valid.shards[l], q_l, kw8_l, kwb_l, now_days,
                    rows_local, vals_local)
                live = refined_local > ninf
                ref_parts.append(torch.where(live, refined_local,
                                             torch.zeros_like(refined_local)))
                own_parts.append(live.to(torch.int32))
        total = psum(self.mesh, ref_parts)
        n_own = psum(self.mesh, own_parts)
        refined = torch.where(n_own > 0, total, torch.full_like(total, ninf))
        rows_sel, ubs_sel, bound = refine.compact_select(vals_full, idxs_full, refined, t_out, r)
        if not want_dd:
            return rows_sel, ubs_sel, bound
        rows_rep = replicated(self.mesh, rows_sel)
        qraw_rep = replicated(self.mesh, q_raw)
        parts: list[list[torch.Tensor]] = [[], [], []]
        for l, d, g in self._shards():
            raw = dev.raw.shards[l]
            n_local = raw.shape[0]
            with _on(d):
                loc_s = rows_rep[l] - g * n_local
                owned_s = (rows_rep[l] >= 0) & (loc_s >= 0) & (loc_s < n_local)
                safe_s = torch.where(owned_s, loc_s, torch.zeros_like(loc_s))
                c = raw.index_select(0, safe_s.reshape(-1).long()).reshape(
                    *safe_s.shape, raw.shape[1])  # [B, k, d], the owner gather
                # the same DD fold as the single-device exact_cos_rows (one
                # device function, csrc/dd_rows.cu), so the two paths give
                # the same bits
                for part, x in zip(parts, exact_cos.dd_rows(qraw_rep[l], c)):
                    part.append(torch.where(owned_s, x, torch.zeros_like(x)))
        hi, lo, sabs = (psum(self.mesh, p) for p in parts)
        return rows_sel, ubs_sel, bound, hi, lo, sabs
