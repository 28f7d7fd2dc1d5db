"""The sharded scorer's ops against the single-device ones.

Counterpart of the repository's ``tools/tpu_sharded_check.py``, which runs
the shard_map int8 kernels on a 1-device mesh and bit-compares them with
the unsharded kernels (Mosaic under shard_map breaks only on hardware). The
port's check runs ShardedScorer over a mesh of the caller's devices against
the single-device entries on the same planes: the fused scan
(``pallas_int8``, K4), the coarse scan (``pallas_int8_coarse``, K1) and the
keyword-only scan (``pallas_kw_only``, K5) at one (sub, t), and
``refine_select_dd`` (K3 on every shard, the compact selection, K2's
gathered entry) against ``refine_select_from_scan`` plus
``exact_cos_rows`` on the fused scan's candidates.

- On a one-shard mesh every output must be bitwise the unsharded one.
- On an S-shard mesh whose cuts fall on slice boundaries (rows / S a
  multiple of sub) each scan's top-m values and its boundary must be
  bitwise the single-device ones, its rows the same up to exact ties, and
  the boundary at least the bound of every row it leaves out (checked
  against the scan's plain scores of ``sound_queries`` queries);
  refine_select_dd must stay bitwise.

There is no TPU assert: the card is the default device. ``python -m
omni_recall_tpu_torch.tools.sharded_check [--shards S] [--rows N]
[--device cpu]`` prints one JSON line and ``PARITY`` or ``DIVERGED``, exit
code 0 on parity.
"""

from __future__ import annotations

import argparse
import json

import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.tools import bits_equal, device_name

# the repository tool's shape (tools/tpu_sharded_check.py)
N, D, BITS, B, M = 1 << 16, 256, 512, 64, 128
T, SUB = 8, 512
NOW = 365.0


def make_inputs(n: int, d: int, bits: int, b: int, device, seed: int = 0) -> dict:
    """Unit rows with the int8, residual and raw planes (the port's device
    quantizer), a random bloom, dates over a year, unit queries and sparse
    keyword weights, all from one generator on ``device``."""
    from omni_recall_tpu_torch.index.device_index import DeviceArrays, device_quantize

    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    raw = torch.randn((n, d), generator=g, device=device)
    raw /= raw.norm(dim=1, keepdim=True)
    conv = device_quantize(raw, refine=True)
    w = bits // 8
    bloom = (torch.randint(0, 256, (n, w), generator=g, device=device)
             & torch.randint(0, 256, (n, w), generator=g, device=device)).to(torch.uint8)
    q = torch.randn((b, d), generator=g, device=device)
    q /= q.norm(dim=1, keepdim=True)
    kw = torch.where(torch.rand((b, bits), generator=g, device=device) < 0.05, 0.02, 0.0)
    dev = DeviceArrays(emb=conv["emb"], scale=conv["scale"], err=conv["err"],
                       emb2=conv["emb2"], scale2=conv["scale2"], err2=conv["err2"],
                       bloom=bloom, created=torch.linspace(0.0, 365.0, n, device=device),
                       valid=torch.ones(n, dtype=torch.bool, device=device), raw=raw)
    return {"dev": dev, "q": q, "kw": kw, "kw_b": torch.zeros(b, device=device),
            "q_raw": q * 1.7}


def sharded_planes(mesh, dev):
    """``dev``'s planes row-sharded over ``mesh`` (views where the mesh's
    devices hold them already)."""
    from omni_recall_tpu_torch.index.device_index import PLANES, DeviceArrays
    from omni_recall_tpu_torch.parallel.mesh import row_sharding

    return DeviceArrays(**{k: None if getattr(dev, k) is None
                           else row_sharding(mesh, getattr(dev, k)) for k in PLANES})


def _scan(mode, dev, inp, m, t, sub, r0):
    """The single-device entry of ``mode``."""
    from omni_recall_tpu_torch.ops import scorer

    q, kw, kw_b = inp["q"], inp["kw"], inp["kw_b"]
    if mode == "pallas_int8":
        return scorer.score_topm_int8(dev.emb, dev.scale, dev.err, dev.bloom, dev.created,
                                      dev.valid, q, kw, kw_b, NOW, r0, m=m, t=t, sub=sub)
    if mode == "pallas_int8_coarse":
        return scorer.score_topm_int8_coarse(dev.emb, dev.scale, dev.err, dev.created,
                                             dev.valid, q, kw, kw_b, NOW, r0, m=m, t=t, sub=sub)
    return scorer.score_topm_kw_only(dev.bloom, dev.created, dev.valid, kw, kw_b, NOW, r0,
                                     m=m, t=t, sub=sub)


def _plain_scores(mode, dev, inp, r0, queries):
    """Each row's bound as the scan computes it (its plain version's scores,
    before extraction) for the first ``queries`` queries: [q, N]."""
    from omni_recall_tpu_torch.ops import scorer

    q, kw, kw_b = inp["q"][:queries], inp["kw"][:queries], inp["kw_b"][:queries, None]
    if mode == "pallas_kw_only":
        add_row = scorer.make_add_row(dev.created, dev.valid, NOW, r0)
        return scorer._kw_scores_plain(dev.bloom, scorer.quantize_kw_weights(kw), kw_b, add_row)
    q8, q_scale, eq, err_term = scorer.prepare_int8_query(inp["q"], dev.err)
    q8, q_scale, eq = q8[:queries], q_scale[:queries], eq[:queries]
    add_row = scorer.make_add_row(dev.created, dev.valid, NOW, r0, err_term=err_term)
    scale_row = dev.scale[None, :]
    if mode == "pallas_int8_coarse":
        return scorer._coarse_scores_plain(dev.emb, q8, add_row, scale_row,
                                           scorer.COSINE_WEIGHT * q_scale,
                                           scorer.coarse_q_bias(eq, kw, kw_b[:, 0]))
    return scorer._fused_scores_plain(dev.emb, dev.bloom, q8, scorer.quantize_kw_weights(kw),
                                      kw_b, add_row, scale_row, q_scale,
                                      scorer.COSINE_WEIGHT * eq)


def op_parity(mesh, dev, inp, m: int = M, t: int = T, sub: int = SUB, r0: int = 0,
              t_out: int = 32, r: int = 64, sound_queries: int = 4) -> dict:
    """Each mode's parity record and the refine_select_dd record (module
    docstring); ``ok`` over all of them."""
    from omni_recall_tpu_torch.ops import exact_cos, refine
    from omni_recall_tpu_torch.parallel.sharded import ShardedScorer

    ss = ShardedScorer(mesh)
    sdev = sharded_planes(mesh, dev)
    one = mesh.n_shards == 1
    out: dict = {"shards": mesh.n_shards, "rows": int(dev.emb.shape[0]), "m": m, "t": t,
                 "sub": sub}
    ok = True
    fused = None
    for mode in ("pallas_int8", "pallas_int8_coarse", "pallas_kw_only"):
        rv, ri = _scan(mode, dev, inp, m, t, sub, r0)
        sv, si = ss.score_topm(sdev.emb, sdev.bloom, sdev.created, sdev.valid,
                               None if mode == "pallas_kw_only" else inp["q"], inp["kw"],
                               inp["kw_b"], NOW, r0, m=m, mode=mode, t=t, sub=sub,
                               scale=sdev.scale, err=sdev.err)
        if mode == "pallas_int8":
            fused = (rv, ri)
        rec = {"rows_equal": bool(torch.equal(ri[:, :m], si[:, :m])),
               "vals_equal": bits_equal(rv, sv),
               "values_equal": bits_equal(rv[:, :m].contiguous(), sv[:, :m].contiguous()),
               "boundary_equal": bits_equal(rv[:, m].contiguous(), sv[:, m].contiguous())}
        # rows the same up to exact ties: per query, equal as sets wherever
        # the values hold no tie
        same_sets = [set(ri[i, :m].tolist()) == set(si[i, :m].tolist())
                     or bool(torch.unique(rv[i, :m]).numel() < m) for i in range(rv.shape[0])]
        rec["rows_equal_up_to_ties"] = all(same_sets)
        if one:
            rec["ok"] = rec["rows_equal"] and rec["vals_equal"]
        else:
            scores = _plain_scores(mode, dev, inp, r0, sound_queries)
            left_out = torch.ones_like(scores, dtype=torch.bool)
            for i in range(scores.shape[0]):
                rows = si[i, :m].long()
                left_out[i, rows[rows >= 0]] = False
            worst = torch.where(left_out, scores, torch.full_like(scores, float("-inf")))
            rec["boundary_sound"] = bool((sv[:sound_queries, m] >= worst.amax(dim=1)).all())
            rec["ok"] = (rec["values_equal"] and rec["boundary_equal"]
                         and rec["rows_equal_up_to_ties"] and rec["boundary_sound"])
        out[mode] = rec
        ok = ok and rec["ok"]

    fv, fi = fused
    q, kw, kw_b, q_raw = inp["q"], inp["kw"], inp["kw_b"], inp["q_raw"]
    r1, u1, b1 = refine.refine_select_from_scan(
        dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2, dev.bloom, dev.created, dev.valid,
        q, kw, kw_b, NOW, fv, fi, t_out=t_out, r=r)
    rs, us, bs, hs, ls, sabs = ss.refine_select_dd(sdev, q, kw, kw_b, NOW, fv, fi,
                                                   t_out=t_out, r=r, q_raw=q_raw)
    h1, l1, s1 = exact_cos.exact_cos_rows(dev.raw, rs, q_raw)
    live = (rs >= 0) & (us > float("-inf"))
    sel_ok = bool(torch.equal(r1, rs)) and bits_equal(u1, us) and bits_equal(b1, bs)
    dd_ok = all(bits_equal(a[live], c[live]) for a, c in ((hs, h1), (ls, l1), (sabs, s1)))
    out["refine_select_dd"] = {"select_equal": sel_ok, "dd_equal": dd_ok,
                               "live_slots": int(live.sum()), "ok": sel_ok and dd_ok}
    out["ok"] = ok and sel_ok and dd_ok
    return out


def main(argv=None) -> dict:
    from omni_recall_tpu_torch.parallel.mesh import shards_mesh

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--shards", type=int, default=1,
                        help="shards of the mesh, all on the one device (default 1)")
    parser.add_argument("--rows", type=int, default=N)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    inp = make_inputs(args.rows, D, BITS, B, device)
    line = op_parity(shards_mesh(devices=[device] * args.shards), inp["dev"], inp)
    line["device"] = device_name(device)
    print(json.dumps(line), flush=True)
    print("PARITY" if line["ok"] else "DIVERGED", flush=True)
    return line


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
