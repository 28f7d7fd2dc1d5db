"""The port's layout sweep and transfer probe
(omni_recall_tpu_torch/tools/sweep_serving_layout.py, probe_tunnel.py) on the
CPU at tiny sizes:

- the sweep's stage 1 times two layouts and reports a third that the scan
  refuses (m > slices * t) as failed, and skips it;
- its stage 2 serves the same certified DTOs at every layout, equal to the
  f64 oracle's, and puts the engine's own layout back;
- ``probe_tunnel``'s chained refine selection equals the same chain through
  K3's plain version and the compact selection, and its ``main`` runs.
"""

from __future__ import annotations

import json

import torch

from omni_recall_tpu_torch.ops import refine
from omni_recall_tpu_torch.tools import probe_tunnel, sweep_serving_layout
from omni_recall_tpu_torch.tools.e2e_engine import build_e2e_engine


def _dto(hits):
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


def test_stage1_times_two_layouts_and_skips_an_unsupported_one(capsys):
    # 2^13 rows: 64 slices of 128 and 32 of 256 cover m = 128; 8 of 1024 at
    # t = 2 do not
    configs = sweep_serving_layout.parse_configs("128,2;256,4;1024,2")
    recs = sweep_serving_layout.stage1(1 << 13, 8, configs, d=64, bits=256, device="cpu",
                                       runs=1)
    assert [(r["sub"], r["t"]) for r in recs] == configs
    for r in recs[:2]:
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert "failed" not in r and r["launches"] == {}  # no kernel on the CPU
    assert "ValueError" in recs[2]["failed"] and "ms" not in recs[2]
    assert "FAILED" in capsys.readouterr().out


def test_stage2_serves_the_same_dtos_at_every_layout():
    engine, make_requests, now, opts = build_e2e_engine(1 << 13, 64, 256, device="cpu")
    configs = [(128, 2), (256, 4), (1024, 2)]
    results: dict = {}
    recs = sweep_serving_layout.stage2(engine, make_requests, now, configs, bt=12, g=2,
                                       results=results)
    assert [(r["sub"], r["t"]) for r in recs] == configs
    for r in recs:
        assert r["qps"] > 0 and 0 <= r["coarse_resolved"] <= 1 and 0 <= r["dd_resolved"] <= 1
    want = [[_dto(h) for h in out] for out in results[configs[0]]]
    for layout in configs[1:]:
        assert [[_dto(h) for h in out] for out in results[layout]] == want, layout
    for i, out in enumerate(results[configs[0]]):
        for (text, q, k), hits in zip(make_requests(300 + i, 12), out):
            assert _dto(hits) == _dto(engine._search_full_host(text, q, k, 0, now))
    assert (engine.options.coarse_sub, engine.options.coarse_t) == (opts.coarse_sub,
                                                                   opts.coarse_t)


def test_sweep_main_runs_both_stages(capsys):
    out = sweep_serving_layout.main(["--n", str(1 << 13), "--bt", "8", "--g", "1",
                                     "--configs", "128,2;1024,2", "--device", "cpu"])
    assert [r["sub"] for r in out["stage1"]] == [128, 1024]
    assert "failed" in out["stage1"][1] and len(out["stage2"]) == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tool"] == \
        "sweep_serving_layout"


def test_probe_tunnel_refine_chain_equals_the_plain_path():
    planes = probe_tunnel.refine_planes(4096, 64, 16, "cpu")
    ops = probe_tunnel.refine_operands(planes, 24, probe_tunnel.M)

    def plain_select(emb1, scale1, emb2, scale2, err2, bloom, created, valid, q, kw_w,
                     kw_b, now_days, vals, rows, t_out):
        r = vals.shape[1] - 1
        bounds = refine.refine_bounds_plain(
            emb1, scale1, emb2, scale2, err2, bloom, created, valid, q,
            refine.quantize_kw_weights(kw_w), kw_b, now_days, rows[:, :r], vals[:, :r])
        return refine.compact_select(vals, rows, bounds, t_out, r)

    got = probe_tunnel.refine_chain(planes, *ops)
    want = probe_tunnel.refine_chain(planes, *ops, select=plain_select)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_probe_tunnel_main_runs(capsys):
    out = probe_tunnel.main(["--rows", "2048", "--dim", "32", "--device", "cpu"])
    assert [r["mb"] for r in out["transfers"]] == list(probe_tunnel.H2D_MB + probe_tunnel.D2H_MB)
    assert all("pinned_ms" not in r for r in out["transfers"])  # no pinned memory here
    assert out["launch"]["one_sync_ms"] > 0
    assert [r["b"] for r in out["refine_select"]] == list(probe_tunnel.BATCHES)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tool"] == \
        "probe_tunnel"
