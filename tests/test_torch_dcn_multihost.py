"""The port's row sharding across processes: 2 gloo processes of 4 CPU
shards each form one 8-shard mesh (parallel/distributed.py
initialize_multihost, parallel/mesh.py shards_mesh with the process group),
and the sharded scorer's collectives cross the process boundary
(``all_gather_into_tensor`` for the merge, ``all_reduce`` for the
exact-zero combine). Each worker asserts that the global results equal the
single-process ones: the xla scan against the single-device xla scorer
(tests/dcn_worker.py's check), the coarse int8 scan and refine_select_dd
against the in-process 8-shard mesh, bitwise.

The file runs itself as the worker (``python test_torch_dcn_multihost.py
<process_id> <port>``). Opt out with OMNI_DCN_TEST=0, as
tests/test_dcn_multihost.py does.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("OMNI_DCN_TEST", "1") == "0",
    reason="disabled via OMNI_DCN_TEST=0",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sharded_search():
    port = _free_port()
    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [repo_root, env.get("PYTHONPATH", "")] if p)
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"GLOO-OK pid={pid}" in out


def _worker(pid: int, port: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from omni_recall_tpu_torch.index.device_index import DeviceArrays, device_quantize
    from omni_recall_tpu_torch.ops import xla_scorer
    from omni_recall_tpu_torch.parallel.distributed import default_group, initialize_multihost
    from omni_recall_tpu_torch.parallel.mesh import row_sharding, shards_mesh
    from omni_recall_tpu_torch.parallel.sharded import ShardedScorer

    torch.set_num_threads(2)
    assert initialize_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                                backend="gloo")
    assert dist.get_world_size() == 2
    mesh = shards_mesh(devices=["cpu"] * 4, group=default_group())
    assert mesh.n_shards == 8 and mesh.local_shards == 4 and mesh.shard_index(0) == 4 * pid
    local = shards_mesh(devices=["cpu"] * 8)  # the same 8 shards in one process

    n, d, bits, b, m = 2048, 16, 64, 2, 8
    rng = np.random.default_rng(0)  # the same seed in both processes: the same globals
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bloom = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    created = np.linspace(0.0, 30.0, n).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw_w = np.zeros((b, bits), dtype=np.float32)
    kw_w[:, rng.integers(0, bits, size=5)] = 0.2
    kw_b = np.zeros(b, dtype=np.float32)
    t = torch.from_numpy
    r0 = 100

    def planes(mesh_):
        return [row_sharding(mesh_, t(x)) for x in (emb, bloom, created, valid)]

    got_v, got_i = ShardedScorer(mesh).score_topm(
        *planes(mesh), t(q), t(kw_w), t(kw_b), 30.0, r0, m=m, mode="xla")
    want_v, want_i = xla_scorer.score_topm(t(emb), t(bloom), t(created), t(valid), t(q),
                                           t(kw_w), t(kw_b), 30.0, r0, m=m)
    assert torch.equal(got_v[:, :m], want_v[:, :m]), "candidate values differ"
    for qi in range(b):
        assert set(got_i[qi, :m].tolist()) == set(want_i[qi, :m].tolist())
    assert torch.equal(got_v[:, m], want_v[:, m]), "boundaries differ"

    # int8 planes with the residual and raw planes: the coarse scan's merge
    # and refine_select_dd's psums across the processes, bitwise the
    # in-process mesh's
    conv = device_quantize(t(emb), refine=True)
    host = dict(emb=conv["emb"], scale=conv["scale"], err=conv["err"], emb2=conv["emb2"],
                scale2=conv["scale2"], err2=conv["err2"], bloom=t(bloom), created=t(created),
                valid=t(valid), raw=t(emb))
    q_raw = t(q) * 1.5
    outs = []
    for mesh_ in (mesh, local):
        dev = DeviceArrays(**{k: row_sharding(mesh_, v) for k, v in host.items()})
        ss = ShardedScorer(mesh_)
        vals, idxs = ss.score_topm(dev.emb, dev.bloom, dev.created, dev.valid, t(q), t(kw_w),
                                   t(kw_b), 30.0, r0, m=m, mode="pallas_int8_coarse", t=4,
                                   sub=64, scale=dev.scale, err=dev.err)
        sel = ss.refine_select_dd(dev, t(q), t(kw_w), t(kw_b), 30.0, vals, idxs, t_out=4,
                                  r=m, q_raw=q_raw)
        outs.append((vals, idxs) + tuple(sel))
    for a, c in zip(*outs):
        assert a.dtype == c.dtype and torch.equal(a, c), "cross-process result differs"
    dist.destroy_process_group()
    print(f"GLOO-OK pid={pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), sys.argv[2]))
