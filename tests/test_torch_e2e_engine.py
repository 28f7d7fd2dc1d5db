"""The port's end-to-end bench corpus and engine
(omni_recall_tpu_torch/tools/e2e_engine.py ``build_e2e_engine``) against the
repository bench's own ``bench.build_e2e_engine``, on the CPU.

The bench runs in a subprocess with JAX on the CPU (as tests/test_bench_stages.py
runs it: importing it sets JAX's compilation cache for the whole process),
builds its engine at n = 2^13 (capacity n) and n = 2^12 + 100 (capacity
8192: pad rows), d 64, 256 bloom bits, and writes what it built to an npz.
Here the port builds the same corpus and:

- its host mirrors (emb, raw, bloom, created, valid, the aux columns, the
  arena), the cluster signatures, ``now``, the options field by field and
  ``make_requests(s, 8)`` for three seeds are bitwise the bench's;
- every plane it installed (``install_device_planes``) is bitwise the
  bench's installed DeviceArrays and the port's own ``device_arrays()`` of a
  second index bulk-loaded from the same mirrors;
- three served batches equal the bench engine's and the f64 oracle's DTOs
  (ids, order, ``round(score, 4)``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from datetime import datetime

import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.tools import e2e_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, BITS = 64, 256
SIZES = (1 << 13, (1 << 12) + 100)
REQ_SEEDS = (11, 12, 13)
SERVE_SEEDS = (21, 22, 23)
SERVE_NB = 16

# the bench's build_e2e_engine, run as a script: one npz a size
_BENCH_DUMP = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import bench

out_dir, sizes = sys.argv[1], [int(x) for x in sys.argv[2].split(",")]
for n in sizes:
    engine, make_requests, now, opts = bench.build_e2e_engine(n, %(d)d, %(bits)d)
    dix = engine.device_index
    dev = dix.device_arrays()
    arrays = {"plane_" + f.name: np.asarray(getattr(dev, f.name))
              for f in dataclasses.fields(dev) if getattr(dev, f.name) is not None}
    for name in ("emb", "raw_emb", "bloom", "created", "valid", "created_us",
                 "created_ts", "seqs", "content_off", "raw_norm_sq"):
        arrays["host_" + name] = np.asarray(getattr(dix, name))
    arrays["host_arena"] = np.frombuffer(bytes(dix._arena), dtype=np.uint8)
    arrays["corpus_emb"] = engine.bench_corpus["emb"]
    arrays["corpus_assign"] = engine.bench_corpus["assign"]
    reqs = {}
    for s in %(req_seeds)r:
        rs = make_requests(s, 8)
        arrays["req_q_%%d" %% s] = np.stack([q for _, q, _ in rs])
        reqs[s] = [(t, k) for t, _, k in rs]
    served = {}
    for s in %(serve_seeds)r:
        res = engine.search_batch(make_requests(s, %(nb)d), now=now)
        served[s] = [[(h.chunk.id, round(h.score, 4)) for h in hits] for hits in res]
    meta = {"now": now.isoformat(), "opts": dataclasses.asdict(opts),
            "n_clusters": engine.bench_n_clusters,
            "contents": engine.bench_corpus["contents"],
            "meta": [(c.id, c.document_id, c.chunk_index, c.content,
                      c.created_at_utc.isoformat(), c.seq)
                     for c in engine.bench_corpus["meta"]],
            "reqs": reqs, "served": served}
    np.savez(f"{out_dir}/bench_{n}.npz", **arrays)
    with open(f"{out_dir}/bench_{n}.json", "w") as fh:
        json.dump(meta, fh)
""" % dict(d=D, bits=BITS, req_seeds=REQ_SEEDS, serve_seeds=SERVE_SEEDS, nb=SERVE_NB)


@pytest.fixture(scope="module")
def bench_dumps(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_e2e")
    env = {k: v for k, v in os.environ.items() if not k.startswith("OMNI_BENCH_")}
    env["OMNI_JAX_CACHE"] = str(out / "jax_cache")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_DUMP, str(out), ",".join(map(str, SIZES))],
        cwd=REPO, env=env, timeout=600, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    dumps = {}
    for n in SIZES:
        with open(out / f"bench_{n}.json", encoding="utf-8") as fh:
            meta = json.load(fh)
        dumps[n] = (dict(np.load(out / f"bench_{n}.npz")), meta)
    return dumps


@pytest.fixture(scope="module")
def ported():
    return {n: e2e_engine.build_e2e_engine(n, D, BITS, device="cpu") for n in SIZES}


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    return bool(np.array_equal(a, b))


def _dto(hits):
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


@pytest.mark.parametrize("n", SIZES)
def test_host_mirrors_bitwise_to_the_bench(n, bench_dumps, ported):
    arrays, meta = bench_dumps[n]
    engine = ported[n][0]
    dix = engine.device_index
    assert dix._cap == (n if n == 1 << 13 else 8192)
    corpus = engine.bench_corpus
    assert _bitwise(corpus["emb"], arrays["corpus_emb"])
    assert _bitwise(corpus["assign"], arrays["corpus_assign"])
    assert corpus["contents"] == meta["contents"]
    assert engine.bench_n_clusters == meta["n_clusters"] == 4096
    for name in ("emb", "raw_emb", "bloom", "created", "valid", "created_us", "created_ts",
                 "seqs", "content_off", "raw_norm_sq"):
        assert _bitwise(getattr(dix, name), arrays["host_" + name]), name
    assert bytes(dix._arena) == arrays["host_arena"].tobytes()
    got = [(c.id, c.document_id, c.chunk_index, c.content, c.created_at_utc.isoformat(),
            c.seq) for c in corpus["meta"]]
    assert got == [tuple(m) for m in meta["meta"]]
    # the records' embeddings are views of the adopted host rows
    assert all(_bitwise(c.embedding, corpus["emb"][i]) for i, c in enumerate(corpus["meta"]))


@pytest.mark.parametrize("n", SIZES)
def test_cluster_signatures_native_and_python_agree(n, ported):
    from omni_recall_tpu.ops import hashing as jhashing

    engine = ported[n][0]
    dix = engine.device_index
    contents = engine.bench_corpus["contents"]
    sigs = e2e_engine.cluster_signatures(contents, dix)
    want = np.stack([jhashing.chunk_signature(c.lower(), dix.bloom_bits, dix.ngram,
                                              dix.bloom_hashes) for c in contents])
    assert _bitwise(sigs, want)
    assert _bitwise(dix.bloom[:n], want[engine.bench_corpus["assign"]])


@pytest.mark.parametrize("n", SIZES)
def test_requests_now_and_options_are_the_bench(n, bench_dumps, ported):
    arrays, meta = bench_dumps[n]
    _, make_requests, now, opts = ported[n]
    assert now == datetime.fromisoformat(meta["now"])
    want = meta["opts"]
    got = dataclasses.asdict(opts)
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert (opts.coarse_sub, opts.coarse_t, opts.direct_select, opts.device_exact_cos,
            opts.select_t_out) == (0, 0, True, True, 0)
    for s in REQ_SEEDS:
        reqs = make_requests(s, 8)
        assert [[t, k] for t, _, k in reqs] == meta["reqs"][str(s)]
        assert _bitwise(np.stack([q for _, q, _ in reqs]), arrays[f"req_q_{s}"])


@pytest.mark.parametrize("n", SIZES)
def test_installed_planes_bitwise_to_the_bench(n, bench_dumps, ported):
    arrays, _ = bench_dumps[n]
    dev = ported[n][0].device_index.device_arrays()
    names = [f.name for f in dataclasses.fields(dev) if getattr(dev, f.name) is not None]
    assert sorted("plane_" + k for k in names) == sorted(
        k for k in arrays if k.startswith("plane_"))
    for name in names:
        assert _bitwise(getattr(dev, name).numpy(), arrays["plane_" + name]), name
    assert not dev.valid[n:].any() and not dev.bloom[n:].any()


@pytest.mark.parametrize("n", SIZES)
def test_installed_planes_bitwise_to_the_standard_upload(n, ported):
    """A second index bulk-loaded from the same mirrors and uploaded the
    standard way, with ``device_quantize`` (the route every index of
    2^16 rows or more takes; lowered here to this size)."""
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine

    engine, _, _, opts = ported[n]
    dix = engine.device_index
    other = RecallEngine(InMemoryIngestionStore(), options=opts, device="cpu").device_index
    other._DEVICE_QUANTIZE_MIN_ROWS = 0
    corpus = engine.bench_corpus
    aux = {"created_us": dix.created_us[:n], "created_ts": dix.created_ts[:n],
           "seqs": dix.seqs[:n], "lower_arena": bytes(dix._arena),
           "lower_off": dix.content_off[:n + 1]}
    other.bulk_load(corpus["emb"], dix.bloom[:n], dix.created[:n], corpus["meta"], aux=aux)
    got, want = dix.device_arrays(), other.device_arrays()
    assert got is not want
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert _bitwise(a.numpy(), b.numpy()), f.name


@pytest.mark.parametrize("n", SIZES)
def test_served_batches_equal_the_bench_and_the_oracle(n, bench_dumps, ported):
    _, meta = bench_dumps[n]
    engine, make_requests, now, _ = ported[n]
    for s in SERVE_SEEDS:
        reqs = make_requests(s, SERVE_NB)
        res = engine.search_batch(reqs, now=now)
        assert [_dto(h) for h in res] == [[tuple(x) for x in q] for q in meta["served"][str(s)]]
        for (text, q, k), hits in zip(reqs, res):
            assert _dto(hits) == _dto(engine._search_full_host(text, q, k, 0, now))


def test_layout_switches_and_the_card():
    """The bench's environment switches as arguments: (1024, 2) from 2^20
    rows on, dd off drops the raw plane; without a card the build
    raises."""
    big = e2e_engine.bench_options(1 << 20, 768, 1024)
    assert (big.coarse_sub, big.coarse_t, big.capacity_block) == (1024, 2, 16384)
    assert e2e_engine.slab_rows_for(1 << 20) == 1 << 18
    assert e2e_engine.slab_rows_for((1 << 12) + 100) == 4
    engine, _, _, opts = e2e_engine.build_e2e_engine(
        1 << 12, 32, 128, device="cpu", dd=False, direct_select=False, coarse_sub=256,
        coarse_t=4, select_t_out=16)
    assert (opts.coarse_sub, opts.coarse_t, opts.direct_select, opts.select_t_out,
            opts.device_exact_cos) == (256, 4, False, 16, False)
    assert engine.device_index.device_arrays().raw is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            e2e_engine.build_e2e_engine(1 << 12, 32, 128)
    ticks = []
    e2e_engine.build_e2e_engine(1 << 12, 32, 128, lambda: ticks.append(1), device="cpu")
    # host slabs, device slabs, and one before the planes are installed
    slabs = (1 << 12) // e2e_engine.slab_rows_for(1 << 12)
    assert len(ticks) == 2 * slabs + 1
