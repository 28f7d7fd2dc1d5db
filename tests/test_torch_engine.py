"""The port's RecallEngine against the JAX RecallEngine and the oracle.

Both engines serve the same index state. For the headline configuration
(``SLICE``: ``backend="pallas"``, int8 scan, coarse prepass, direct or
refine selection, device-exact cosine) the JAX engine builds an int8
``DeviceIndex(exact_cos=True)`` from the records, with or without the
residual refine planes, and the port's index is made from that index's
planes and records with ``DeviceIndex.from_numpy_planes``. For the other
configurations (f32/bf16 scan storage under K6, backend xla, the
reference's defaults) each engine builds its own index from the same
records, as a server does. On the CPU the JAX side runs its Pallas kernels
in interpret mode and the port its plain PyTorch versions. Results must be
DTO-identical — the same chunk ids in the same order with the same
``round(score, 4)`` — to each other and to ``backend="oracle"``.

Refine order: on a CPU the JAX engine serves its refine stage with
``refine_ub`` (scale products first), while the port's plain K3 follows
the TPU kernel's order. The refine cases therefore route the JAX engine
through the interpret-mode kernel (``_refine_bounds_fused(interpret=True)``,
monkeypatched in this process only), so that both engines see the same
refined bounds and their stats can be compared exactly.
"""

import dataclasses
import random
import re
import string
from pathlib import Path
from datetime import datetime, timedelta, timezone

import jax
import numpy as np
import pytest

from omni_recall_tpu.config import EngineOptions as JOptions
from omni_recall_tpu.index.device_index import DeviceIndex as JIndex
from omni_recall_tpu.index.records import ChunkRecord as JChunk
from omni_recall_tpu.index.records import DocumentRecord as JDoc
from omni_recall_tpu.index.store import InMemoryIngestionStore as JStore
from omni_recall_tpu.ops import refine as jrefine
from omni_recall_tpu.search.engine import RecallEngine as JEngine
from omni_recall_tpu_torch.config import EngineOptions as TOptions
from omni_recall_tpu_torch.index.device_index import PLANES
from omni_recall_tpu_torch.index.device_index import DeviceIndex as TIndex
from omni_recall_tpu_torch.index.records import ChunkRecord as TChunk
from omni_recall_tpu_torch.index.records import DocumentRecord as TDoc
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore as TStore
from omni_recall_tpu_torch.search.engine import RecallEngine as TEngine

DIM = 64
BITS = 1024
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
SLICE = dict(
    backend="pallas", scan_dtype="int8", embedding_dim=DIM, capacity_block=4096,
    candidate_m=32, bloom_bits=BITS, recent_window=0, device_exact_cos=True,
    direct_select=True, refine=False,
)


def _corpus(seed: int, n: int, near_ties: bool = False, per_cluster: int = 64):
    """Clustered unit embeddings (``per_cluster`` rows per cluster) with
    cluster-token contents. ``near_ties``: every row of a cluster is the
    same vector and text, so scores tie exactly and certificates cannot
    separate them."""
    rng = np.random.default_rng(seed)
    n_clusters = max(8, n // per_cluster)
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32)
    words = ["".join(random.Random(seed + i).choices(string.ascii_lowercase, k=6))
             for i in range(n_clusters)]
    toks = ["".join(random.Random(10_000 * seed + i).choices(string.ascii_lowercase, k=8))
            for i in range(n)]
    rows = []
    for i in range(n):
        c = int(rng.integers(n_clusters))
        v = centers[c] if near_ties else centers[c] + 0.3 * rng.standard_normal(DIM).astype(np.float32)
        text = f"topic {words[c]} chunk" if near_ties else f"topic {words[c]} {toks[i]}"
        rows.append((text, v.astype(np.float32).tolist(), T0 + timedelta(minutes=i // 4)))
    return rows, centers, words, toks


def _stores(rows):
    """The same records in a JAX store and a port store (same seqs)."""
    out = []
    for store_cls, doc_cls, chunk_cls in ((JStore, JDoc, JChunk), (TStore, TDoc, TChunk)):
        store = store_cls()
        store.upsert_document(doc_cls(id="d", file_name="d.txt", created_at_utc=T0))
        chunks = [
            chunk_cls(id=f"d:{i:05d}", document_id="d", chunk_index=i, content=text,
                      embedding=emb, created_at_utc=ts)
            for i, (text, emb, ts) in enumerate(rows)
        ]
        store.upsert_chunks(chunks)
        out.append((store, chunks))
    return out


def _engines(rows, **overrides):
    (jstore, jchunks), (tstore, tchunks) = _stores(rows)
    opts = {**SLICE, **overrides}
    jdix = JIndex(DIM, capacity_block=opts["capacity_block"], bloom_bits=BITS,
                  ngram=4, bloom_hashes=2, scan_dtype="int8", refine=opts["refine"],
                  exact_cos=True)
    jeng = JEngine(jstore, jdix, JOptions(**opts))
    jeng.on_chunks_upserted(jchunks, new=True)
    dev = jdix.device_arrays()
    planes = {k: np.asarray(getattr(dev, k)) for k in PLANES
              if getattr(dev, k) is not None}
    by_id = {c.id: c for c in tchunks}
    meta = [None if m is None else by_id[m.id] for m in jdix.meta]
    tdix = TIndex.from_numpy_planes(planes, meta, device="cpu",
                                    capacity_block=opts["capacity_block"],
                                    bloom_bits=BITS, ngram=4, bloom_hashes=2)
    teng = TEngine(tstore, tdix, TOptions(**opts))
    toracle = TEngine(tstore, None, TOptions(backend="oracle", recent_window=0),
                      device="cpu")
    return jeng, teng, toracle


def _dto(hits):
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


def _requests(centers, words, count, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(count):
        c = int(rng.integers(len(centers)))
        q = centers[c] + 0.2 * rng.standard_normal(DIM).astype(np.float32)
        reqs.append((words[c], q.tolist(), int(rng.choice([1, 3, 10]))))
    return reqs


def _kw_requests(toks, count, seed):
    """Explicit empty vectors; each query names three rows' unique tokens."""
    rng = np.random.default_rng(seed)
    return [
        (" ".join(toks[j] for j in rng.choice(len(toks), 3, replace=False)), [],
         int(rng.choice([1, 2, 3])))
        for _ in range(count)
    ]


def _assert_same(jeng, teng, toracle, reqs):
    jres = jeng.search_batch(reqs, now=NOW)
    tres = teng.search_batch(reqs, now=NOW)
    for (q, emb, k), jh, th in zip(reqs, jres, tres):
        expected = _dto(toracle.search(q, emb, k, now=NOW))
        assert _dto(th) == _dto(jh)
        assert _dto(th) == expected
        assert len(th) == min(k, len(expected))


@pytest.fixture(scope="module")
def clustered():
    return _corpus(21, 3000)


def test_embedding_queries_coarse_direct_dd(clustered):
    """K1 -> direct selection -> K2 -> DD certificate."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 12, 1))
    assert teng.stats["coarse_resolved_total"] > 0
    assert teng.stats["dd_resolved_total"] > 0
    for key in ("coarse_resolved_total", "dd_resolved_total", "host_fallbacks_total"):
        assert teng.stats[key] == jeng.stats[key], key


def test_fused_scan_serves_without_coarse_prepass(clustered):
    """coarse_prepass=False: every embedding query goes to the fused K4."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows, coarse_prepass=False)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 10, 2))
    assert teng.stats["coarse_resolved_total"] == 0
    assert teng.stats["escalation_rounds_total"] == jeng.stats["escalation_rounds_total"]


def test_empty_query_vectors_take_keyword_scan(clustered):
    """Explicit empty vectors: keyword-only scan (K5), cosine exactly 0."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _engines(rows)
    reqs = _kw_requests(toks, 10, 3)
    _assert_same(jeng, teng, toracle, reqs)
    assert teng.stats["kw_only_resolved_total"] > 0
    assert teng.stats["kw_only_resolved_total"] == jeng.stats["kw_only_resolved_total"]


def test_near_tie_corpus_escalates_to_oracle_fill():
    rows, centers, words, _ = _corpus(22, 1500, near_ties=True)
    jeng, teng, toracle = _engines(rows)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 6, 4))
    assert teng.stats["host_fallbacks_total"] > 0
    assert teng.stats["host_fallbacks_total"] == jeng.stats["host_fallbacks_total"]


def test_pipelined_batches_and_mixed_requests(clustered):
    """search_batches_pipelined over mixed batches (vectors, empty vectors,
    a dim-mismatched vector routed to the host scan) equals search_batch."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _engines(rows)
    a = _requests(centers, words, 6, 5)
    b = _kw_requests(toks, 4, 6) + [("chunk", [0.5, 0.5], 3)]
    piped = teng.search_batches_pipelined([a, b], now=NOW)
    for reqs, got in zip((a, b), piped):
        jres = jeng.search_batch(reqs, now=NOW)
        assert [_dto(h) for h in got] == [_dto(h) for h in jres]
        for (q, emb, k), h in zip(reqs, got):
            assert _dto(h) == _dto(toracle.search(q, emb, k, now=NOW))


def test_options_the_port_cannot_serve_raise():
    """No engine option raises any more: sharding serves on the CPU for the
    xla and int8 options this test listed when it raised (an 8-shard mesh
    and the two shards of Engine:Shards=2 on the CPU), DTO-identical to the
    single-device engine; backend xla and f32/bf16 scan storage serve, and
    refine serves on the int8 pallas index."""
    from omni_recall_tpu_torch.parallel.mesh import shards_mesh

    rows, centers, words, _ = _corpus(5, 512)
    reqs = _requests(centers, words, 6, 5)
    for good in (dict(backend="xla"), dict(backend="pallas", scan_dtype="int8")):
        opts = dataclasses.replace(TOptions(embedding_dim=DIM), shards=2, recent_window=0,
                                   capacity_block=512, **good)
        _, (store, chunks) = _stores(rows)
        sharded = TEngine(store, None, opts, mesh=shards_mesh(devices=["cpu"] * 2))
        single = TEngine(store, None, dataclasses.replace(opts, shards=0), device="cpu")
        for eng in (sharded, single):
            eng.on_chunks_upserted(chunks, new=True)
        assert sharded.device_index.mesh.n_shards == 2
        got = sharded.search_batch(reqs, now=NOW)
        want = single.search_batch(reqs, now=NOW)
        assert [_dto(h) for h in got] == [_dto(h) for h in want]
        assert all(got)
    store = TStore()
    for good, dtype in ((dict(backend="xla"), "f32"),
                        (dict(backend="pallas", scan_dtype="bf16"), "bf16"),
                        (dict(backend="pallas", scan_dtype="f32"), "f32"),
                        (dict(backend="xla", refine=True, scan_dtype="int8"), "f32")):
        opts = dataclasses.replace(TOptions(embedding_dim=DIM), **good)
        eng = TEngine(store, None, opts, device="cpu")
        assert eng.device_index.scan_dtype == dtype and not eng.device_index.refine
    for direct in (True, False):
        opts = dataclasses.replace(TOptions(embedding_dim=DIM), backend="pallas",
                                   scan_dtype="int8", refine=True, direct_select=direct)
        eng = TEngine(store, None, opts, device="cpu")
        assert eng.device_index.refine


def _roadmap_titles() -> set[str]:
    """The bold item titles of ROADMAP.md (``**title**``, trailing period
    dropped)."""
    text = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    return {t.rstrip(".") for t in re.findall(r"\*\*([^*]+)\*\*", text)}


def test_every_not_ported_message_names_a_roadmap_title():
    """Every 'not ported yet' message in the port names ROADMAP.md items by
    title, and each title is one ROADMAP.md has."""
    titles = _roadmap_titles()
    pkg = Path(__file__).resolve().parent.parent / "omni_recall_tpu_torch"
    named = []
    for path in pkg.rglob("*.py"):
        src = path.read_text()
        # a title may open the next line of an implicitly joined string
        named += re.findall(r'ROADMAP\.md, "?\s*\'?"([^"]+)"', src)
    # none may be left: Engine:Shards, the last, went with the slice that
    # ported row sharding
    missing = [t for t in named if t not in titles]
    assert not missing, missing


def test_refine_default_is_the_reference_default():
    assert TOptions().refine is JOptions().refine is True


@pytest.fixture()
def kernel_order_refine(monkeypatch):
    """Route the JAX engine's refine stage through the interpret-mode TPU
    kernel (the order the port's K3 follows), in this process only. The jit
    caches are cleared on both sides of the patch so no trace made with the
    other function is reused."""
    def fused(*args):
        return jrefine._refine_bounds_fused(*args, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jrefine, "_refine_dispatch", fused)
    yield
    monkeypatch.undo()
    jax.clear_caches()


STATS = ("host_fallbacks_total", "escalation_rounds_total", "rescue_wide_total",
         "rescue_sliced_total", "coarse_resolved_total", "kw_only_resolved_total",
         "dd_resolved_total", "dd_escalations_total")


def _assert_same_stats(jeng, teng):
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], (key, teng.stats[key], jeng.stats[key])


def test_refine_selection_without_direct_select(clustered, kernel_order_refine):
    """refine=True, direct_select=False (the reference's own selection): K3
    refines the top-r scan candidates of every batch, compact_select picks
    the slice, K2 and the DD certificate finish."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _engines(rows, refine=True, direct_select=False)
    assert teng.device_index.device_arrays().emb2 is not None
    reqs = _requests(centers, words, 12, 1) + _kw_requests(toks, 4, 12)
    _assert_same(jeng, teng, toracle, reqs)
    assert teng.stats["coarse_resolved_total"] > 0
    assert teng.stats["kw_only_resolved_total"] > 0
    assert teng._last_select_direct is None
    _assert_same_stats(jeng, teng)


def test_direct_select_with_gate_forced_closed(clustered, kernel_order_refine):
    """refine=True, direct_select=True, the direct gate closed: the engine
    falls back to the refine selection and advances the gate's clock."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows, refine=True, direct_select=True)
    for eng in (jeng, teng):
        eng._direct_skip_until = 10**9
    reqs = _requests(centers, words, 12, 13)
    _assert_same(jeng, teng, toracle, reqs)
    assert teng._last_select_direct is False
    assert teng._direct_query_count == jeng._direct_query_count == len(reqs)
    _assert_same_stats(jeng, teng)


def _keyword_led(centers, words, count, seed, every=8):
    """Cluster queries where one in ``every`` has a random vector and only
    its cluster token as text: the cosine-only coarse certificate cannot
    hold for it, so the rescue loop serves it."""
    rng = np.random.default_rng(seed)
    reqs = _requests(centers, words, count, seed)
    for i in range(0, count, every):
        v = rng.standard_normal(DIM).astype(np.float32)
        reqs[i] = (reqs[i][0], (v / np.linalg.norm(v)).tolist(), 10)
    return reqs


@pytest.fixture(scope="module")
def small_clusters():
    """16 rows per cluster: embedding queries resolve on the coarse prepass,
    so a keyword-led query's miss stays a minority the rescue serves."""
    return _corpus(23, 4000, per_cluster=16)


@pytest.mark.parametrize("refine", [False, True])
def test_keyword_led_miss_batch(small_clusters, kernel_order_refine, refine):
    """The keyword-led miss path (F3): the coarse certificate misses, the
    wide rescue re-reads the full scan width, then the rescue loop's sliced
    K4 scan (with the planes: and K3 on its candidates) serves the misses.
    Results and stats against the JAX engine's, and the oracle. With the
    planes the misses close the direct gate and a later batch takes the
    refine selection; without them direct is the only compact path."""
    rows, centers, words, _ = small_clusters
    jeng, teng, toracle = _engines(rows, refine=refine)
    for count, seed in ((24, 15), (16, 16), (16, 17)):
        _assert_same(jeng, teng, toracle, _keyword_led(centers, words, count, seed))
        _assert_same_stats(jeng, teng)
        assert (teng._direct_query_count, teng._direct_skip_until) == (
            jeng._direct_query_count, jeng._direct_skip_until)
    assert teng.stats["rescue_wide_total"] > 0 and teng.stats["rescue_sliced_total"] > 0
    assert teng.stats["coarse_resolved_total"] > 0
    assert teng._last_select_direct is (not refine)


def test_pipelined_refine_batches_equal_serial(small_clusters):
    """With the planes and the direct gate: the pipelined executor (its
    dispatcher advances the gate while the finalize worker records
    outcomes) gives the same DTOs as serial batches, and the oracle's."""
    rows, centers, words, _ = small_clusters
    _, serial, toracle = _engines(rows, refine=True)
    _, piped, _ = _engines(rows, refine=True)
    batches = [_keyword_led(centers, words, 16, s) for s in (21, 22, 23, 24)]
    got = piped.search_batches_pipelined(batches, now=NOW)
    for reqs, res in zip(batches, got):
        want = serial.search_batch(reqs, now=NOW)
        assert [_dto(h) for h in res] == [_dto(h) for h in want]
        for (q, emb, k), h in zip(reqs, res):
            assert _dto(h) == _dto(toracle.search(q, emb, k, now=NOW))
    assert piped.stats["searches_total"] == serial.stats["searches_total"] == 64


def test_full_width_certificate_without_direct_select(clustered):
    """direct_select=False: no compact slice; the host certifies the full
    [B, m+1] scan candidates (no DD), as the JAX engine does without
    residual planes."""
    rows, centers, words, _ = clustered
    jeng, teng, toracle = _engines(rows, direct_select=False)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 8, 7))
    assert teng.stats["dd_resolved_total"] == 0
    assert teng.stats["coarse_resolved_total"] == jeng.stats["coarse_resolved_total"] > 0


def test_coalesced_concurrent_searches_equal_serial(clustered):
    """The coalescing executor (search/coalesce.py) batches concurrent
    requests through dispatch/finalize; every caller gets its own result."""
    import threading

    from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor

    rows, centers, words, toks = clustered
    _, teng, toracle = _engines(rows)
    reqs = _requests(centers, words, 10, 8) + _kw_requests(toks, 6, 9)
    ex = CoalescingSearchExecutor(teng, window_ms=20.0, max_batch=64)
    got: dict[int, list] = {}

    def run(i, q, emb, k):
        got[i] = _dto(ex.search(q, emb, k, now=NOW))

    threads = [threading.Thread(target=run, args=(i, *r)) for i, r in enumerate(reqs)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        ex.close()
    for i, (q, emb, k) in enumerate(reqs):
        assert got[i] == _dto(toracle.search(q, emb, k, now=NOW))
    assert teng.stats["searches_total"] == len(reqs)


# ---- the reference's defaults, f32/bf16 storage (K6) and backend xla ----


def test_engine_options_default_to_the_reference():
    """F2: every field of the two EngineOptions() is equal (the reference's
    defaults: backend xla over f32 storage, no device-exact cosine, the
    refine selection). The port adds one field, the operator's tracing
    switch (utils/tracing.py), off by default."""
    t, j = TOptions(), JOptions()
    names = {f.name for f in dataclasses.fields(JOptions)}
    assert {f.name for f in dataclasses.fields(TOptions)} == names | {"tracing"}
    assert t.tracing is False
    assert {n: getattr(t, n) for n in names} == {n: getattr(j, n) for n in names}
    assert (t.backend, t.scan_dtype, t.device_exact_cos, t.direct_select) == (
        "xla", "f32", False, False)


@pytest.mark.parametrize("device_exact_cos", [False, True])
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("scan_dtype", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_engine_built_index_takes_the_reference_layout(backend, scan_dtype, refine,
                                                        device_exact_cos):
    """Faults 1 and 2: the index an engine builds for itself has the JAX
    engine's (scan_dtype, refine, exact_cos) — f32 unless the backend is
    pallas, the residual planes on int8 only, the raw plane only for a
    pallas int8 refine index."""
    opts = dict(embedding_dim=DIM, capacity_block=128, bloom_bits=BITS, backend=backend,
                scan_dtype=scan_dtype, refine=refine, device_exact_cos=device_exact_cos)
    jdix = JEngine(JStore(), None, JOptions(**opts)).device_index
    tdix = TEngine(TStore(), None, TOptions(**opts), device="cpu").device_index
    layout = lambda d: (d.scan_dtype, d.refine, d.exact_cos)  # noqa: E731
    assert layout(tdix) == layout(jdix)


def _own_engines(rows, base=SLICE, **overrides):
    """A JAX and a port engine that each build their own index from the same
    records (options ``base`` with ``overrides``), and the port's oracle."""
    (jstore, jchunks), (tstore, tchunks) = _stores(rows)
    opts = {**base, **overrides}
    jeng = JEngine(jstore, None, JOptions(**opts))
    teng = TEngine(tstore, None, TOptions(**opts), device="cpu")
    jeng.on_chunks_upserted(jchunks, new=True)
    teng.on_chunks_upserted(tchunks, new=True)
    toracle = TEngine(tstore, None, TOptions(backend="oracle", recent_window=0),
                      device="cpu")
    return jeng, teng, toracle


@pytest.fixture()
def scan_calls(monkeypatch):
    """Count the port engine's calls of each scan entry (this process only)."""
    from omni_recall_tpu_torch.ops import scorer as tscorer
    from omni_recall_tpu_torch.ops import xla_scorer as txla

    calls = {}
    for mod, name in ((tscorer, "score_topm"), (tscorer, "score_topm_int8"),
                      (tscorer, "score_topm_int8_coarse"), (tscorer, "score_topm_kw_only"),
                      (txla, "score_topm")):
        key = f"{mod.__name__.rsplit('.', 1)[1]}.{name}"
        calls[key] = 0

        def counted(*args, _fn=getattr(mod, name), _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    return calls


def test_refine_off_device_exact_cos_on_takes_the_host_rescore(clustered):
    """Fault 1: Refine=false with DeviceExactCos=true builds no raw plane in
    either package, so neither runs the device-exact cosine: the same DTOs
    and the same dd_* (and every other) stats."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _own_engines(rows, refine=False, device_exact_cos=True)
    assert not teng.device_index.exact_cos and not jeng.device_index.exact_cos
    _assert_same(jeng, teng, toracle,
                 _requests(centers, words, 12, 31) + _kw_requests(toks, 4, 32))
    _assert_same_stats(jeng, teng)
    assert teng.stats["dd_resolved_total"] == teng.stats["dd_escalations_total"] == 0
    assert teng.stats["coarse_resolved_total"] > 0


@pytest.mark.parametrize("scan_dtype", ["bf16", "f32"])
def test_fp_storage_serves_through_k6(clustered, scan_calls, scan_dtype):
    """backend pallas over f32 / bf16 storage: no coarse prepass (Fault 3,
    int8 only), every embedding query goes straight to the rescue loop's K6
    scan; embedding-less queries take K5."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _own_engines(rows, scan_dtype=scan_dtype)
    assert teng.device_index.scan_dtype == scan_dtype
    assert teng._select_coarse_scorer(32, 4096) is None
    reqs = _requests(centers, words, 12, 33) + _kw_requests(toks, 4, 34)
    _assert_same(jeng, teng, toracle, reqs)
    _assert_same_stats(jeng, teng)
    assert teng.stats["coarse_resolved_total"] == 0
    assert teng.stats["kw_only_resolved_total"] > 0
    assert scan_calls["scorer.score_topm"] > 0 and scan_calls["scorer.score_topm_kw_only"] > 0
    assert scan_calls["scorer.score_topm_int8_coarse"] == 0
    # at 4096 rows K6 covers m <= 64: an escalation to m = 128 takes the xla
    # scorer on f32 storage (never on bf16)
    assert scan_calls["xla_scorer.score_topm"] <= (
        teng.stats["escalation_rounds_total"] if scan_dtype == "f32" else 0)


@pytest.mark.parametrize("scan_dtype, fallback", [("f32", "xla scorer"), ("bf16", "host scan")])
def test_k6_budget_exhausted(scan_calls, scan_dtype, fallback):
    """An index of 2048 rows: K6 (sub 512, t <= 8) covers m = 32 but not the
    escalation to m = 128. Near-tie queries escalate; on f32 storage the xla
    scorer takes over with full coverage, on bf16 the exact host scan."""
    rows, centers, words, _ = _corpus(22, 1500, near_ties=True)
    jeng, teng, toracle = _own_engines(rows, scan_dtype=scan_dtype, capacity_block=2048)
    _assert_same(jeng, teng, toracle, _requests(centers, words, 6, 35))
    _assert_same_stats(jeng, teng)
    assert teng.stats["escalation_rounds_total"] > 0
    assert scan_calls["scorer.score_topm"] > 0
    if fallback == "xla scorer":
        assert scan_calls["xla_scorer.score_topm"] > 0
        assert teng.stats["host_fallbacks_total"] == 0
    else:
        assert scan_calls["xla_scorer.score_topm"] == 0
        assert teng.stats["host_fallbacks_total"] > 0


# EngineOptions() with only the corpus keys set: the reference's default
# configuration (backend xla, f32 storage)
REFERENCE_DEFAULTS = dict(embedding_dim=DIM, candidate_m=32, bloom_bits=BITS,
                          recent_window=0, capacity_block=4096)


@pytest.mark.parametrize("kw_only", [False, True])
def test_xla_backend_serves_the_reference_defaults(clustered, scan_calls, kw_only):
    """backend xla: every query, with or without an embedding, goes to the
    rescue loop's xla scorer (full coverage); no kernel wrapper runs."""
    rows, centers, words, toks = clustered
    jeng, teng, toracle = _own_engines(rows, base=REFERENCE_DEFAULTS)
    assert teng.options.backend == "xla" and teng.device_index.scan_dtype == "f32"
    reqs = _requests(centers, words, 10, 36)
    if kw_only:
        reqs += _kw_requests(toks, 6, 37)
    _assert_same(jeng, teng, toracle, reqs)
    _assert_same_stats(jeng, teng)
    assert scan_calls["xla_scorer.score_topm"] > 0
    assert sum(v for k, v in scan_calls.items() if k.startswith("scorer.")) == 0
    assert teng.stats["kw_only_resolved_total"] == 0


def test_pipelined_xla_batches_equal_serial(clustered):
    rows, centers, words, toks = clustered
    _, serial, toracle = _own_engines(rows, base=REFERENCE_DEFAULTS)
    _, piped, _ = _own_engines(rows, base=REFERENCE_DEFAULTS)
    batches = [_requests(centers, words, 8, 38), _kw_requests(toks, 4, 39),
               _requests(centers, words, 8, 40) + _kw_requests(toks, 2, 41)]
    got = piped.search_batches_pipelined(batches, now=NOW)
    for reqs, res in zip(batches, got):
        want = serial.search_batch(reqs, now=NOW)
        assert [_dto(h) for h in res] == [_dto(h) for h in want]
        for (q, emb, k), h in zip(reqs, res):
            assert _dto(h) == _dto(toracle.search(q, emb, k, now=NOW))
    for key in STATS:
        assert piped.stats[key] == serial.stats[key], key
