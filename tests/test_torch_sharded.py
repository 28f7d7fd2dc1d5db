"""The port's row-sharded serving mode (omni_recall_tpu_torch/parallel/) on
an 8-shard CPU mesh, against its single-device engine, the float64 oracle
and the JAX package's ShardedScorer.

The first group mirrors the CPU tests of tests/test_sharded.py on the port:
the sharded engine (per-shard top-k, all-gather merge, exact-zero combine)
must serve exactly what the single-device engine and the oracle serve. The
two 10M-row tests of that file keep their checks here at 2^16 rows (the
window starting in the middle of shard 4, the owner gathers and psums on
every shard); their 10M-row shape runs on the card (chip_smoke.py's
``sharded`` path). The JAX file's tenth test is a TPU check; its
counterpart is the one-shard op parity of that path.

The second group holds the port's ShardedScorer against the JAX one on the
conftest's 8 virtual CPU devices, from one numpy seed: the int8 modes
(K4, K1 and K5 through their plain versions; the JAX side in interpret
mode) bitwise in values and indices, the f32 fused mode (K6) bitwise on
exactly summable inputs, as tests/test_torch_scorer.py holds K6, the xla
mode within the reordered-sum bound of tests/test_torch_xla_scorer.py, and
refine_select_dd with its rows equal and its bounds and DD held as
tests/test_torch_refine.py and tests/test_torch_exact_cos.py hold them.
"""

import random
import string
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.index.device_index import DeviceArrays, device_quantize
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.models import hash_embedder
from omni_recall_tpu_torch.ops import exact_cos, hashing, oracle, refine, xla_scorer
from omni_recall_tpu_torch.parallel import sharded
from omni_recall_tpu_torch.parallel.distributed import initialize_multihost
from omni_recall_tpu_torch.parallel.mesh import row_sharding, shards_mesh
from omni_recall_tpu_torch.parallel.sharded import ShardedScorer
from omni_recall_tpu_torch.search.engine import RecallEngine

DIM = 32
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


@pytest.fixture(scope="module")
def mesh():
    return shards_mesh(devices=["cpu"] * 8)


def _corpus(n, rng, store):
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8))) for _ in range(60)]
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = []
    for i in range(n):
        content = " ".join(rng.choices(vocab, k=rng.randint(4, 25)))
        emb = hash_embedder.embed_text(content, DIM) if rng.random() > 0.1 else None
        chunks.append(
            ChunkRecord(
                id=f"d:{i:04d}", document_id="d", chunk_index=i, content=content,
                embedding=emb, created_at_utc=T0 + timedelta(minutes=i),
            )
        )
    store.upsert_chunks(chunks)
    return vocab, chunks


def _xla_options(window, candidate_m):
    return EngineOptions(
        backend="xla", embedding_dim=DIM, capacity_block=128,
        recent_window=window, candidate_m=candidate_m, bloom_bits=256,
    )


def _oracle(store, window):
    return RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=window),
                        device="cpu")


def _engines(mesh, window=300, candidate_m=8):
    store = InMemoryIngestionStore()
    sharded_eng = RecallEngine(store, options=_xla_options(window, candidate_m), mesh=mesh)
    single = RecallEngine(store, options=_xla_options(window, candidate_m), device="cpu")
    return store, sharded_eng, single, _oracle(store, window)


def _ids(hits):
    return [h.chunk.id for h in hits]


# -- the CPU tests of tests/test_sharded.py --


def test_sharded_matches_single_and_oracle(mesh):
    rng = random.Random(21)
    store, sharded_eng, single, oracle_eng = _engines(mesh)
    vocab, chunks = _corpus(200, rng, store)
    sharded_eng.on_chunks_upserted(chunks, new=True)
    single.on_chunks_upserted(chunks, new=True)

    assert sharded_eng.device_index.capacity_block % 8 == 0
    for _ in range(12):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        q_emb = hash_embedder.embed_text(query, DIM)
        top_k = rng.choice([1, 5, 10])
        hits_sh = sharded_eng.search(query, q_emb, top_k, now=NOW)
        hits_si = single.search(query, q_emb, top_k, now=NOW)
        hits_or = oracle_eng.search(query, q_emb, top_k, now=NOW)
        assert _ids(hits_sh) == _ids(hits_si) == _ids(hits_or)
        for a, b in zip(hits_sh, hits_or):
            assert a.score == b.score
    assert any(key[0] == "xla" for key in sharded_eng._sharded_scorer.calls)


def test_sharded_escalation_still_exact(mesh):
    rng = random.Random(33)
    store, sharded_eng, _, oracle_eng = _engines(mesh, candidate_m=2)
    vocab, chunks = _corpus(120, rng, store)
    sharded_eng.on_chunks_upserted(chunks, new=True)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    hits = sharded_eng.search(query, q_emb, 10, now=NOW)
    assert _ids(hits) == _ids(oracle_eng.search(query, q_emb, 10, now=NOW))
    assert sharded_eng.stats["escalation_rounds_total"] > 0


def test_sharded_window_and_delete(mesh):
    rng = random.Random(55)
    store, sharded_eng, _, oracle_eng = _engines(mesh, window=100)
    vocab, chunks = _corpus(150, rng, store)
    sharded_eng.on_chunks_upserted(chunks, new=True)
    store.delete_document("d")  # delete everything, re-add fresh docs
    sharded_eng.on_document_deleted("d")
    store.upsert_document(DocumentRecord(id="e", file_name="e.txt", created_at_utc=T0))
    fresh = [
        ChunkRecord(id=f"e:{i:04d}", document_id="e", chunk_index=i,
                    content=" ".join(rng.choices(vocab, k=10)),
                    embedding=hash_embedder.embed_text(f"fresh {i}", DIM),
                    created_at_utc=T0 + timedelta(days=1, minutes=i))
        for i in range(40)
    ]
    store.upsert_chunks(fresh)
    sharded_eng.on_chunks_upserted(fresh, new=True)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    hits = sharded_eng.search(query, q_emb, 5, now=NOW)
    assert _ids(hits) == _ids(oracle_eng.search(query, q_emb, 5, now=NOW))
    assert all(h.chunk.document_id == "e" for h in hits)


@pytest.mark.parametrize("scan_dtype", ["f32", "int8"])
def test_sharded_pallas_kernel_matches_oracle(mesh, scan_dtype):
    rng = random.Random(77)
    store = InMemoryIngestionStore()
    sharded_eng = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=1024,
            recent_window=0, candidate_m=8, bloom_bits=256, scan_dtype=scan_dtype,
        ),
        mesh=mesh,
    )
    oracle_eng = _oracle(store, 0)
    vocab, chunks = _corpus(300, rng, store)
    sharded_eng.on_chunks_upserted(chunks, new=True)
    assert sharded_eng.device_index.scan_dtype == scan_dtype

    for _ in range(6):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        q_emb = hash_embedder.embed_text(query, DIM)
        hits = sharded_eng.search(query, q_emb, 5, now=NOW)
        expected = oracle_eng.search(query, q_emb, 5, now=NOW)
        assert _ids(hits) == _ids(expected)
        for a, b in zip(hits, expected):
            assert a.score == b.score

    # the fused scan (not a fallback) must actually have run on the shards
    expected_mode = "pallas_int8" if scan_dtype == "int8" else "pallas"
    assert any(key[0] == expected_mode for key in sharded_eng._sharded_scorer.calls)


def test_multihost_initialize_noop_when_unconfigured(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_multihost() is False  # a harmless no-op on one host
    assert not torch.distributed.is_initialized()


def _planes(n, d, bits, seed, b):
    """Unit rows with their refine planes (the port's device quantizer),
    bloom, dates over a year, unit queries and keyword weights."""
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((n, d)).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    bloom = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    created = np.linspace(0.0, 365.0, n).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[rng.integers(0, n, size=n // 1000)] = False  # scattered tombstones
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw_w = np.zeros((b, bits), dtype=np.float32)
    kw_w[:, rng.integers(0, bits, size=6)] = 0.17
    return rng, raw, bloom, created, valid, q, kw_w


def test_sharded_merge_mid_shard_window(mesh):
    """tests/test_sharded.py test_sharded_merge_at_10m_rows at 2^16 rows:
    the window starts in the middle of shard 4, so the global row offset
    decides the mask. Same candidate values as the single-device xla
    scorer, indices permuted only within exact ties, every row in window
    and valid, the same boundary."""
    n, d, bits, b, m = 1 << 16, 8, 64, 2, 16
    _, emb, bloom, created, valid, q, kw_w = _planes(n, d, bits, 0, b)
    kw_b = np.zeros(b, dtype=np.float32)
    r0 = n // 2 + 1234
    t = torch.from_numpy
    ss = ShardedScorer(mesh)
    got_v, got_i = ss.score_topm(
        *(row_sharding(mesh, t(x)) for x in (emb, bloom, created, valid)),
        t(q), t(kw_w), t(kw_b), 365.0, r0, m=m, mode="xla")
    want_v, want_i = xla_scorer.score_topm(t(emb), t(bloom), t(created), t(valid), t(q),
                                           t(kw_w), t(kw_b), 365.0, r0, m=m)
    got_v, got_i, want_v, want_i = (x.numpy() for x in (got_v, got_i, want_v, want_i))
    assert np.array_equal(got_v[:, :m], want_v[:, :m])
    for qi in range(b):
        assert set(got_i[qi, :m]) == set(want_i[qi, :m]) or np.array_equal(
            np.sort(got_v[qi, :m]), np.sort(want_v[qi, :m]))
        assert (got_i[qi, :m] >= r0).all()
        assert valid[got_i[qi, :m]].all()
    assert np.array_equal(got_v[:, m], want_v[:, m])


def _dd_engine_opts():
    return EngineOptions(
        backend="pallas", embedding_dim=DIM, capacity_block=1024,
        recent_window=0, candidate_m=8, bloom_bits=256, scan_dtype="int8",
        device_exact_cos=True,
    )


def test_sharded_refine_select_dd_matches_single_and_oracle(mesh):
    """Refine, compact selection and the device-exact cosine on the shards
    serve the same ranked citations as the single-device DD path and the
    float64 oracle, keyword-only queries (the zero-DD marker) and
    certificate escalations included."""
    rng = random.Random(33)
    store = InMemoryIngestionStore()
    sharded_eng = RecallEngine(store, options=_dd_engine_opts(), mesh=mesh)
    single = RecallEngine(store, options=_dd_engine_opts(), device="cpu")
    oracle_eng = _oracle(store, 0)
    vocab, chunks = _corpus(300, rng, store)
    sharded_eng.on_chunks_upserted(chunks, new=True)
    single.on_chunks_upserted(chunks, new=True)
    dix = sharded_eng.device_index
    assert dix.exact_cos and dix.refine and dix.device_arrays().raw is not None

    reqs = []
    for _ in range(24):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        emb = hash_embedder.embed_text(query, DIM) if rng.random() > 0.25 else None
        reqs.append((query, emb, 5))
    outs_s = sharded_eng.search_batch(reqs, now=NOW)
    outs_1 = single.search_batch(reqs, now=NOW)
    outs_o = oracle_eng.search_batch(reqs, now=NOW)
    for hs, h1, ho in zip(outs_s, outs_1, outs_o):
        assert _ids(hs) == _ids(ho)
        assert [h.score for h in hs] == [h.score for h in ho]
        assert _ids(h1) == _ids(ho)
    # the sharded compact stage must actually have run (not a fallback)
    assert any(k[0] == "refine_select_dd" and k[3] for k in sharded_eng._sharded_scorer.calls)


def test_sharded_refine_select_dd_op_bit_parity(mesh):
    """Op level: the sharded refine/select output is bitwise the single-
    device refine_select_from_scan (the psum adds exact zeros; the owner's
    local refine is the same computation over the same row bits), and the
    DD triple matches exact_cos_rows on every live slot."""
    rng = random.Random(5)
    store = InMemoryIngestionStore()
    sharded_eng = RecallEngine(store, options=_dd_engine_opts(), mesh=mesh)
    single = RecallEngine(store, options=_dd_engine_opts(), device="cpu")
    vocab, chunks = _corpus(260, rng, store)
    sharded_eng.on_chunks_upserted(chunks, new=True)
    single.on_chunks_upserted(chunks, new=True)
    dev_s = sharded_eng.device_index.device_arrays()
    dev_1 = single.device_index.device_arrays()

    b, m = 8, 8
    queries = [" ".join(rng.choices(vocab, k=rng.randint(1, 3))) for _ in range(b)]
    q_raw = np.stack([hash_embedder.embed_text(t, DIM) for t in queries]).astype(np.float32)
    qn = np.sqrt(np.sum(q_raw.astype(np.float64) ** 2, axis=1))
    q = (q_raw / np.where(qn[:, None] > 0, qn[:, None], 1.0)).astype(np.float32)
    dix = sharded_eng.device_index
    w, bias = hashing.query_bit_weights_batch(
        [oracle.query_terms(t) for t in queries], dix.bloom_bits, dix.ngram, dix.bloom_hashes)
    w, bias = torch.from_numpy(w.astype(np.float32)), torch.from_numpy(bias.astype(np.float32))
    q, q_raw = torch.from_numpy(q), torch.from_numpy(q_raw)

    # one scan (single-device ops) provides the candidates; both refine
    # paths consume the same [B, m+1]
    scan, _ = single._select_scorer(m, int(dev_1.emb.shape[0]))
    vals, idxs = scan(dev_1, q, w, bias, 17.0, 0, m)
    t_out, r = 8, 8
    rows_1, ubs_1, bound_1 = refine.refine_select_from_scan(
        dev_1.emb, dev_1.scale, dev_1.emb2, dev_1.scale2, dev_1.err2, dev_1.bloom,
        dev_1.created, dev_1.valid, q, w, bias, 17.0, vals, idxs, t_out=t_out, r=r)
    rows_s, ubs_s, bound_s, hi_s, lo_s, sabs_s = sharded_eng._sharded_scorer.refine_select_dd(
        dev_s, q, w, bias, 17.0, vals, idxs, t_out=t_out, r=r, q_raw=q_raw)
    assert torch.equal(rows_s, rows_1)
    assert torch.equal(ubs_s, ubs_1)
    assert torch.equal(bound_s, bound_1)
    hi_1, lo_1, sabs_1 = exact_cos.exact_cos_rows(dev_1.raw, rows_s, q_raw)
    live = (rows_s >= 0) & (ubs_s > -np.inf)
    assert live.any()
    for got, want in ((hi_s, hi_1), (lo_s, lo_1), (sabs_s, sabs_1)):
        assert torch.equal(got[live], want[live])


def test_sharded_serving_dd_mid_shard(mesh):
    """tests/test_sharded.py test_sharded_serving_dd_at_10m_rows at 2^16
    rows: refine, compact selection and the DD over synthesized scan
    candidates spread across every shard, bitwise the single-device ops."""
    n, d, bits, b, m, t_out, r = 1 << 16, 16, 64, 2, 16, 8, 16
    rng, raw, bloom, created, valid, q, kw_w = _planes(n, d, bits, 7, b)
    valid[:] = True
    raw_t = torch.from_numpy(raw)
    conv = device_quantize(raw_t, refine=True)
    planes = dict(emb=conv["emb"], bloom=torch.from_numpy(bloom),
                  created=torch.from_numpy(created), valid=torch.from_numpy(valid),
                  scale=conv["scale"], err=conv["err"], emb2=conv["emb2"],
                  scale2=conv["scale2"], err2=conv["err2"], raw=raw_t)
    dev = DeviceArrays(**planes)
    dev_s = DeviceArrays(**{k: row_sharding(mesh, v) for k, v in planes.items()})
    q = torch.from_numpy(q)
    q_raw = q * 1.7
    kw_w = np.zeros((b, bits), dtype=np.float32)
    kw_w[:, rng.integers(0, bits, size=4)] = 0.25
    kw_w, kw_b = torch.from_numpy(kw_w), torch.zeros(b)
    # synthesized scan output: distinct rows spread across all shards,
    # bounds sorted descending, the boundary at position m
    idxs = np.stack([rng.choice(n, size=m, replace=False).astype(np.int32) for _ in range(b)])
    idxs[0, :8] = np.arange(8) * (n // 8) + 4321  # one candidate in every shard
    vals = np.sort(rng.uniform(0.3, 0.9, size=(b, m)).astype(np.float32), axis=1)[:, ::-1]
    vals_full = torch.from_numpy(np.concatenate([vals, np.full((b, 1), 0.25, np.float32)], 1))
    idxs_full = torch.from_numpy(np.concatenate([idxs, np.full((b, 1), -1, np.int32)], 1))

    rs, us, bs, hi, lo, sa = ShardedScorer(mesh).refine_select_dd(
        dev_s, q, kw_w, kw_b, 365.0, vals_full, idxs_full, t_out=t_out, r=r, q_raw=q_raw)
    r1, u1, b1 = refine.refine_select_from_scan(
        dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2, dev.bloom, dev.created,
        dev.valid, q, kw_w, kw_b, 365.0, vals_full, idxs_full, t_out=t_out, r=r)
    hi1, lo1, sa1 = exact_cos.exact_cos_rows(dev.raw, r1, q_raw)
    assert torch.equal(rs, r1) and torch.equal(us, u1) and torch.equal(bs, b1)
    live = (rs >= 0) & (us > -np.inf)
    assert len(set((rs[live] // (n // 8)).tolist())) > 1  # rows from several owners
    assert torch.equal(hi[live], hi1[live]) and torch.equal(lo[live], lo1[live])
    assert torch.equal(sa[live], sa1[live])


# -- the mesh, the collectives and the scorer's surface --


def test_row_sharding_views_and_offsets(mesh):
    plane = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    rs = row_sharding(mesh, plane)
    assert rs.shape == plane.shape and rs.n_local == 8 and rs.row0 == list(range(0, 64, 8))
    for l, shard in enumerate(rs.shards):
        assert shard.data_ptr() == plane[8 * l].data_ptr()  # a view, no copy
    host = row_sharding(mesh, plane.numpy())  # a host array is copied once
    assert all(torch.equal(a, b) for a, b in zip(host.shards, rs.shards))
    assert host.shards[1].data_ptr() == host.shards[0].data_ptr() + 8 * 3 * 4
    with pytest.raises(ValueError, match="do not split"):
        row_sharding(mesh, plane[:60])


def test_psum_is_the_exact_zero_combine(mesh):
    """One shard holds the value, the rest +0.0: the psum is the value
    bitwise, except -0.0, which any added zero makes +0.0."""
    vals = torch.tensor([1.5e-30, -3.25, float("-inf"), -0.0, 7.0])
    parts = [torch.zeros(5) for _ in range(8)]
    for j, owner in enumerate((0, 3, 7, 5, 2)):
        parts[owner][j] = vals[j]
    got = sharded.psum(mesh, parts)
    want = vals.clone()
    want[3] = 0.0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    one = shards_mesh(devices=["cpu"])
    assert torch.signbit(sharded.psum(one, [torch.tensor([-0.0])]))[0]
    gathered = sharded.all_gather(mesh, [torch.full((2,), float(i)) for i in range(8)])
    assert gathered.shape == (8, 2) and gathered[:, 0].tolist() == list(range(8))


def test_pallas_budget_and_local_rows(mesh):
    ss = ShardedScorer(mesh)
    assert ss.local_rows(8192) == 1024
    assert ss.pallas_budget(8192) == 2 and ss.pallas_budget(8192, sub=256) == 4
    assert ss.pallas_budget(8 * 100) == 0  # 100 local rows: no block aligns


def test_sharded_engine_refuses_the_device_embedder(mesh):
    class Embedder:
        dim = DIM

    eng = RecallEngine(InMemoryIngestionStore(), options=_dd_engine_opts(), mesh=mesh)
    with pytest.raises(ValueError, match="single-device"):
        eng.attach_device_embedder(Embedder())


# -- against the JAX package's ShardedScorer on its 8 virtual devices --

N_J, D_J, BITS_J, B_J, M_J = 8192, 64, 256, 8, 12
SUB_J, T_J = 256, 4
R0_J = 3 * (N_J // 8) + 100  # the window starts inside shard 3


@pytest.fixture(scope="module")
def jax_scorer():
    from omni_recall_tpu.parallel.mesh import shards_mesh as jmesh
    from omni_recall_tpu.parallel.sharded import ShardedScorer as JScorer

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return JScorer(jmesh(8), interpret=True)


def _int8_operands(seed: int, exact_fp: bool = False, today: bool = False):
    """Index and query operands. ``today``: every row dated at the query
    time, so the recency term is exactly 1 on both sides (XLA's exp and
    PyTorch's may differ by an ulp, tests/test_torch_scorer.py
    test_make_add_row_matches_jax); otherwise dates spread over 100 days."""
    rng = np.random.default_rng(seed)
    n, d, b, w = N_J, D_J, B_J, BITS_J // 8
    if exact_fp:
        # exactly summable (tests/test_torch_scorer.py _fp_operands): six
        # nonzeros a row and query on a 2^-4 grid, keyword weights on 2^-6
        emb = np.zeros((n, d), np.float32)
        q = np.zeros((b, d), np.float32)
        for x in (emb, q):
            for r in range(x.shape[0]):
                x[r, rng.choice(d, 6, replace=False)] = rng.integers(-16, 17, 6) * 2.0**-4
        kw = np.where(rng.random((b, 8 * w)) < 0.05,
                      rng.integers(0, 20, (b, 8 * w)) * 2.0**-6, 0).astype(np.float32)
    else:
        emb = rng.standard_normal((n, d)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        q = rng.standard_normal((b, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        kw = np.where(rng.random((b, 8 * w)) < 0.05, rng.random((b, 8 * w)) * 0.1,
                      0).astype(np.float32)
    emb[9], emb[11] = emb[4], emb[4]  # exact ties inside a shard
    bloom = rng.integers(0, 256, size=(n, w), dtype=np.uint8)
    bloom[9], bloom[11] = bloom[4], bloom[4]
    from omni_recall_tpu.ops.quantize import quantize_rows_int8

    emb8, scale, err = quantize_rows_int8(emb)
    created = np.sort((rng.random(n) * 100).astype(np.float32))
    created[9] = created[11] = created[4]
    if today:
        created[:] = 60.0
    valid = rng.random(n) > 0.1
    kw_b = (rng.random(b) * 0.05).astype(np.float32)
    return dict(emb=emb, emb8=emb8, scale=scale, err=err, bloom=bloom, created=created,
                valid=valid, q=q, kw=kw, kw_b=kw_b)


def _both(jax_scorer, mesh, ops, mode, m=M_J, t=T_J, sub=SUB_J):
    emb = ops["emb8"] if mode.startswith("pallas_int8") or mode == "pallas_kw_only" else ops["emb"]
    q = None if mode == "pallas_kw_only" else ops["q"]
    jv, ji = jax_scorer.score_topm(
        jnp.asarray(emb), jnp.asarray(ops["bloom"]), jnp.asarray(ops["created"]),
        jnp.asarray(ops["valid"]), None if q is None else jnp.asarray(q),
        jnp.asarray(ops["kw"]), jnp.asarray(ops["kw_b"]), jnp.float32(60.0), jnp.int32(R0_J),
        m=m, mode=mode, t=t, sub=sub, scale=jnp.asarray(ops["scale"]),
        err=jnp.asarray(ops["err"]))
    rs = lambda x: row_sharding(mesh, torch.from_numpy(x))  # noqa: E731
    tv, ti = ShardedScorer(mesh).score_topm(
        rs(emb), rs(ops["bloom"]), rs(ops["created"]), rs(ops["valid"]),
        None if q is None else torch.from_numpy(q), torch.from_numpy(ops["kw"]),
        torch.from_numpy(ops["kw_b"]), 60.0, R0_J, m=m, mode=mode, t=t, sub=sub,
        scale=rs(ops["scale"]), err=rs(ops["err"]))
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _bits(x):
    return np.asarray(x).view(np.uint32)


INT8_MODES = ["pallas_int8", "pallas_int8_coarse", "pallas_kw_only"]


@pytest.mark.parametrize("mode", INT8_MODES)
def test_int8_modes_match_the_jax_sharded_scorer_bitwise(jax_scorer, mesh, mode):
    """Rows dated at the query time: values and indices bitwise (exact ties
    of the keyword-only scores included)."""
    jv, ji, tv, ti = _both(jax_scorer, mesh, _int8_operands(3, today=True), mode)
    assert jv.shape == tv.shape == (B_J, M_J + 1)
    assert np.array_equal(_bits(jv), _bits(tv))
    assert np.array_equal(ji, ti)
    assert (ti[:, :M_J][tv[:, :M_J] > -np.inf] >= R0_J).all()


@pytest.mark.parametrize("mode", ["pallas_int8", "pallas_int8_coarse"])
def test_int8_modes_match_the_jax_sharded_scorer_with_spread_dates(jax_scorer, mesh, mode):
    """Rows dated over 100 days: the recency exp may differ by an ulp, which
    a packed key (the low log2(sub) bits of each value hold its lane) can
    carry up to a granule of sub ulps. Values within (4 + sub) ulps, indices
    equal wherever a value is further than twice that from its neighbours.
    (The keyword-only scores take a few quantized levels, so only the dates
    part its rows there: its bitwise case above covers it.)"""
    jv, ji, tv, ti = _both(jax_scorer, mesh, _int8_operands(3), mode)
    fin = np.isfinite(jv)
    assert np.array_equal(fin, np.isfinite(tv))
    bound = (4 + SUB_J) * np.spacing(np.abs(np.where(fin, jv, 0)).astype(np.float32))
    assert np.all(np.abs(np.where(fin, jv - tv, 0)) <= bound)
    gaps = np.abs(np.diff(np.where(fin, jv, -9.0)[:, :M_J].astype(np.float64), axis=1))
    clear = np.ones_like(ji[:, :M_J], dtype=bool)
    clear[:, 1:] &= gaps > 2 * bound[:, 1:M_J]
    clear[:, :-1] &= gaps > 2 * bound[:, :M_J - 1]
    assert clear.mean() > 0.75  # the comparison is not vacuous
    assert np.array_equal(ji[:, :M_J][clear], ti[:, :M_J][clear])


def test_f32_fused_mode_matches_the_jax_sharded_scorer_on_exact_sums(jax_scorer, mesh):
    ops = _int8_operands(4, exact_fp=True, today=True)
    jv, ji, tv, ti = _both(jax_scorer, mesh, ops, "pallas")
    assert np.array_equal(_bits(jv), _bits(tv))
    assert np.array_equal(ji, ti)


def test_xla_mode_matches_the_jax_sharded_scorer_within_the_sum_order_bound(jax_scorer, mesh):
    ops = _int8_operands(5)
    jv, ji, tv, ti = _both(jax_scorer, mesh, ops, "xla")
    g = lambda n: n * 2.0**-24  # noqa: E731
    cos_abs = np.abs(ops["q"].astype(np.float64)) @ np.abs(ops["emb"].astype(np.float64)).T
    per_q = 0.7 * g(D_J) * cos_abs.max(axis=1) + 0.2 * g(BITS_J) * ops["kw"].sum(axis=1)
    fin = np.isfinite(jv)
    assert np.array_equal(fin, np.isfinite(tv))
    bound = per_q[:, None] + 4 * np.spacing(np.abs(np.where(fin, jv, 0)))
    assert np.all(np.abs(np.where(fin, jv - tv, 0)) <= bound)
    gaps = np.abs(np.diff(jv[:, :M_J].astype(np.float64), axis=1))
    clear = np.ones_like(ji[:, :M_J], dtype=bool)
    clear[:, 1:] &= gaps > 2 * bound[:, 1:M_J]
    clear[:, :-1] &= gaps > 2 * bound[:, :M_J - 1]
    assert clear.mean() > 0.75  # the comparison is not vacuous
    assert np.array_equal(ji[:, :M_J][clear], ti[:, :M_J][clear])


def test_refine_select_dd_matches_the_jax_sharded_scorer(jax_scorer, mesh, monkeypatch):
    """The JAX side refines in the interpret-mode TPU kernel's order (the
    order K3 and its plain version follow; tests/test_torch_engine.py
    routes the JAX engine the same way): refined bounds within 1e-6 (the
    recency exp of XLA and PyTorch may differ by an ulp), rows equal where
    no two bounds lie within 2e-6, DD hi and lo bitwise, sabs within
    SABS_REL."""
    from omni_recall_tpu.index.device_index import DeviceArrays as JArrays
    from omni_recall_tpu.ops import refine as jrefine
    from omni_recall_tpu.ops.quantize import quantize_rows_int8_residual

    def fused(*args):
        return jrefine._refine_bounds_fused(*args, interpret=True)

    jax.clear_caches()
    monkeypatch.setattr(jrefine, "_refine_dispatch", fused)
    rng = np.random.default_rng(6)
    n, d, bits, b, m, t_out, r = N_J, D_J, BITS_J, B_J, 24, 8, 16
    raw = rng.standard_normal((n, d)).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    q1, s1, e1, q2, s2, e2 = quantize_rows_int8_residual(raw)
    bloom = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    created = np.linspace(0.0, 365.0, n).astype(np.float32)
    valid = rng.random(n) > 0.05
    planes = dict(emb=q1, scale=s1, err=e1, emb2=q2, scale2=s2, err2=e2, bloom=bloom,
                  created=created, valid=valid, raw=raw)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_raw = (q * np.float32(1.7)).astype(np.float32)
    kw = np.where(rng.random((b, bits)) < 0.03, 0.05, 0).astype(np.float32)
    kw_b = np.zeros(b, np.float32)
    idxs = np.stack([rng.choice(n, size=m, replace=False).astype(np.int32) for _ in range(b)])
    idxs[1, 3] = -1  # an empty slot
    vals = np.sort(rng.uniform(0.3, 0.9, size=(b, m)).astype(np.float32), axis=1)[:, ::-1]
    vals_full = np.concatenate([vals, np.full((b, 1), 0.25, np.float32)], 1)
    idxs_full = np.concatenate([idxs, np.full((b, 1), -1, np.int32)], 1)

    jdev = JArrays(**{k: jnp.asarray(v) for k, v in planes.items()})
    j = [np.asarray(x) for x in jax_scorer.refine_select_dd(
        jdev, jnp.asarray(q), jnp.asarray(kw), jnp.asarray(kw_b), jnp.float32(365.0),
        jnp.asarray(vals_full), jnp.asarray(idxs_full), t_out=t_out, r=r,
        q_raw=jnp.asarray(q_raw))]
    tdev = DeviceArrays(**{k: row_sharding(mesh, torch.from_numpy(v)) for k, v in planes.items()})
    t = [x.numpy() for x in ShardedScorer(mesh).refine_select_dd(
        tdev, torch.from_numpy(q), torch.from_numpy(kw), torch.from_numpy(kw_b), 365.0,
        torch.from_numpy(vals_full), torch.from_numpy(idxs_full), t_out=t_out, r=r,
        q_raw=torch.from_numpy(q_raw))]
    jax.clear_caches()
    (jr, ju, jb, jh, jl, js), (tr, tu, tb, th, tl, ts) = j, t
    assert np.all(np.abs(ju.astype(np.float64) - tu) <= 1e-6)
    assert np.all(np.abs(jb.astype(np.float64) - tb) <= 1e-6)
    gaps = np.abs(np.diff(ju.astype(np.float64), axis=1))
    clear = np.ones_like(jr, dtype=bool)
    clear[:, 1:] &= gaps > 2e-6
    clear[:, :-1] &= gaps > 2e-6
    assert clear.mean() > 0.75
    assert np.array_equal(jr[clear], tr[clear])
    same = (jr == tr) & (jr >= 0) & (ju > -np.inf)
    assert np.array_equal(_bits(jh[same]), _bits(th[same]))
    assert np.array_equal(_bits(jl[same]), _bits(tl[same]))
    sj, st = js[same].astype(np.float64), ts[same].astype(np.float64)
    assert np.all(np.abs(sj - st) <= exact_cos.SABS_REL * np.abs(sj))


def test_sharded_engine_dtos_match_the_jax_sharded_engine(mesh):
    """The port's 8-shard xla engine and the JAX package's, built from the
    same records, serve the same DTOs."""
    from omni_recall_tpu.config import EngineOptions as JOptions
    from omni_recall_tpu.index.records import ChunkRecord as JChunk
    from omni_recall_tpu.index.records import DocumentRecord as JDoc
    from omni_recall_tpu.index.store import InMemoryIngestionStore as JStore
    from omni_recall_tpu.parallel.mesh import shards_mesh as jmesh
    from omni_recall_tpu.search.engine import RecallEngine as JEngine

    rng = random.Random(91)
    store = InMemoryIngestionStore()
    eng = RecallEngine(store, options=_xla_options(150, 8), mesh=mesh)
    vocab, chunks = _corpus(200, rng, store)
    eng.on_chunks_upserted(chunks, new=True)
    jstore = JStore()
    jstore.upsert_document(JDoc(id="d", file_name="d.txt", created_at_utc=T0))
    jchunks = [JChunk(id=c.id, document_id="d", chunk_index=c.chunk_index, content=c.content,
                      embedding=c.embedding, created_at_utc=c.created_at_utc) for c in chunks]
    jstore.upsert_chunks(jchunks)
    jeng = JEngine(jstore, options=JOptions(
        backend="xla", embedding_dim=DIM, capacity_block=128, recent_window=150,
        candidate_m=8, bloom_bits=256), mesh=jmesh(8))
    jeng.on_chunks_upserted(jchunks, new=True)
    reqs = []
    for _ in range(10):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        reqs.append((query, hash_embedder.embed_text(query, DIM), rng.choice([1, 5, 10])))
    for got, want in zip(eng.search_batch(reqs, now=NOW), jeng.search_batch(reqs, now=NOW)):
        assert [(h.chunk.id, round(h.score, 4)) for h in got] == \
            [(h.chunk.id, round(h.score, 4)) for h in want]


# -- the tools of row sharding, at CPU sizes --


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_check_tool_holds_parity(shards, capsys):
    from omni_recall_tpu_torch.tools import sharded_check

    line = sharded_check.main(["--device", "cpu", "--rows", "65536", "--shards", str(shards)])
    assert line["ok"] and line["shards"] == shards
    assert all(line[k]["ok"] for k in ("pallas_int8", "pallas_int8_coarse", "pallas_kw_only",
                                       "refine_select_dd"))
    if shards == 1:
        assert all(line[k]["rows_equal"] and line[k]["vals_equal"]
                   for k in ("pallas_int8", "pallas_int8_coarse", "pallas_kw_only"))
    else:
        assert line["pallas_int8"]["boundary_sound"]
    assert capsys.readouterr().out.rstrip().endswith("PARITY")


def test_probe_sharded_timing_tool_runs():
    from omni_recall_tpu_torch.tools import probe_sharded_timing

    line = probe_sharded_timing.main(["--device", "cpu", "--rows", "16384", "--shards", "4",
                                      "--batch", "8", "--m", "4", "--runs", "2"])
    assert line["shards"] == 4 and line["t"] == 1 and line["sub"] == 1024
    assert line["a_host_ms"] > 0 and line["m_device_ms"] > 0 and line["k1_unsharded_ms"] > 0


def test_sharded_snapshot_round_trip_and_rebuild(mesh, tmp_path):
    """A sharded int8 index saves its planes through the host quantizer
    and a sharded engine restores them by the slab route, padded to a
    shard-divisible capacity; both serve the oracle's DTOs, as does a
    rebuild (by upload: no device-side compaction on a mesh)."""
    from omni_recall_tpu_torch.index.snapshot import (
        load_snapshot_full,
        restore_engine,
        save_snapshot,
    )

    rng = random.Random(8)
    store = InMemoryIngestionStore()
    eng = RecallEngine(store, options=_dd_engine_opts(), mesh=mesh)
    vocab, chunks = _corpus(203, rng, store)
    eng.on_chunks_upserted(chunks, new=True)
    eng.device_index.device_arrays()
    save_snapshot(store, tmp_path / "snap", device_index=eng.device_index)
    restored, aux = load_snapshot_full(tmp_path / "snap")
    eng2 = RecallEngine(restored, options=_dd_engine_opts(), mesh=mesh)
    assert restore_engine(restored, eng2, aux=aux) == "slabs"
    dix = eng2.device_index
    assert dix.n_rows == 203 and dix._cap % 8 == 0 and not dix.valid[203:].any()
    oracle_eng = _oracle(store, 0)
    reqs = [(q, hash_embedder.embed_text(q, DIM), 5)
            for q in (" ".join(rng.choices(vocab, k=2)) for _ in range(10))]
    want = [_ids(h) for h in oracle_eng.search_batch(reqs, now=NOW)]
    assert [_ids(h) for h in eng2.search_batch(reqs, now=NOW)] == want
    assert eng.rebuild_index() == "upload"
    assert eng.device_index.mesh is mesh
    assert [_ids(h) for h in eng.search_batch(reqs, now=NOW)] == want


def test_sharded_index_from_a_single_device_index_by_the_slab_route(mesh):
    """``load_slabs`` on a mesh, fed a single-device index's mirrors and its
    quantized planes (chip_smoke.py's sharded path builds its 2^20-row
    engine so): the shards hold those planes' bits, and the engine serves
    the single-device engine's DTOs."""
    from omni_recall_tpu_torch.index.device_index import _QUANT_PLANES

    rng = random.Random(12)
    store = InMemoryIngestionStore()
    single = RecallEngine(store, options=_dd_engine_opts(), device="cpu")
    vocab, chunks = _corpus(256, rng, store)
    single.on_chunks_upserted(chunks, new=True)
    one = single.device_index
    planes = one.device_arrays()
    n = one.n_rows
    sh = RecallEngine(InMemoryIngestionStore(), options=_dd_engine_opts(), mesh=mesh)
    sh.device_index.load_slabs(
        one.meta[:n], emb_norm=one.emb[:n], raw_emb=one.raw_emb[:n],
        raw_norm_sq=one.raw_norm_sq[:n], bloom=one.bloom[:n], created=one.created[:n],
        created_us=one.created_us[:n], created_ts=one.created_ts[:n], seqs=one.seqs[:n],
        lower_arena=bytes(one._arena), lower_off=one.content_off[:n + 1],
        converted={k: getattr(planes, k)[:n].numpy() for k in _QUANT_PLANES})
    dev_s = sh.device_index.device_arrays()
    for k in _QUANT_PLANES + ("raw", "bloom", "valid"):
        got = torch.cat(getattr(dev_s, k).shards)
        assert torch.equal(got, getattr(planes, k)[:n]), k
    reqs = []
    for _ in range(16):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        reqs.append((query, hash_embedder.embed_text(query, DIM) if rng.random() > 0.2 else [],
                     5))
    want = single.search_batch(reqs, now=NOW)
    got = sh.search_batch(reqs, now=NOW)
    assert [[(h.chunk.id, h.score) for h in x] for x in got] == \
        [[(h.chunk.id, h.score) for h in x] for x in want]
