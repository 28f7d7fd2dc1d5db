"""The port's span recorder (omni_recall_tpu_torch/utils/tracing.py) on the
CPU: off it records nothing, installs nothing and allocates nothing; on, the
coalescer's pipelined path records every span of the served path under its
batch's number and its parent, across the dispatcher and the finalize
worker; the collector's passes, overflow, many threads; and the engine's
per-batch counts, added to ``stats`` once a batch under one lock."""

import gc
import random
import string
import sys
import threading
import tracemalloc
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor
from omni_recall_tpu_torch.search.engine import RecallEngine
from omni_recall_tpu_torch.utils import tracing

DIM = 32
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
OPTS = dict(backend="pallas", scan_dtype="int8", embedding_dim=DIM, capacity_block=1024,
            candidate_m=16, bloom_bits=256, recent_window=0, device_exact_cos=True,
            direct_select=True, refine=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def served():
    """A small int8 index with the headline options, and requests of every
    kind: vector and text (the coarse prepass), text only (the keyword
    scan), and a vector of another width (the exact host scan)."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((12, DIM)).astype(np.float32)
    words = ["".join(random.Random(i).choices(string.ascii_lowercase, k=6))
             for i in range(12)]
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = []
    for i in range(600):
        c = i % 12
        v = centers[c] + 0.3 * rng.standard_normal(DIM).astype(np.float32)
        chunks.append(ChunkRecord(id=f"d:{i:05d}", document_id="d", chunk_index=i,
                                  content=f"topic {words[c]} row{i}",
                                  embedding=v.tolist(),
                                  created_at_utc=T0 + timedelta(minutes=i)))
    store.upsert_chunks(chunks)
    engine = RecallEngine(store, None, EngineOptions(**OPTS), device="cpu")
    engine.on_chunks_upserted(chunks, new=True)
    reqs = [(f"topic {words[i % 12]}", (centers[i % 12] + 0.05).tolist(), 5)
            for i in range(24)]
    reqs += [(f"topic {words[i]}", None, 4) for i in range(4)]
    reqs += [("topic", [1.0] * (DIM + 1), 3)]
    return engine, reqs


def _serve(engine, reqs, max_batch=8):
    ex = CoalescingSearchExecutor(engine, max_batch=max_batch, window_ms=5.0)
    out = [None] * len(reqs)

    def run(i, req):
        out[i] = ex.search(*req, now=NOW)

    threads = [threading.Thread(target=run, args=(i, r)) for i, r in enumerate(reqs)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        ex.close()
    return out


def test_off_records_nothing_and_installs_no_callback(served):
    engine, reqs = served
    callbacks = list(gc.callbacks)
    assert not tracing.enabled()
    assert tracing.span(tracing.DISPATCH) is tracing.NOOP
    assert tracing.new_batch() == -1
    _serve(engine, reqs[:6])
    gc.collect()
    assert tracing.records() == {} and tracing.totals() == {} and tracing.dropped() == 0
    assert gc.callbacks == callbacks
    tracing.enable(64)
    assert len(gc.callbacks) == len(callbacks) + 1
    tracing.disable()
    assert gc.callbacks == callbacks and tracing.records() == {}


def test_noop_span_sites_allocate_nothing():
    """Every kind of span site, off, allocates no memory."""
    def sites(n):
        for _ in range(n):
            with tracing.span(tracing.DISPATCH) as sp:
                sp.step(tracing.PREP)
                sp.step(tracing.UPLOAD)
                if sp:
                    sp.set(1000, 2000, 3000)
                sp.set(3, 2, 1)
            with tracing.span(tracing.FINALIZE, 7) as sp:
                with tracing.span(tracing.WAIT):
                    pass
            tracing.add(tracing.FINALIZE_QUEUE, 0.5, 7)
            tracing.new_batch()

    sites(10)  # warm every code path
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites(5000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, __file__)
    mod = tracemalloc.Filter(True, tracing.__file__)
    grown = [d for d in after.filter_traces([here, mod]).compare_to(
        before.filter_traces([here, mod]), "lineno") if d.size_diff > 0]
    assert grown == []


def _rows(rec, name):
    return np.flatnonzero(rec["name"] == tracing.NAMES.index(name))


def test_pipelined_batches_record_every_span(served):
    engine, reqs = served
    stats0 = dict(engine.stats)
    tracing.enable()
    got = _serve(engine, reqs)
    rec = tracing.records()
    totals = tracing.totals()
    tracing.disable()
    assert all(g is not None for g in got)
    assert rec["dropped"] == 0 and not np.isnan(rec["end"]).any()
    assert (rec["end"] >= rec["start"]).all() and (rec["cpu"] >= 0).all()
    names = np.asarray(tracing.NAMES)[rec["name"]]
    threads = {v: k for k, v in rec["threads"].items()}
    disp, fin = threads["search-coalescer"], threads["search-finalize_0"]
    by_name = {n: _rows(rec, n) for n in tracing.NAMES}

    def one(name, batch):
        rows = [r for r in by_name[name] if rec["batch"][r] == batch]
        assert len(rows) == 1, (name, batch, rows)
        return rows[0]

    dispatches = by_name["engine.dispatch"]
    assert len(dispatches) >= len(reqs) // 8
    batches = rec["batch"][dispatches]
    assert len(set(batches.tolist())) == len(batches) and (batches >= 0).all()
    for d in dispatches:
        b = rec["batch"][d]
        collect, wait = one("coalesce.collect", b), one("coalesce.inflight_wait", b)
        queued, f, resolve = (one("coalesce.finalize_queue", b), one("engine.finalize", b),
                              one("coalesce.resolve", b))
        assert (rec["thread"][[collect, wait, d]] == disp).all()
        assert (rec["thread"][[queued, f, resolve]] == fin).all()
        assert (rec["parent"][[collect, wait, d, queued, f, resolve]] == -1).all()
        # in time: collect, wait, dispatch; queued from the dispatch's end
        assert rec["end"][collect] <= rec["start"][wait] <= rec["end"][wait] <= rec["start"][d]
        assert rec["end"][d] <= rec["start"][queued] <= rec["end"][queued] <= rec["start"][f]
        assert rec["end"][f] <= rec["start"][resolve]
        assert rec["cpu"][queued] == 0.0
        steps = [one(n, b) for n in ("dispatch.prep", "dispatch.upload", "dispatch.launch")]
        assert (rec["parent"][steps] == d).all()
        assert rec["start"][steps[0]] <= rec["end"][steps[0]] <= rec["start"][steps[1]]
        fill, cap, backlog = rec["attrs"][collect, :3]
        assert 1 <= fill <= cap == 8 and backlog >= 0
        assert rec["attrs"][d, 0] <= fill
    for name in ("finalize.wait", "finalize.rescore", "finalize.certify", "finalize.rescue",
                 "finalize.host_scan", "scan.k1"):
        rows = by_name[name]
        assert len(rows), name
        for r in rows:
            # the span's ancestors on its thread reach its batch's root span
            root = r
            while rec["parent"][root] >= 0:
                p = rec["parent"][root]
                assert rec["thread"][p] == rec["thread"][r] and rec["batch"][p] == rec["batch"][r]
                assert rec["start"][p] <= rec["start"][r] and rec["end"][r] <= rec["end"][p]
                root = p
            want = "engine.dispatch" if name == "scan.k1" else "engine.finalize"
            assert names[root] == want, (name, names[root])
    k1 = by_name["scan.k1"]
    assert (names[rec["parent"][k1]] == "dispatch.launch").all()
    n, d = rec["attrs"][k1[0], :2]
    assert n >= 600 and d == DIM
    # the query tile of the kernel that ran: none on the CPU (the plain version)
    assert (rec["attrs"][k1, 5] == 0).all()
    # the finalize spans carry their batch's own counts; the engine's totals
    # grew by their sums
    f_rows = by_name["engine.finalize"]
    keys = ("escalation_rounds_total", "host_fallbacks_total", "dd_escalations_total",
            "rescue_wide_total", "rescue_sliced_total", "rescore_pairs_total")
    for j, key in enumerate(keys):
        assert rec["attrs"][f_rows, j].sum() == engine.stats[key] - stats0[key], key
    assert engine.stats["host_fallbacks_total"] > stats0["host_fallbacks_total"]
    assert rec["attrs"][dispatches, 0].sum() == len(reqs)
    assert rec["attrs"][dispatches, 1].sum() == 1   # the one vector of another width
    assert engine.stats["searches_total"] - stats0["searches_total"] == len(reqs)
    # the totals count what the rows hold
    for name, rows in by_name.items():
        if len(rows):
            c, wall, cpu = totals[name]
            assert c == len(rows)
            assert wall == pytest.approx(float(np.sum(rec["end"][rows] - rec["start"][rows])))


def test_a_collector_pass_is_a_span():
    tracing.enable(1024)
    with tracing.span(tracing.FINALIZE, 3):
        gc.collect()
    rec = tracing.records()
    tracing.disable()
    passes = _rows(rec, "runtime.gc")
    full = [r for r in passes if rec["attrs"][r, 0] == 2]
    assert full and not np.isnan(rec["end"][full]).any()
    outer = _rows(rec, "engine.finalize")[0]
    assert rec["parent"][full[0]] == outer and rec["batch"][full[0]] == -1
    assert rec["attrs"][full[0], 1] >= 0


def test_overflow_counts_into_dropped():
    tracing.enable(4)
    for _ in range(3):
        with tracing.span(tracing.DISPATCH):
            with tracing.span(tracing.WAIT):
                pass
    rec = tracing.records()
    assert rec["dropped"] == 2 and tracing.dropped() == 2
    assert len(rec["name"]) == 4 and (rec["name"] >= 0).all()
    # the totals count on past the capacity
    assert tracing.totals()["engine.dispatch"][0] == 3
    assert tracing.totals()["finalize.wait"][0] == 3


def test_spans_from_many_threads_nest_on_their_own_thread():
    """More threads than cores, switching every few microseconds, with the
    collector running: every span's parent is on its own thread and
    encloses it, batches follow their parents, and no count is lost."""
    n_threads, n_iter = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable(n_threads * n_iter * 4)
    try:
        def work():
            b = tracing.new_batch()
            for i in range(n_iter):
                with tracing.span(tracing.FINALIZE) as sp:
                    assert sp.batch == b
                    with tracing.span(tracing.RESCORE):
                        [object() for _ in range(50)]
                    sp.step(tracing.CERTIFY)
                    if i % 100 == 0:
                        gc.collect(0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        rec = tracing.records()
        totals = tracing.totals()
    finally:
        sys.setswitchinterval(old)
        tracing.disable()
    assert rec["dropped"] == 0
    fin = _rows(rec, "engine.finalize")
    assert len(fin) == totals["engine.finalize"][0] == n_threads * n_iter
    assert len(set(rec["batch"][fin].tolist())) == n_threads
    kids = np.flatnonzero(rec["parent"] >= 0)
    par = rec["parent"][kids]
    assert (rec["thread"][par] == rec["thread"][kids]).all()
    assert (rec["start"][par] <= rec["start"][kids]).all()
    assert (rec["end"][kids] <= rec["end"][par]).all()
    inner = kids[rec["name"][kids] != tracing.GC]
    assert (rec["batch"][inner] == rec["batch"][rec["parent"][inner]]).all()
    for name in ("finalize.rescore", "finalize.certify"):
        rows = _rows(rec, name)
        assert len(rows) == n_threads * n_iter
        assert (rec["name"][rec["parent"][rows]] == tracing.FINALIZE).all()


def test_concurrent_batches_lose_no_count(served):
    """search_batch from more threads than cores: every batch's counts reach
    ``stats`` (added once a batch under the engine's lock)."""
    engine, reqs = served
    stats0 = dict(engine.stats)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=engine.search_batch, args=(reqs[i::8],),
                                    kwargs={"now": NOW}) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert engine.stats["searches_total"] - stats0["searches_total"] == len(reqs)
    assert engine.stats["host_fallbacks_total"] > stats0["host_fallbacks_total"]


@pytest.mark.parametrize("capacity", [0, 64])
def test_ended_threads_fold_into_the_totals(capacity):
    """A thread a request, as the server runs them: each ended thread's
    totals join the shared ones and its state is let go, so the recorder
    holds as many threads as are alive, whatever has been served. With no
    rows (``enable(0)``, the server's mode) nothing counts as dropped."""
    tracing.enable(capacity)
    gc.disable()   # no collector pass between the readings below
    try:
        live = tracing._rec.threads.live

        def request():
            with tracing.span(tracing.DISPATCH):
                with tracing.span(tracing.WAIT):
                    pass

        request()   # this thread's state, which lives on
        for _ in range(50):
            threads = [threading.Thread(target=request) for _ in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert len(live) <= 9
        gc.collect()
        assert len(live) == 1
        totals = tracing.totals()
        assert totals["engine.dispatch"][0] == totals["finalize.wait"][0] == 401
        rec = tracing.records()
        assert len(rec["name"]) == capacity
        opened = sum(c for c, _, _ in tracing.totals().values())   # with the collector's
        assert tracing.dropped() == rec["dropped"] == (opened - capacity if capacity else 0)
    finally:
        gc.enable()
        tracing.disable()


def test_a_disabled_recorder_is_freed():
    """``disable`` lets go of the rows even while threads that recorded into
    them live on (the finalizers of their state hold no recorder)."""
    import weakref

    tracing.enable(16)
    rec = weakref.ref(tracing._rec)
    with tracing.span(tracing.DISPATCH):
        pass
    tracing.disable()
    gc.collect()
    assert rec() is None
