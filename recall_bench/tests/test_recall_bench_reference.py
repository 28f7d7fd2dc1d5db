"""The plain reference against the port's ``backend="oracle"`` engine (the
reference implementation's scoring loop), and the control against both."""

import numpy as np

from recall_bench import check, corpus, generator
from recall_bench.load import Answers
from recall_bench.reference import Reference

SPEC = {"rows": 4096, "dim": 64, "rows_per_cluster": 64, "min_clusters": 16,
        "noise_rows": 4096, "amp_center": 90, "amp_noise": 22, "spread": True, "days": 365.0}
TRAFFIC = {"requests": 24, "embedding": "near_center", "noise": 0.2, "text": "cluster_token",
           "kw_frac": 0.75, "top_k": 10}


def oracle_engine(c):
    from datetime import datetime, timedelta, timezone

    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index.records import DocumentRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine
    from omni_recall_tpu_torch.tools import e2e_engine

    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="synthetic", file_name="s.txt", chunk_count=c.n))
    store.upsert_chunks(e2e_engine.records(c.n, c.emb, c.assign, c.contents, c.created_days))
    eng = RecallEngine(store, options=EngineOptions(backend="oracle", recent_window=0,
                                                    embedding_dim=c.emb.shape[1]), device="cpu")
    now = datetime(2024, 1, 1, tzinfo=timezone.utc) + timedelta(days=c.days)
    return eng, now


def test_reference_serves_the_oracles_answers():
    c = corpus.make_corpus(SPEC, 11)
    pool = generator.make_requests(TRAFFIC, c, 11)
    assert any(t == "" for t, _, _ in pool) and any(t for t, _, _ in pool)
    eng, now = oracle_engine(c)
    want = eng.search_batch(pool, now=now)
    ref = Reference(c)
    got = ref.top_k([(t, q) for t, q, _ in pool], 10)
    for hits, (rows, scores) in zip(want, got):
        assert [h.chunk.id for h in hits] == [f"s:{r}" for r in rows]
        assert np.max(np.abs(np.array([h.score for h in hits]) - scores)) <= 1e-12
    # the pair scores are the same numbers
    q = np.repeat(np.arange(len(pool)), 10)
    rows = np.concatenate([r for r, _ in got])
    exact = ref.pair_scores([(t, e) for t, e, _ in pool], q, rows)
    assert np.max(np.abs(exact - np.concatenate([s for _, s in got]))) <= 1e-15


def test_control_fails_the_comparison():
    """float32 in the reference's place: the numbers that decide ``correct``
    read far above the limits (the configuration states f64)."""
    c = corpus.make_corpus(SPEC, 12)
    pool = generator.make_requests(TRAFFIC, c, 12)
    ref = Reference(c)
    reqs = [(t, q) for t, q, _ in pool]
    expected = dict(enumerate(ref.top_k(reqs, 10)))
    answers = Answers(10)
    for i, (rows, scores) in enumerate(ref.control_top_k(reqs, 10)):
        answers.add(i, 0.0, 0.0, rows, scores, None)
    cols = answers.columns()
    limits = {"row_gap": 1e-10, "rank_gap": 1e-10, "unanswered": 0.0}
    values = {"row_gap": check.row_gap(ref, reqs, cols, 10),
              "rank_gap": check.rank_gap(expected, cols, 10), "unanswered": 0.0}
    correct, checks = check.judge(values, limits)
    assert not correct
    assert values["row_gap"] > 1e-8 and values["rank_gap"] > 1e-8
    # the reference in its own place reads nothing
    answers = Answers(10)
    for i, (rows, scores) in expected.items():
        answers.add(i, 0.0, 0.0, rows, scores, None)
    cols = answers.columns()
    assert check.row_gap(ref, reqs, cols, 10) <= 1e-15
    assert check.rank_gap(expected, cols, 10) == 0.0
