"""Shared synthetic eval corpus + auto-generated case set (PyTorch port of
omni_recall_tpu/eval/corpus.py: the same seeded corpus, texts and hash
embeddings).

One corpus definition feeds BOTH campaigns so their numbers are
comparable:
- the recall@10 *parity* campaign (tests/test_torch_eval_parity.py): oracle vs
  pallas+int8 bit-identical DTOs,
- the retrieval *quality* campaign (eval/quality.py): recall@10 per
  embedding provider.

Corpus shape: n_docs documents, each with a distinct topic phrase leading
its chunks plus shared vocabulary — real signal and real confusion. Case
auto-generation mirrors the reference eval page's 3 question templates per
document (src/OmniRecall.App/src/app/pages/eval/eval.page.ts:483-515).
"""

from __future__ import annotations

import random
import string
from datetime import datetime, timedelta, timezone
from typing import Callable

from omni_recall_tpu_torch.eval.harness import EvalCase, to_topic
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
from omni_recall_tpu_torch.models import hash_embedder

DIM = 64
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


def build_corpus(
    n_docs: int = 70,
    chunks_per_doc: int = 6,
    embed: Callable[[str], list[float]] | None = None,
    dim: int = DIM,
) -> tuple[InMemoryIngestionStore, list[ChunkRecord]]:
    """Deterministic corpus (seeded); ``embed`` defaults to the hash
    embedder at ``dim``. Passing a different embed fn re-embeds the SAME
    texts — provider comparisons hold the corpus fixed."""
    if embed is None:
        embed = lambda text: hash_embedder.embed_text(text, dim)  # noqa: E731
    rng = random.Random(20260816)
    shared = [
        "".join(rng.choices(string.ascii_lowercase, k=rng.randint(3, 9)))
        for _ in range(120)
    ]
    store = InMemoryIngestionStore()
    all_chunks: list[ChunkRecord] = []
    for di in range(n_docs):
        doc_id = f"doc_{di:03d}"
        fname = f"notes-{di:03d}.md"
        topic = f"subject{di:03d} " + " ".join(rng.choices(shared, k=2))
        created = T0 + timedelta(hours=di)
        store.upsert_document(
            DocumentRecord(
                id=doc_id, file_name=fname, created_at_utc=created,
                chunk_count=chunks_per_doc,
            )
        )
        for ci in range(chunks_per_doc):
            body = " ".join(rng.choices(shared, k=rng.randint(10, 35)))
            content = f"{topic}. {body}" if ci == 0 else f"{topic} {body}"
            chunk = ChunkRecord(
                id=f"{doc_id}:{ci:04d}", document_id=doc_id, chunk_index=ci,
                content=content,
                embedding=embed(content),
                created_at_utc=created + timedelta(minutes=ci),
            )
            all_chunks.append(chunk)
        store.upsert_chunks(all_chunks[-chunks_per_doc:])
    return store, all_chunks


def generate_cases(store: InMemoryIngestionStore, min_cases: int = 200) -> list[EvalCase]:
    """3 question templates per document from the first chunk's leading
    sentence topic (eval.page.ts:483-515)."""
    cases = []
    for doc in store.list_documents(10**6):
        chunks = sorted(
            store.get_chunks_by_document_id(doc.id), key=lambda c: c.chunk_index
        )
        if not chunks:
            continue
        topic = to_topic(chunks[0].content)
        for template in (
            f"What does the document say about {topic}?",
            f"Summarize the key points about {topic}.",
            f"Which details are recorded about {topic}?",
        ):
            cases.append(
                EvalCase(question=template, expected_file=doc.file_name, top_k=10)
            )
    assert len(cases) >= min_cases, f"only {len(cases)} cases generated"
    return cases


def parity_campaign(
    options,
    device="cuda",
    dim: int = DIM,
    min_cases: int = 200,
) -> dict:
    """The recall@10 parity campaign: the generated cases over the corpus at
    ``dim``, each searched through a device engine with ``options`` and
    through the float64 oracle, both behind the search service on one
    store at the frozen ``NOW``. Returns {cases, hits, hit_rate,
    mismatches: [(question, oracle's first two, device's first two)],
    oracle: [each case's oracle citations as dicts]}; CUDA unless the CPU
    is asked."""
    from dataclasses import asdict

    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.ingest.embedding import HashEmbeddingClient
    from omni_recall_tpu_torch.search.engine import RecallEngine
    from omni_recall_tpu_torch.search.service import RecallSearchService

    store, chunks = build_corpus(dim=dim)
    provider = HashEmbeddingClient(dim)
    oracle_engine = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=0), device=device
    )
    device_engine = RecallEngine(store, options=options, device=device)
    device_engine.on_chunks_upserted(chunks, new=True)
    svc_oracle = RecallSearchService(oracle_engine, provider)
    svc_device = RecallSearchService(device_engine, provider)

    cases = generate_cases(store, min_cases=min_cases)
    hits = 0
    mismatches = []
    oracle = []
    for case in cases:
        want = [asdict(c) for c in svc_oracle.search(case.question, case.top_k, now=NOW).citations]
        got = [asdict(c) for c in svc_device.search(case.question, case.top_k, now=NOW).citations]
        if want != got:
            mismatches.append((case.question, want[:2], got[:2]))
        hits += any(c["file_name"] == case.expected_file for c in want)
        oracle.append(want)
    return {"cases": len(cases), "hits": hits, "hit_rate": hits / len(cases),
            "mismatches": mismatches, "oracle": oracle}
