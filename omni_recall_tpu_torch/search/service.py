"""Recall search service — the /api/recall/search domain logic.

Mirrors RecallSearchService.SearchAsync
(src/OmniRecall.Api/Services/RecallSearchService.cs:20-57): embed the query,
score candidates (delegated to the certified-exact engine), join documents
for file names ("unknown" when missing, :47), build citations with 180-char
snippets and the score rounded to 4 decimals (banker's rounding, like
C# Math.Round default) at the DTO edge (:41-54).
"""

from __future__ import annotations

from datetime import datetime

from omni_recall_tpu_torch.contracts import RecallCitation, RecallSearchResponse
from omni_recall_tpu_torch.search.engine import RecallEngine
from omni_recall_tpu_torch.snippets import SEARCH_SNIPPET_LEN, build_snippet


class RecallSearchService:
    def __init__(
        self, engine: RecallEngine, embedding_client, executor=None,
        device_query: bool = False,
    ) -> None:
        self.engine = engine
        self.embedding_client = embedding_client
        # optional CoalescingSearchExecutor: concurrent requests share scans
        self.executor = executor
        # device-resident query pipeline: skip the host embed round trip and
        # let the engine embed the (coalesced) batch on device — no
        # per-query vector upload (engine.attach_device_embedder)
        self.device_query = device_query

    def search(self, query: str, top_k: int, now: datetime | None = None) -> RecallSearchResponse:
        if not query or not query.strip():
            raise ValueError("Query is required.")

        vector = None
        if not self.device_query:
            vector = self.embedding_client.embed(query).vector
        if self.executor is not None:
            hits = self.executor.search(query, vector, top_k, now=now)
        else:
            hits = self.engine.search(query, vector, top_k, now=now)

        doc_ids = list(dict.fromkeys(h.chunk.document_id for h in hits))
        documents = self.engine.store.get_documents_by_ids(doc_ids)

        citations = []
        for hit in hits:
            doc = documents.get(hit.chunk.document_id)
            citations.append(
                RecallCitation(
                    document_id=hit.chunk.document_id,
                    file_name=doc.file_name if doc is not None else "unknown",
                    chunk_id=hit.chunk.id,
                    chunk_index=hit.chunk.chunk_index,
                    snippet=build_snippet(hit.chunk.content, SEARCH_SNIPPET_LEN),
                    score=round(hit.score, 4),
                    created_at_utc=hit.chunk.created_at_utc,
                )
            )
        return RecallSearchResponse(query, citations)
