"""Document ingestion pipeline.

Behavioral mirror of the reference's DocumentIngestionService
(src/OmniRecall.Api/Services/DocumentIngestionService.cs):

- CRLF -> LF normalization + trim (:83),
- SHA-256 lowercase-hex content hash (:293-297),
- dedupe by scanning up to 1000 documents for an equal hash — hit returns the
  existing document with NO re-embedding (:85-100, :299-307),
- raw save, sliding-window chunking (:104-109),
- bounded-parallel embedding, clamp(parallelism, 1, 8); a per-chunk embedding
  failure is recorded as an error result and never aborts the ingest
  (:309-363),
- chunk ids ``{docId}:{index:04d}``, doc ids ``doc_{uuid hex}`` (:103, :127),
- reindex re-embeds all chunks in chunk-index order with per-status counters,
  keeping the old vector unless the new embed fully succeeded (:220-291),
- ``train_embedder`` (new scope): fine-tunes the local encoder on the
  corpus, swaps it in and reindexes every document.

TPU deviation (documented): created_at_utc is stamped under the index append
lock rather than before embedding, so device index row order is exactly
(created_at, seq) order — which makes the reference's "300 most recent"
candidate window a row-range mask on device (see index/device_index.py).
"""

from __future__ import annotations

import hashlib
import logging
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timezone

from omni_recall_tpu_torch.chunking import chunk_text
from omni_recall_tpu_torch.config import IngestionOptions
from omni_recall_tpu_torch.contracts import (
    DocumentChunkPreview,
    DocumentDetails,
    DocumentListItem,
    ReindexDocumentResponse,
    TrainEncoderResponse,
    UploadDocumentResponse,
)
from omni_recall_tpu_torch.device import is_device_error
from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu_torch.ingest.embedding import EmbeddingResult, EmbeddingStatus
from omni_recall_tpu_torch.snippets import PREVIEW_SNIPPET_LEN, build_snippet

logger = logging.getLogger(__name__)


class IngestionError(ValueError):
    pass


class DocumentIngestionService:
    def __init__(
        self,
        store,
        raw_store,
        embedding_client,
        options: IngestionOptions | None = None,
        engine=None,
    ) -> None:
        self.store = store
        self.raw_store = raw_store
        self.embedding_client = embedding_client
        self.options = options or IngestionOptions()
        self.engine = engine
        # Share the engine's mutation lock when present so store upsert +
        # index append is atomic w.r.t. the engine's shadow rebuild_index
        # (see RecallEngine.rebuild_index); standalone use keeps a local lock.
        self._append_lock = (
            engine.mutation_lock if engine is not None
            and hasattr(engine, "mutation_lock") else threading.Lock()
        )

    # -- ingest --

    def ingest(self, file_name: str, content: str, source_type: str) -> UploadDocumentResponse:
        if not file_name or not file_name.strip():
            raise IngestionError("File name is required.")
        if not content or not content.strip():
            raise IngestionError("Content is required.")

        normalized = content.replace("\r\n", "\n").strip()
        content_hash = hashlib.sha256(normalized.encode("utf-8")).hexdigest()
        existing = self._find_existing_by_hash(content_hash)
        if existing is not None:
            logger.info(
                "Deduplicated ingest for %s; returning existing document %s.",
                file_name, existing.id,
            )
            return UploadDocumentResponse(
                existing.id, existing.file_name, existing.source_type,
                existing.blob_path, existing.chunk_count, existing.content_hash,
                existing.created_at_utc,
            )

        document_id = f"doc_{uuid.uuid4().hex}"
        blob_path = self.raw_store.save(file_name, normalized, content_hash)

        chunk_texts = chunk_text(
            normalized, self.options.chunk_size_words, self.options.chunk_overlap_words
        )
        if not chunk_texts:
            raise IngestionError("No chunks produced for document.")

        embeddings = self._embed_texts(chunk_texts, context_id=file_name, operation="ingest")

        with self._append_lock:
            # re-check the dedupe under the lock: two concurrent uploads of
            # identical content both pass the pre-embedding check (the
            # window spans the slow embed call); the loser returns the
            # winner's document instead of creating a duplicate
            existing = self._find_existing_by_hash(content_hash)
            if existing is not None:
                logger.info(
                    "Deduplicated ingest for %s after concurrent upload; "
                    "returning existing document %s.", file_name, existing.id,
                )
                return UploadDocumentResponse(
                    existing.id, existing.file_name, existing.source_type,
                    existing.blob_path, existing.chunk_count,
                    existing.content_hash, existing.created_at_utc,
                )
            created_at = datetime.now(timezone.utc)
            chunks = [
                ChunkRecord(
                    id=f"{document_id}:{index:04d}",
                    document_id=document_id,
                    chunk_index=index,
                    content=text,
                    embedding=list(embeddings[index].vector) or None,
                    created_at_utc=created_at,
                )
                for index, text in enumerate(chunk_texts)
            ]
            document = DocumentRecord(
                id=document_id,
                file_name=file_name,
                source_type=source_type,
                blob_path=blob_path,
                content_hash=content_hash,
                chunk_count=len(chunk_texts),
                created_at_utc=created_at,
            )
            self.store.upsert_document(document)
            self.store.upsert_chunks(chunks)
            if self.engine is not None:
                self.engine.on_chunks_upserted(chunks, new=True)

        logger.info("Ingested document %s (%d chunks).", document_id, len(chunk_texts))
        return UploadDocumentResponse(
            document_id, file_name, source_type, blob_path,
            len(chunk_texts), content_hash, created_at,
        )

    # -- reads --

    def get_document(self, document_id: str) -> DocumentDetails | None:
        doc = self.store.get_document(document_id)
        if doc is None:
            return None
        return DocumentDetails(
            doc.id, doc.file_name, doc.source_type, doc.blob_path,
            doc.chunk_count, doc.content_hash, doc.created_at_utc,
        )

    def list_documents(self, max_count: int) -> list[DocumentListItem]:
        docs = self.store.list_documents(max_count)
        return [
            DocumentListItem(d.id, d.file_name, d.source_type, d.chunk_count, d.created_at_utc)
            for d in docs
        ]

    def get_document_chunks(self, document_id: str, max_count: int) -> list[DocumentChunkPreview]:
        chunks = sorted(
            self.store.get_chunks_by_document_id(document_id), key=lambda c: c.chunk_index
        )
        return [
            DocumentChunkPreview(
                c.id, c.chunk_index,
                build_snippet(c.content, PREVIEW_SNIPPET_LEN),
                bool(c.embedding),
                c.created_at_utc,
            )
            for c in chunks[: max(1, max_count)]
        ]

    def delete_document(self, document_id: str) -> bool:
        existing = self.store.get_document(document_id)
        if existing is None:
            return False
        with self._append_lock:
            self.store.delete_document(document_id)
            if self.engine is not None:
                self.engine.on_document_deleted(document_id)
        return True

    # -- reindex --

    def reindex_document(self, document_id: str) -> ReindexDocumentResponse | None:
        document = self.store.get_document(document_id)
        if document is None:
            return None
        chunks = sorted(
            self.store.get_chunks_by_document_id(document_id), key=lambda c: c.chunk_index
        )
        reindexed_at = datetime.now(timezone.utc)
        if not chunks:
            return ReindexDocumentResponse(document_id, 0, 0, 0, 0, 0, reindexed_at)

        embeddings = self._embed_texts(
            [c.content for c in chunks], context_id=document_id, operation="reindex"
        )

        embedded = rate_limited = empty = failed = 0
        updated: list[ChunkRecord] = []
        for chunk, result in zip(chunks, embeddings):
            new_vector = chunk.embedding
            if result.status == EmbeddingStatus.SUCCESS and len(result.vector) > 0:
                embedded += 1
                new_vector = list(result.vector)
            elif result.status == EmbeddingStatus.RATE_LIMITED:
                rate_limited += 1
            elif result.status == EmbeddingStatus.ERROR:
                failed += 1
            else:
                empty += 1
            updated.append(
                ChunkRecord(
                    id=chunk.id,
                    document_id=chunk.document_id,
                    chunk_index=chunk.chunk_index,
                    content=chunk.content,
                    embedding=new_vector,
                    created_at_utc=chunk.created_at_utc,
                    partition_key=chunk.partition_key,
                    seq=chunk.seq,
                )
            )

        with self._append_lock:
            # re-check under the lock: a concurrent DELETE during the slow
            # embed phase must win — upserting now would resurrect the
            # deleted document's chunks as permanent orphans (no
            # DocumentRecord -> undeletable via the API)
            if self.store.get_document(document_id) is None:
                logger.info(
                    "Document %s was deleted during reindex; discarding "
                    "re-embedded chunks.", document_id,
                )
                return None
            self.store.upsert_chunks(updated)
            if self.engine is not None:
                self.engine.on_chunks_upserted(updated, new=False)

        return ReindexDocumentResponse(
            document_id, len(updated), embedded, rate_limited, empty, failed, reindexed_at
        )

    # -- train (new scope: the corpus-trained local encoder) --

    def train_embedder(self, steps: int = 300, seed: int = 0) -> TrainEncoderResponse | None:
        """Fine-tune the LOCAL encoder on the ingested corpus and re-embed
        everything with it (JAX ingest/service.py ``train_embedder``).

        Gather every chunk's content from the store, fine-tune from the
        seed init with the inverse-cloze objective (models/finetune.py) on
        the client's device, hot-swap the client's weights, then reindex
        every document so the stored vectors agree with the new encoder
        (the reference's reindex re-embed + swap,
        DocumentIngestionService.cs:220-291). A document deleted while the
        encoder trains is skipped. Searches racing the reindex may mix
        old-encoder rows with new-encoder queries: a quality blip only, the
        engine's certificate is relative to the stored vectors.

        Returns None when the embedding provider is not trainable (the
        route maps that to 409); raises IngestionError on an empty corpus.
        """
        client = self.embedding_client
        if not hasattr(client, "swap_params") or not hasattr(client, "cfg"):
            return None
        documents = self.store.list_documents(2**31 - 1)
        contents = [c.content for d in documents
                    for c in self.store.get_chunks_by_document_id(d.id)]
        if not contents:
            raise IngestionError("No ingested content to train on.")
        from omni_recall_tpu_torch.models.finetune import inverse_cloze_finetune

        steps = max(1, int(steps))
        logger.info("training local encoder: %d chunks, %d steps", len(contents), steps)
        params = inverse_cloze_finetune(contents, client.cfg, steps=steps, seed=seed,
                                        device=client.device)
        client.swap_params(params, tag=f"trained-{steps}")
        doc_count = chunk_count = embedded = failed = 0
        for d in documents:
            result = self.reindex_document(d.id)
            if result is None:  # deleted mid-train
                continue
            doc_count += 1
            chunk_count += result.chunk_count
            embedded += result.embedded_count
            failed += result.failed_count
        logger.info("local encoder trained + corpus re-embedded: %d documents, %d chunks, "
                    "%d embedded", doc_count, chunk_count, embedded)
        return TrainEncoderResponse(doc_count, chunk_count, embedded, failed, steps,
                                    client.model, datetime.now(timezone.utc))

    # -- internals --

    def _find_existing_by_hash(self, content_hash: str) -> DocumentRecord | None:
        for doc in self.store.list_documents(1000):
            if doc.content_hash.lower() == content_hash.lower():
                return doc
        return None

    def _embed_texts(
        self, texts: list[str], context_id: str, operation: str
    ) -> list[EmbeddingResult]:
        if not texts:
            return []
        # device-side providers embed the whole batch in one pass (one TPU
        # dispatch); the reference's bounded-parallel loop exists for REMOTE
        # providers' HTTP latency (DocumentIngestionService.cs:309-328)
        batch_embed = getattr(self.embedding_client, "embed_batch", None)
        if callable(batch_embed):
            try:
                results_b = batch_embed(texts)
                if len(results_b) == len(texts):
                    return results_b
                logger.warning(
                    "embed_batch returned %d results for %d texts during %s "
                    "for %s; falling back to per-text embedding",
                    len(results_b), len(texts), operation, context_id,
                )
            except Exception as exc:
                if is_device_error(exc):
                    raise  # a failure of the card, not of the batch
                logger.warning(
                    "Batch embedding failed during %s for %s: %s; falling "
                    "back to per-text embedding", operation, context_id, exc,
                )
        parallelism = min(8, max(1, self.options.embedding_parallelism))
        results: list[EmbeddingResult | None] = [None] * len(texts)

        def embed_one(index: int) -> None:
            try:
                results[index] = self.embedding_client.embed(texts[index])
            except Exception as exc:
                if is_device_error(exc):
                    raise
                logger.warning(
                    "Embedding generation failed during %s for %s chunk %d: %s",
                    operation, context_id, index, exc,
                )
                results[index] = EmbeddingResult([], EmbeddingStatus.ERROR, message=str(exc))

        with ThreadPoolExecutor(max_workers=parallelism) as pool:
            list(pool.map(embed_one, range(len(texts))))
        return [r if r is not None else EmbeddingResult([], EmbeddingStatus.ERROR) for r in results]
