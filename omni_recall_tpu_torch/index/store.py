"""Host-of-record ingestion stores.

``InMemoryIngestionStore`` mirrors the reference's in-memory store
(src/OmniRecall.Api/Services/InMemoryIngestionStore.cs:8-77): two dicts keyed
by document id; ``upsert_chunks`` replaces a document's whole chunk list
sorted by chunk index (:17-25); ``get_recent_chunks`` flattens all chunks,
sorts by created-at desc, and takes N (:57-66); document listing is sorted by
created-at desc (:33-40).

Raw-document stores mirror InMemoryRawDocumentStore.cs:14-17 (path
``raw/{lowercased-dashed-name}``) and, in spirit, BlobRawDocumentStore.cs:24
(dated + hash-prefixed path) for the local-disk variant.

All methods are synchronous; the HTTP layer is thread-per-request, so the
store guards mutation with an RLock (the reference relies on
ConcurrentDictionary for the same guarantee).
"""

from __future__ import annotations

import threading
from datetime import datetime, timezone
from pathlib import Path

from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord


class InMemoryIngestionStore:
    def __init__(self) -> None:
        self._documents: dict[str, DocumentRecord] = {}
        self._chunks: dict[str, list[ChunkRecord]] = {}
        self._lock = threading.RLock()
        self._seq = 0

    # -- IIngestionStore surface (IIngestionStore.cs:5-17) --

    def upsert_document(self, document: DocumentRecord) -> DocumentRecord:
        with self._lock:
            self._documents[document.id] = document
            return document

    def upsert_chunks(self, chunks: list[ChunkRecord]) -> None:
        with self._lock:
            by_doc: dict[str, list[ChunkRecord]] = {}
            for chunk in chunks:
                if chunk.seq < 0:
                    chunk.seq = self._seq
                    self._seq += 1
                by_doc.setdefault(chunk.document_id, []).append(chunk)
            for doc_id, doc_chunks in by_doc.items():
                # REPLACE the document's whole chunk list (reference
                # semantics, InMemoryIngestionStore.cs:17-25): stale chunks
                # absent from the new list are dropped. Chunks re-upserted
                # under the same id keep their original seq so the
                # (created_at, seq) index ordering is stable across reindex.
                prior_seq = {c.id: c.seq for c in self._chunks.get(doc_id, [])}
                for c in doc_chunks:
                    if c.id in prior_seq:
                        c.seq = prior_seq[c.id]
                self._chunks[doc_id] = sorted(
                    doc_chunks, key=lambda c: c.chunk_index
                )

    def bulk_restore(
        self,
        documents: list[DocumentRecord],
        chunks_by_doc: dict[str, list[ChunkRecord]],
        next_seq: int,
    ) -> None:
        """Snapshot-restore injection (index/snapshot.py): installs the
        record maps directly, bypassing per-document upserts. Chunk lists
        must already be in chunk_index order with their original seqs."""
        with self._lock:
            self._documents = {d.id: d for d in documents}
            self._chunks = dict(chunks_by_doc)
            self._seq = next_seq

    def get_document(self, document_id: str) -> DocumentRecord | None:
        with self._lock:
            return self._documents.get(document_id)

    def list_documents(self, max_count: int) -> list[DocumentRecord]:
        with self._lock:
            docs = sorted(
                self._documents.values(),
                key=lambda d: d.created_at_utc or datetime.min.replace(tzinfo=timezone.utc),
                reverse=True,
            )
            return docs[: max(0, max_count)]

    def get_chunks_by_document_id(self, document_id: str) -> list[ChunkRecord]:
        with self._lock:
            return list(self._chunks.get(document_id, []))

    def delete_document(self, document_id: str) -> None:
        with self._lock:
            self._documents.pop(document_id, None)
            self._chunks.pop(document_id, None)

    def get_recent_chunks(self, max_count: int) -> list[ChunkRecord]:
        with self._lock:
            all_chunks = [c for chunks in self._chunks.values() for c in chunks]
        all_chunks.sort(key=lambda c: (self._ts(c), c.seq), reverse=True)
        return all_chunks[: max(0, max_count)]

    def get_documents_by_ids(self, document_ids: list[str]) -> dict[str, DocumentRecord]:
        with self._lock:
            return {
                doc_id: self._documents[doc_id]
                for doc_id in document_ids
                if doc_id in self._documents
            }

    @staticmethod
    def _ts(chunk: ChunkRecord) -> datetime:
        return chunk.created_at_utc or datetime.min.replace(tzinfo=timezone.utc)


class InMemoryRawDocumentStore:
    """Mirrors InMemoryRawDocumentStore.cs:14-17."""

    def __init__(self) -> None:
        self._blobs: dict[str, str] = {}

    def save(self, file_name: str, content: str, content_hash: str) -> str:
        path = f"raw/{file_name.strip().lower().replace(' ', '-')}"
        self._blobs[path] = content
        return path

    def get(self, path: str) -> str | None:
        return self._blobs.get(path)


class LocalFileRawDocumentStore:
    """Local-disk stand-in for the Azure Blob raw store.

    Path scheme mirrors BlobRawDocumentStore.cs:24:
    ``raw/yyyy/MM/dd/{hash12}-{name}`` under a configurable root directory.
    """

    def __init__(self, root: str | Path) -> None:
        self._root = Path(root)

    def save(self, file_name: str, content: str, content_hash: str) -> str:
        now = datetime.now(timezone.utc)
        # the filename is CLIENT-SUPPLIED (multipart upload): strip any
        # directory components and dot-segments or '../../../etc/x' writes
        # outside the storage root (path traversal)
        base = file_name.replace("\\", "/").rsplit("/", 1)[-1]
        safe_name = base.strip().lower().replace(" ", "-").replace("..", "_")
        if not safe_name or safe_name in (".", "_"):
            safe_name = "upload"
        rel = f"raw/{now:%Y/%m/%d}/{content_hash[:12]}-{safe_name}"
        target = (self._root / rel).resolve()
        root = self._root.resolve()
        if not target.is_relative_to(root):
            raise ValueError(f"unsafe raw-document path: {file_name!r}")
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(content, encoding="utf-8")
        return rel

    def get(self, path: str) -> str | None:
        target = (self._root / path).resolve()
        if not target.is_relative_to(self._root.resolve()):
            return None  # stored paths are internal, but stay contained
        if not target.is_file():
            return None
        return target.read_text(encoding="utf-8")
