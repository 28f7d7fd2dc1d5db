"""Document/chunk records.

Mirrors the reference's Cosmos records
(src/OmniRecall.Api/Data/Models/CosmosIngestionRecords.cs:6-29); the chunk
record is exactly the entity the device index represents (embedding +
content + created-at + ids).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime


@dataclass
class DocumentRecord:
    id: str
    file_name: str = ""
    source_type: str = "file"
    blob_path: str = ""
    content_hash: str = ""
    chunk_count: int = 0
    created_at_utc: datetime | None = None
    partition_key: str = "user:default"
    type: str = "document"


@dataclass
class ChunkRecord:
    id: str
    document_id: str
    chunk_index: int
    content: str
    embedding: list[float] | None = None
    created_at_utc: datetime | None = None
    partition_key: str = "user:default"
    type: str = "chunk"
    # Monotonic insertion sequence assigned by the store; used as the final,
    # deterministic tie-break so that rankings are reproducible even when
    # scores AND timestamps tie (the reference's ordering is only stable up to
    # ConcurrentDictionary enumeration order there).
    seq: int = field(default=-1, compare=False)
    # lazy cache: lowercased UTF-8 content for the native keyword rescorer
    _lower_utf8: bytes | None = field(default=None, repr=False, compare=False)

    def content_lower_utf8(self) -> bytes:
        if self._lower_utf8 is None:
            # surrogatepass matches ops/hashing.py's gram encoding: lone
            # surrogates (surrogateescape-decoded input) must not raise
            # mid-append (index state is mutated row by row)
            from omni_recall_tpu_torch.ops.oracle import lower_invariant

            self._lower_utf8 = lower_invariant(self.content).encode(
                "utf-8", errors="surrogatepass"
            )
        return self._lower_utf8
