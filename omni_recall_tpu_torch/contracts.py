"""Wire contracts (DTOs).

Mirrors the C# records under the reference's
src/OmniRecall.Api/Contracts/ (RecallDtos.cs:3-16, ChatDtos.cs:3-9,
DocumentDtos.cs:3-42, HealthDtos.cs:3-12, AiChatContracts.cs:3-5) and their
camelCase JSON serialization (ASP.NET minimal-API default, confirmed by the
TypeScript mirrors in src/OmniRecall.App/src/app/models/api.models.ts:1-57).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any


def iso_utc(dt: datetime) -> str:
    """Serialize a datetime the way System.Text.Json renders UTC DateTime:
    trailing zeros of the fractional seconds are trimmed and the fraction
    is omitted entirely when zero ("...T00:00:00Z", not ".000000Z")."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    dt = dt.astimezone(timezone.utc)
    out = dt.isoformat(timespec="microseconds").replace("+00:00", "")
    if "." in out:
        out = out.rstrip("0").rstrip(".")
    return out + "Z"


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def to_wire(obj: Any) -> Any:
    """Recursively convert dataclasses to camelCase JSON-ready dicts."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            _camel(f.name): to_wire(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, datetime):
        return iso_utc(obj)
    if isinstance(obj, (list, tuple)):
        return [to_wire(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    return obj


# --- Recall (RecallDtos.cs:3-16) ---

@dataclass(frozen=True)
class RecallCitation:
    document_id: str
    file_name: str
    chunk_id: str
    chunk_index: int
    snippet: str
    score: float
    created_at_utc: datetime


@dataclass(frozen=True)
class RecallSearchResponse:
    query: str
    citations: list[RecallCitation]


# --- Chat (ChatDtos.cs:3-9, AiChatContracts.cs:3-5) ---

@dataclass(frozen=True)
class ChatResponse:
    answer: str
    provider: str
    model: str
    citations: list[RecallCitation]


@dataclass(frozen=True)
class AiChatRequest:
    prompt: str


@dataclass(frozen=True)
class AiChatResponse:
    text: str
    model: str
    provider: str


# --- Documents (DocumentDtos.cs:3-42) ---

@dataclass(frozen=True)
class UploadDocumentResponse:
    document_id: str
    file_name: str
    source_type: str
    blob_path: str
    chunk_count: int
    content_hash: str
    created_at_utc: datetime


@dataclass(frozen=True)
class DocumentDetails:
    document_id: str
    file_name: str
    source_type: str
    blob_path: str
    chunk_count: int
    content_hash: str
    created_at_utc: datetime


@dataclass(frozen=True)
class DocumentListItem:
    document_id: str
    file_name: str
    source_type: str
    chunk_count: int
    created_at_utc: datetime


@dataclass(frozen=True)
class DocumentChunkPreview:
    chunk_id: str
    chunk_index: int
    snippet: str
    has_embedding: bool
    created_at_utc: datetime


@dataclass(frozen=True)
class ReindexDocumentResponse:
    document_id: str
    chunk_count: int
    embedded_count: int
    rate_limited_count: int
    empty_count: int
    failed_count: int
    reindexed_at_utc: datetime


@dataclass(frozen=True)
class TrainEncoderResponse:
    """POST /api/documents/train result (new TPU scope: the corpus-trained
    local encoder; the reference has no trainable provider). Counters
    aggregate the per-document reindex that re-embeds the corpus with the
    freshly trained encoder."""

    document_count: int
    chunk_count: int
    embedded_count: int
    failed_count: int
    steps: int
    model: str
    trained_at_utc: datetime


# --- Health (HealthDtos.cs:3-12) ---

@dataclass(frozen=True)
class HealthDependency:
    name: str
    status: str
    detail: str
    duration_ms: int


@dataclass(frozen=True)
class HealthResponse:
    status: str
    timestamp_utc: datetime
    dependencies: list[HealthDependency] = field(default_factory=list)
