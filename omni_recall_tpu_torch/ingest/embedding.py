"""Embedding clients (port of omni_recall_tpu/ingest/embedding.py).

Mirrors the reference's embedding abstraction
(src/OmniRecall.Api/Services/IEmbeddingClient.cs:3-21): clients NEVER raise;
they return ``EmbeddingResult(vector, status, model, message)`` with status in
{success, empty, rate_limited, not_supported, error}.

- ``NoOpEmbeddingClient`` — the default when no provider is configured
  (NoOpEmbeddingClient.cs:9, Program.cs:50-57); search degrades to
  keyword+recency only.
- ``HashEmbeddingClient`` — local deterministic embedder
  (models/hash_embedder.py) for offline/bench operation.

The Gemini and on-device encoder providers are not ported yet (ROADMAP.md).
The HTTP transport types stay: the health probes use them.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable, Protocol

from omni_recall_tpu_torch.models import hash_embedder


class EmbeddingStatus(str, Enum):
    SUCCESS = "success"
    EMPTY = "empty"
    RATE_LIMITED = "rate_limited"
    NOT_SUPPORTED = "not_supported"
    ERROR = "error"


@dataclass(frozen=True)
class EmbeddingResult:
    vector: list[float]
    status: EmbeddingStatus
    model: str | None = None
    message: str | None = None


class HttpResponse(Protocol):
    status: int
    body: bytes


@dataclass
class SimpleHttpResponse:
    status: int
    body: bytes
    headers: dict[str, str] = None  # lower-cased keys

    def __post_init__(self) -> None:
        if self.headers is None:
            self.headers = {}


Transport = Callable[[str, str, dict[str, str], bytes | None, float], SimpleHttpResponse]


def urllib_transport(
    method: str, url: str, headers: dict[str, str], body: bytes | None, timeout: float
) -> SimpleHttpResponse:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return SimpleHttpResponse(
                resp.status, resp.read(),
                {k.lower(): v for k, v in resp.headers.items()},
            )
    except urllib.error.HTTPError as exc:
        return SimpleHttpResponse(
            exc.code, exc.read(), {k.lower(): v for k, v in (exc.headers or {}).items()}
        )


class NoOpEmbeddingClient:
    def embed(self, text: str) -> EmbeddingResult:
        return EmbeddingResult([], EmbeddingStatus.EMPTY, model="none")


class HashEmbeddingClient:
    def __init__(self, dim: int = 768) -> None:
        self.dim = dim

    def embed(self, text: str) -> EmbeddingResult:
        vec = hash_embedder.embed_text(text, self.dim)
        if not vec:
            return EmbeddingResult([], EmbeddingStatus.EMPTY, model="hash")
        return EmbeddingResult(vec, EmbeddingStatus.SUCCESS, model="hash")
