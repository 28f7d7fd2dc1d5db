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
- ``LocalEncoderEmbeddingClient`` — the on-device transformer encoder
  (models/encoder.py), selected with Embeddings:Provider=Local: ingestion
  and query embeddings computed on the card, no network.
- ``GeminiEmbeddingClient`` — HTTPS client with the reference's model-chain
  semantics (GeminiEmbeddingClient.cs:13-117): candidates = configured model +
  [gemini-embedding-001, embedding-001] deduped; 429 -> rate_limited;
  404 -> try next model; 401/403 -> error; parses ``embedding.values``.
  The HTTP transport is injectable so tests replay scripted responses, like
  the reference's fake HttpMessageHandlers (GeminiEmbeddingClientTests.cs).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Protocol

from omni_recall_tpu_torch.config import GeminiOptions
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


class LocalEncoderEmbeddingClient:
    """On-device transformer embedder (models/encoder.py) as an embedding
    provider (ingest/embedding.py:102-233): ingestion and query embeddings
    computed on the card, no network dependency. NEW vs the reference,
    whose embeddings are all remote HTTPS (GeminiEmbeddingClient.cs);
    selected with Embeddings:Provider=Local.

    A checkpoint written by either package's ``save_params`` is loaded when
    Embeddings:Checkpoint is set, otherwise the JAX package's seed init
    (``init_params(PRNGKey(seed))``, reproduced in numpy). Batches are
    padded to the buckets 1, 8, 32, 128 and then to multiples of 128, and
    token lengths to the next power of two >= the batch's longest text (at
    least 16, at most max_len): padding positions are masked in the
    forward, so the embedding values do not depend on the bucket, while
    their f32 bits may. The model runs on CUDA unless ``device="cpu"``."""

    _BUCKETS = (1, 8, 32, 128)

    def __init__(self, dim: int = 768, checkpoint: str = "", seed: int = 0, cfg=None,
                 device="cuda") -> None:
        from omni_recall_tpu_torch.device import resolve_device
        from omni_recall_tpu_torch.models import encoder

        self._enc = encoder
        self.device = resolve_device(device)
        if checkpoint:
            params, self.cfg = encoder.load_params(checkpoint)
            if self.cfg.out_dim != dim:
                raise ValueError(
                    f"checkpoint out_dim {self.cfg.out_dim} != Embeddings:Dim {dim}"
                )
            self.model = f"local-encoder:{checkpoint}"
        else:
            self.cfg = cfg or encoder.EncoderConfig(out_dim=dim)
            params = encoder.init_params(seed, self.cfg)
            self.model = "local-encoder"
        self.encoder = encoder.Encoder.from_state(params, self.cfg, self.device)

    @property
    def params(self):
        """The encoder's state (``models/encoder.py`` keys)."""
        return self.encoder.state_dict()

    def _bucketed_ids(self, texts: list[str]):
        """Token ids [b_bucket, l_bucket] of the texts, zero-padded."""
        import numpy as np

        b = len(texts)
        ids = self._enc.tokenize_batch(texts, self.cfg)
        n_tok = int((ids > 0).sum(axis=1).max())
        l_bucket = 16
        while l_bucket < min(max(n_tok, 1), self.cfg.max_len):
            l_bucket *= 2
        l_bucket = min(l_bucket, self.cfg.max_len)
        b_bucket = next((bb for bb in self._BUCKETS if bb >= b), ((b + 127) // 128) * 128)
        out = np.zeros((b_bucket, l_bucket), dtype=ids.dtype)
        out[:b] = ids[:, :l_bucket]
        return out

    def _forward(self, texts: list[str]):
        """f32[len(texts), out_dim] on the card: one forward of the bucket."""
        import torch

        ids = torch.from_numpy(self._bucketed_ids(texts)).to(self.device)
        return self.encoder(ids)[: len(texts)]

    def embed_rows(self, texts: list[str]):
        """The texts' embeddings as a host f32[len(texts), out_dim] array
        (blank texts embed to the zero row): the array form of
        ``embed_batch``, for bulk loads."""
        return self._forward(texts).cpu().numpy()

    def _embed_many(self, texts: list[str]) -> list[EmbeddingResult]:
        from omni_recall_tpu_torch.device import is_device_error

        nonempty = [i for i, t in enumerate(texts) if t.strip()]
        out: list[EmbeddingResult] = [
            EmbeddingResult([], EmbeddingStatus.EMPTY, model=self.model) for _ in texts
        ]
        if not nonempty:
            return out
        try:
            vecs = self.embed_rows([texts[i] for i in nonempty])
            for row, i in enumerate(nonempty):
                out[i] = EmbeddingResult(vecs[row].tolist(), EmbeddingStatus.SUCCESS,
                                         model=self.model)
        except Exception as exc:
            # never raise for a bad input (IEmbeddingClient.cs contract); a
            # failure of the card is not an embedding status: it raises
            if is_device_error(exc):
                raise
            for i in nonempty:
                out[i] = EmbeddingResult([], EmbeddingStatus.ERROR, model=self.model,
                                         message=str(exc))
        return out

    def embed(self, text: str) -> EmbeddingResult:
        return self._embed_many([text])[0]

    def embed_batch(self, texts: list[str]) -> list[EmbeddingResult]:
        """One device pass for a whole chunk batch: the ingestion service
        prefers this over bounded-parallel single calls when present."""
        return self._embed_many(texts)

    @property
    def dim(self) -> int:
        return self.cfg.out_dim

    def swap_params(self, params, tag: str = "trained") -> None:
        """Hot-swap the encoder's weights (``params``: a state dict of this
        client's cfg). The new module replaces the old by one reference
        assignment: in-flight embeds finish on the old weights, later calls
        (the engine's attached device-query pipeline included) use the new
        ones. Callers re-embed the index afterwards so stored rows and
        queries agree."""
        self.encoder = self._enc.Encoder.from_state(params, self.cfg, self.device)
        self.model = f"local-encoder:{tag}"

    def embed_device(self, texts: list[str]):
        """Device-resident query embeddings: forward the batch and return
        the f32[len(texts), out_dim] rows on the card: no host readback,
        no per-query vector upload. The engine chains them straight into
        the scan dispatch and materializes host copies lazily (only for the
        certificate's escalations); its certificates are relative to the
        materialized bits of THIS forward, as the reference's remote
        embeddings carry no cross-call bit guarantee at all
        (GeminiEmbeddingClient.cs)."""
        if not texts:
            raise ValueError("embed_device requires a non-empty batch")
        return self._forward(texts)


class FakeEmbeddingClient:
    """Scripted test double (reference pattern:
    DocumentIngestionServiceTests.cs FakeEmbeddingClient)."""

    def __init__(self, results: list[EmbeddingResult] | None = None, default: EmbeddingResult | None = None):
        self.results = list(results or [])
        self.default = default or EmbeddingResult([1.0, 0.0], EmbeddingStatus.SUCCESS, model="fake")
        self.calls: list[str] = []

    def embed(self, text: str) -> EmbeddingResult:
        self.calls.append(text)
        if self.results:
            return self.results.pop(0)
        return self.default


_DEFAULT_MODEL_CHAIN = ["gemini-embedding-001", "embedding-001"]

# models that predate the outputDimensionality request field
_NO_OUTPUT_DIM_MODELS = {"embedding-001"}


class GeminiEmbeddingClient:
    """Gemini embedContent client (GeminiEmbeddingClient.cs:15-99 semantics).

    Extension over the reference: when ``output_dim`` is set (wired from
    Embeddings:Dim), the request carries ``outputDimensionality`` so the
    provider returns vectors matching the device index dim — the reference
    omits it, and gemini-embedding-001's 3072-dim default would silently
    route every query to the exact host scan (dim-mismatch soundness
    fallback, search/engine.py)."""

    def __init__(
        self,
        options: GeminiOptions,
        transport: Transport | None = None,
        timeout: float = 30.0,
        output_dim: int | None = None,
    ):
        self.options = options
        self.transport = transport or urllib_transport
        self.timeout = timeout
        self.output_dim = output_dim

    def _candidate_models(self) -> list[str]:
        """BuildModelCandidates parity (GeminiEmbeddingClient.cs:103-129):
        configured model is trimmed and its 'models/' prefix stripped
        (NormalizeModel), and the default chain dedupes case-insensitively."""
        configured = (self.options.embedding_model or "").strip()
        if configured.lower().startswith("models/"):
            configured = configured[len("models/"):]
        chain = ([configured] if configured else []) + _DEFAULT_MODEL_CHAIN
        out: list[str] = []
        seen: set[str] = set()
        for model in chain:
            if model.lower() not in seen:
                seen.add(model.lower())
                out.append(model)
        return out

    def embed(self, text: str) -> EmbeddingResult:
        import urllib.parse

        # GeminiEmbeddingClient.cs:17-22: local EMPTY (no network call) for
        # blank input or a missing/whitespace API key
        if not text or not text.strip():
            return EmbeddingResult(
                [], EmbeddingStatus.EMPTY, message="Input text is empty."
            )
        if not self.options.api_key or not self.options.api_key.strip():
            return EmbeddingResult(
                [], EmbeddingStatus.EMPTY, message="Gemini API key missing."
            )
        for model in self._candidate_models():
            body: dict = {
                "model": f"models/{model}",
                "content": {"parts": [{"text": text}]},
            }
            # extension: legacy models reject the field; send only where supported
            if self.output_dim and model not in _NO_OUTPUT_DIM_MODELS:
                body["outputDimensionality"] = self.output_dim
            payload = json.dumps(body).encode("utf-8")
            key = urllib.parse.quote(self.options.api_key, safe="")  # Uri.EscapeDataString
            url = f"{self.options.base_url}/models/{model}:embedContent?key={key}"
            try:
                resp = self.transport(
                    "POST", url, {"Content-Type": "application/json"}, payload, self.timeout
                )
            except Exception:  # transport failure: try next model (:93-96)
                continue
            if resp.status == 429:
                return EmbeddingResult(
                    [], EmbeddingStatus.RATE_LIMITED, model=model, message="Rate limited."
                )
            if resp.status == 404:
                continue  # model unavailable: try next (:54-58)
            if resp.status in (401, 403):
                return EmbeddingResult(
                    [], EmbeddingStatus.ERROR, model=model,
                    message=f"Auth rejected: {resp.status}",
                )
            if resp.status >= 400:
                # any other failure stops the chain (:66-74)
                return EmbeddingResult(
                    [], EmbeddingStatus.ERROR, model=model, message=f"HTTP {resp.status}"
                )
            try:
                data = json.loads(resp.body.decode("utf-8"))
            except ValueError:
                # DELIBERATE DEVIATION from GeminiEmbeddingClient.cs:84-86:
                # the reference's JsonDocument.Parse exception on a malformed
                # 200 body is NOT caught by its HttpRequestException/
                # TaskCanceledException filter and would propagate; this
                # client keeps the never-raise contract and treats it like a
                # transport failure (continue down the model chain)
                continue
            embedding = data.get("embedding") if isinstance(data, dict) else None
            if not isinstance(embedding, dict):
                return EmbeddingResult(
                    [], EmbeddingStatus.EMPTY, model=model,
                    message="Missing embedding property.",
                )
            values = embedding.get("values")
            if not isinstance(values, list):
                return EmbeddingResult(
                    [], EmbeddingStatus.EMPTY, model=model,
                    message="Missing embedding values.",
                )
            floats = []
            for v in values:
                try:
                    floats.append(float(v))
                except (TypeError, ValueError):
                    pass  # TryGetSingle parity: skip non-numeric entries
            status = EmbeddingStatus.SUCCESS if floats else EmbeddingStatus.EMPTY
            return EmbeddingResult(floats, status, model=model)
        # chain exhausted (:99-100)
        return EmbeddingResult(
            [], EmbeddingStatus.NOT_SUPPORTED,
            message="No compatible Gemini embedding model.",
        )
