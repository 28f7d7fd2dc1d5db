"""Application composition root + HTTP routes (PyTorch port of
omni_recall_tpu/server/app.py, cut to this slice's routes).

Mirrors the reference's Program.cs + Endpoints/: DI wiring by configuration
(provider switches, Program.cs:40-69), the document and recall routes
(DocumentEndpoints.cs, RecallEndpoints.cs), /health (Program.cs:104-115),
/metrics, CORS, and the global exception -> ProblemDetails handler
(server/http.py), snapshot persistence (``Storage:SnapshotDir`` restores
the store and the device index at startup, ``POST /api/snapshot`` saves
both, index/snapshot.py), chat (``POST /api/chat`` over the remote provider
chain, ChatEndpoints.cs), the OpenAPI document, the API docs page and the
UI page. ``Embeddings:Provider=Local`` embeds on the card with the local
encoder, and its queries take the device-resident pipeline
(``RecallEngine.attach_device_embedder``). Training the encoder
(``POST /api/documents/train``) waits for a later slice: its route is
registered with the reference's method and path and answers a 501 problem
that names its ROADMAP.md item, and ``Ai:Provider=Local`` (the on-device
chat decoder) raises at construction. The engine and the local encoder run
on CUDA unless ``device="cpu"`` is passed.

``build_app`` accepts overrides for every dependency so tests can boot the
whole app in-process with fakes — the reference's WebApplicationFactory
pattern (tests/.../ChatEndpointTests.cs:27-126).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

from omni_recall_tpu_torch.chat.orchestration import ChatOrchestrationService
from omni_recall_tpu_torch.chat.providers import GeminiChatClient, GitHubModelsChatClient
from omni_recall_tpu_torch.chat.router import AiChatRouter, AiProviderUnavailableError
from omni_recall_tpu_torch.config import AppConfig, load_config
from omni_recall_tpu_torch.extract.pdf import NoOpOcrTextExtractor, PdfTextExtractor
from omni_recall_tpu_torch.index.store import (
    InMemoryIngestionStore,
    InMemoryRawDocumentStore,
    LocalFileRawDocumentStore,
)
from omni_recall_tpu_torch.ingest.embedding import (
    GeminiEmbeddingClient,
    HashEmbeddingClient,
    NoOpEmbeddingClient,
)
from omni_recall_tpu_torch.ingest.service import DocumentIngestionService, IngestionError
from omni_recall_tpu_torch.search.engine import RecallEngine
from omni_recall_tpu_torch.search.service import RecallSearchService
from omni_recall_tpu_torch.server.health import HealthProbeService
from omni_recall_tpu_torch.server.http import Request, Response, Router, WsgiApp
from omni_recall_tpu_torch.server.openapi import build_openapi_document

ALLOWED_EXTENSIONS = {".pdf", ".txt", ".md", ".markdown"}  # DocumentEndpoints.cs:8-14

# routes of the reference app (omni_recall_tpu/server/app.py:254-268) that
# the port does not serve yet: (method, path, what, its ROADMAP.md item)
NOT_PORTED_ROUTES = (
    ("POST", "/api/documents/train", "Embedder training",
     '(ROADMAP.md, "Local models")'),
)


def _not_ported(what: str, item: str):
    def handler(request: Request) -> Response:
        return Response.problem("Not implemented", f"{what} is not ported yet {item}.", 501)
    return handler


def _parse_top_k(value) -> int | None:
    """Validate user-supplied topK: accept ints (and integral floats/strings,
    matching ASP.NET model binding's leniency); None on anything else so the
    handler returns 400 rather than a 500 ProblemDetails."""
    if isinstance(value, bool):
        return None
    try:
        as_int = int(value)
    except (TypeError, ValueError, OverflowError):  # inf -> OverflowError
        return None
    if isinstance(value, float) and value != as_int:
        return None
    return as_int


class OmniRecallApp(WsgiApp):
    """WSGI app exposing the document, recall-search, health and metrics
    routes of the Omni Recall REST surface."""

    def __init__(
        self,
        config: AppConfig,
        *,
        store=None,
        raw_store=None,
        embedding_client=None,
        chat_router=None,
        pdf_extractor=None,
        engine=None,
        health_service=None,
        device: str = "cuda",
    ) -> None:
        self.config = config
        if (config.ai.provider or "").strip().lower() == "local":
            raise NotImplementedError(
                "Ai:Provider=Local (the on-device chat decoder) is not ported yet "
                '(ROADMAP.md, "Local models"); leave it unset'
            )
        self.store = store if store is not None else InMemoryIngestionStore()

        if raw_store is not None:
            self.raw_store = raw_store
        elif (config.storage.provider or "").strip().lower() == "localdisk":
            self.raw_store = LocalFileRawDocumentStore(Path(config.storage.root))
        else:
            self.raw_store = InMemoryRawDocumentStore()

        if embedding_client is not None:
            self.embedding_client = embedding_client
        else:
            provider = (config.embeddings.provider or "").strip().lower()
            if provider == "gemini":
                self.embedding_client = GeminiEmbeddingClient(
                    config.gemini, output_dim=config.embeddings.dim
                )
            elif provider == "hash":
                self.embedding_client = HashEmbeddingClient(config.embeddings.dim)
            elif provider == "local":
                from omni_recall_tpu_torch.ingest.embedding import LocalEncoderEmbeddingClient

                self.embedding_client = LocalEncoderEmbeddingClient(
                    config.embeddings.dim, checkpoint=config.embeddings.checkpoint,
                    device=device,
                )
            else:
                self.embedding_client = NoOpEmbeddingClient()

        if engine is not None:
            self.engine = engine
        else:
            self.engine = RecallEngine(self.store, options=config.engine, device=device)
        if config.embeddings.dim != config.engine.embedding_dim:
            # handled soundly (zero device rows + host full-scan routing for
            # mismatched queries) but it disables the fast path: say so
            logging.getLogger(__name__).warning(
                "Embeddings:Dim (%d) != Engine:EmbeddingDim (%d): embeddings "
                "will not land in the device index and searches with "
                "mismatched query embeddings fall back to the exact host "
                "scan. Align the two settings.",
                config.embeddings.dim, config.engine.embedding_dim,
            )
        # snapshot restore: load the archived store and device index before
        # any service wiring. The device-slab fast path skips bloom hashing
        # and re-quantization; a malformed snapshot logs and boots empty
        # (serving must come up regardless), a failure of the card raises.
        self.snapshot_dir = (config.storage.snapshot_dir or "").strip() or None
        self.restore_route = None
        if self.snapshot_dir:
            self._restore_snapshot(Path(self.snapshot_dir))
        self.search_executor = None
        if config.engine.coalesce_window_ms > 0 and config.engine.backend != "oracle":
            from omni_recall_tpu_torch.search.coalesce import CoalescingSearchExecutor

            self.search_executor = CoalescingSearchExecutor(
                self.engine,
                window_ms=config.engine.coalesce_window_ms,
                max_batch=max(1, config.engine.coalesce_max_batch),
            )
        # device-resident query pipeline: with the local encoder and a
        # device engine, query embeddings are computed inside the search
        # dispatch, with no host embed and no per-query vector upload
        # (engine.attach_device_embedder). A refusal of the attach (a bad
        # configuration) logs and serves host embeds; a failure of the card
        # raises
        device_query = False
        if (
            config.embeddings.device_query
            and (config.embeddings.provider or "").strip().lower() == "local"
            and config.engine.backend != "oracle"
            and self.engine.device_index is not None
            and getattr(self.embedding_client, "dim", None) == self.engine.device_index.dim
        ):
            try:
                self.engine.attach_device_embedder(self.embedding_client)
                device_query = True
            except ValueError:
                logging.getLogger(__name__).exception(
                    "device query pipeline unavailable; using host embeds"
                )
        self.search_service = RecallSearchService(
            self.engine, self.embedding_client, executor=self.search_executor,
            device_query=device_query,
        )
        self.ingestion_service = DocumentIngestionService(
            self.store, self.raw_store, self.embedding_client,
            config.ingestion, engine=self.engine,
        )
        if chat_router is not None:
            self.chat_router = chat_router
        else:
            self.chat_router = AiChatRouter(
                GeminiChatClient(config.gemini),
                GitHubModelsChatClient(config.github_models),
                config.ai_routing,
            )
        self.chat_service = ChatOrchestrationService(
            self.search_service, self.chat_router, config.chat_quality
        )
        if pdf_extractor is not None:
            self.pdf_extractor = pdf_extractor
        else:
            ocr_provider = (config.ocr.provider or "").strip().lower()
            if ocr_provider in ("documentintelligence", "azuredocumentintelligence"):
                from omni_recall_tpu_torch.extract.ocr import DocumentIntelligenceOcrTextExtractor

                ocr = DocumentIntelligenceOcrTextExtractor(config.ocr)
            else:
                ocr = NoOpOcrTextExtractor()
            self.pdf_extractor = PdfTextExtractor(ocr, config.ocr.pdf_text_min_chars)
        self.health_service = health_service if health_service is not None else HealthProbeService(
            config, self.store, self.raw_store, self.engine
        )

        router = Router()
        router.add("POST", "/api/documents/upload", self._upload_document)
        for method, path, what, item in NOT_PORTED_ROUTES:
            # before the {document_id} routes: POST /api/documents/train
            # would otherwise match POST /api/documents/{document_id} (405)
            router.add(method, path, _not_ported(what, item))
        router.add("GET", "/api/documents", self._list_documents)
        router.add("GET", "/api/documents/{document_id}", self._get_document)
        router.add("GET", "/api/documents/{document_id}/chunks", self._get_document_chunks)
        router.add("DELETE", "/api/documents/{document_id}", self._delete_document)
        router.add("POST", "/api/documents/{document_id}/reindex", self._reindex_document)
        router.add("POST", "/api/recall/search", self._search_recall)
        router.add("POST", "/api/chat", self._complete_chat)
        router.add("GET", "/health", self._health)
        router.add("GET", "/metrics", self._metrics)
        router.add("POST", "/api/snapshot", self._save_snapshot)
        router.add("GET", "/swagger/v1/swagger.json", self._swagger)
        router.add("GET", "/swagger", self._swagger_ui)
        router.add("GET", "/", self._index)
        origins = [
            o.strip()
            for o in (config.cors.allowed_origins_csv or "").split(",")
            if o.strip()
        ]
        # body cap at the WSGI layer (before buffering): upload limit plus
        # multipart framing slack; mirrors Kestrel MaxRequestBodySize
        super().__init__(
            router, allowed_origins=origins,
            max_body_bytes=max(1, config.ingestion.max_upload_bytes) + (64 << 10),
        )

    def _restore_snapshot(self, path: Path) -> None:
        from omni_recall_tpu_torch.device import is_device_error
        from omni_recall_tpu_torch.index import snapshot as snap

        log = logging.getLogger(__name__)
        try:
            if not snap.snapshot_exists(path):
                return
            restored, aux = snap.load_snapshot_full(path)
            with restored._lock:
                self.store.bulk_restore(
                    list(restored._documents.values()), restored._chunks, restored._seq,
                )
            self.restore_route = snap.restore_engine(self.store, self.engine, aux=aux)
            log.info("restored snapshot from %s (%d documents, %s)", path,
                     len(self.store.list_documents(2**31 - 1)), self.restore_route)
        except Exception as exc:
            if is_device_error(exc):
                raise
            log.exception("snapshot restore from %s failed; starting empty", path)

    def _save_snapshot(self, request: Request) -> Response:
        """POST /api/snapshot — persist the store and the device-index slabs
        atomically to Storage:SnapshotDir. Holds the engine's mutation lock
        so the store view and the gathered slabs are one consistent state; a
        restart with the same configuration restores by the slab fast path."""
        if not self.snapshot_dir:
            return Response.problem(
                "Snapshots not configured",
                "Set Storage:SnapshotDir to enable snapshot persistence.",
                409,
            )
        from omni_recall_tpu_torch.index import snapshot as snap

        with self.engine.mutation_lock:
            snap.save_snapshot(self.store, self.snapshot_dir,
                               device_index=self.engine.device_index)
        docs = self.store.list_documents(2**31 - 1)
        return Response.json(
            {
                "path": str(Path(self.snapshot_dir) / "snapshot.d"),
                "documents": len(docs),
                "chunks": sum(d.chunk_count for d in docs),
            },
            200,
        )

    # -- documents (DocumentEndpoints.cs) --

    def _upload_document(self, request: Request) -> Response:
        max_upload = max(1, self.config.ingestion.max_upload_bytes)
        if request.content_length and request.content_length > max_upload:
            return Response.problem(
                "Payload too large", f"Max upload size is {max_upload} bytes.", 413
            )
        try:
            fields, files = request.form()
        except ValueError:
            return Response.error("Expected multipart form data.")

        file = next((f for f in files if f.name == "file"), files[0] if files else None)
        if file is None or len(file.data) == 0:
            return Response.error("File is required.")
        if len(file.data) > max_upload:
            return Response.problem(
                "Payload too large", f"Max upload size is {max_upload} bytes.", 413
            )

        extension = os.path.splitext(file.filename)[1].lower()
        if not extension and file.filename.startswith("."):
            # dotfiles: Path.GetExtension(".txt") returns ".txt" in the
            # reference (DocumentEndpoints.cs allowlist accepts them);
            # splitext treats the name as extensionless
            extension = file.filename.lower()
        if extension not in ALLOWED_EXTENSIONS:
            return Response(415, b"", {})

        if extension == ".pdf":
            content = self.pdf_extractor.extract_text(file.data)
        else:
            content = file.data.decode("utf-8", errors="replace")
        if not content or not content.strip():
            return Response.error("Uploaded file produced no readable text content.")

        source_type = fields.get("sourceType", "").strip() or "file"
        try:
            result = self.ingestion_service.ingest(file.filename, content, source_type)
        except IngestionError as exc:
            return Response.error(str(exc))
        return Response.json(
            result, 201, {"Location": f"/api/documents/{result.document_id}"}
        )

    def _get_document(self, request: Request) -> Response:
        document = self.ingestion_service.get_document(request.path_params["document_id"])
        if document is None:
            return Response.error("Document not found.", 404)
        return Response.json(document)

    def _list_documents(self, request: Request) -> Response:
        max_count = request.query_int("maxCount") or 0
        docs = self.ingestion_service.list_documents(max_count if max_count > 0 else 100)
        return Response.json(docs)

    def _get_document_chunks(self, request: Request) -> Response:
        document_id = request.path_params["document_id"]
        if self.ingestion_service.get_document(document_id) is None:
            return Response.error("Document not found.", 404)
        max_count = request.query_int("maxCount") or 0
        chunks = self.ingestion_service.get_document_chunks(
            document_id, max_count if max_count > 0 else 200
        )
        return Response.json(chunks)

    def _delete_document(self, request: Request) -> Response:
        deleted = self.ingestion_service.delete_document(request.path_params["document_id"])
        if not deleted:
            return Response.error("Document not found.", 404)
        return Response.no_content()

    def _reindex_document(self, request: Request) -> Response:
        result = self.ingestion_service.reindex_document(request.path_params["document_id"])
        if result is None:
            return Response.error("Document not found.", 404)
        return Response.json(result)

    # -- recall (RecallEndpoints.cs:20-30) --

    def _search_recall(self, request: Request) -> Response:
        try:
            payload = request.json() or {}
        except ValueError:
            return Response.error("Invalid JSON body.")
        if not isinstance(payload, dict):
            # model-binding parity: a non-object body is a 400, not a 500
            return Response.error("Request body must be a JSON object.")
        query = payload.get("query") or ""
        if not isinstance(query, str) or not query.strip():
            return Response.error("Query is required.")
        top_k = _parse_top_k(payload.get("topK", 5))
        if top_k is None:
            return Response.error("topK must be an integer.")
        result = self.search_service.search(query, top_k)
        return Response.json(result)

    # -- chat (ChatEndpoints.cs:21-41) --

    def _complete_chat(self, request: Request) -> Response:
        try:
            payload = request.json() or {}
        except ValueError:
            return Response.error("Invalid JSON body.")
        if not isinstance(payload, dict):
            return Response.error("Request body must be a JSON object.")
        prompt = payload.get("prompt") or ""
        if not isinstance(prompt, str) or not prompt.strip():
            return Response.error("Prompt is required.")
        top_k = _parse_top_k(payload.get("topK", 5))
        if top_k is None:
            return Response.error("topK must be an integer.")
        try:
            result = self.chat_service.complete(prompt, top_k)
        except AiProviderUnavailableError as exc:
            return Response.problem("AI provider unavailable", str(exc), 503)
        return Response.json(result)

    # -- health (Program.cs:104-115) --

    def _health(self, request: Request) -> Response:
        report = self.health_service.probe()
        status_code = 503 if report.status == "unhealthy" else 200
        return Response.json(report, status_code)

    def _metrics(self, request: Request) -> Response:
        """Prometheus text exposition of the engine/index counters (new
        scope: the reference exports no metrics, SURVEY.md §5; this is the
        observability surface a production serving deployment needs)."""
        engine = self.engine
        dix = engine.device_index
        lines = [
            "# TYPE omni_searches_total counter",
            f"omni_searches_total {engine.stats['searches_total']}",
            "# TYPE omni_coarse_resolved_total counter",
            f"omni_coarse_resolved_total {engine.stats['coarse_resolved_total']}",
            "# TYPE omni_escalation_rounds_total counter",
            f"omni_escalation_rounds_total {engine.stats['escalation_rounds_total']}",
            "# TYPE omni_host_fallbacks_total counter",
            f"omni_host_fallbacks_total {engine.stats['host_fallbacks_total']}",
            "# TYPE omni_index_rows gauge",
            f"omni_index_rows {dix.n_rows if dix is not None else 0}",
            "# TYPE omni_index_valid_rows gauge",
            f"omni_index_valid_rows {dix.n_valid if dix is not None else 0}",
            "# TYPE omni_index_capacity_rows gauge",
            f"omni_index_capacity_rows {dix._cap if dix is not None else 0}",
        ]
        return Response(
            200, ("\n".join(lines) + "\n").encode("utf-8"),
            {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    def _swagger(self, request: Request) -> Response:
        return Response.json(build_openapi_document())

    def _index(self, request: Request) -> Response:
        from omni_recall_tpu_torch.server.ui import INDEX_HTML

        return Response(
            200, INDEX_HTML.encode("utf-8"),
            {"Content-Type": "text/html; charset=utf-8"},
        )

    def _swagger_ui(self, request: Request) -> Response:
        """Self-contained API docs page (Swagger-UI parity, Program.cs:74-75,
        without CDN assets: the page works offline)."""
        from omni_recall_tpu_torch.server.ui import SWAGGER_HTML

        return Response(
            200, SWAGGER_HTML.encode("utf-8"),
            {"Content-Type": "text/html; charset=utf-8"},
        )


def build_app(
    config: AppConfig | None = None,
    overrides: dict | None = None,
    **dependencies,
) -> OmniRecallApp:
    """The app; ``device`` (default "cuda") goes to the engine and the
    local encoder."""
    if config is None:
        config = load_config(overrides=overrides)
    return OmniRecallApp(config, **dependencies)
