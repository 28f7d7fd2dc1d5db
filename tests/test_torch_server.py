"""The port's app (omni_recall_tpu_torch/server) in process on the CPU,
against the JAX app on the same inputs.

Both apps embed with the Hash provider and serve certified-exact search
over an int8 index (the JAX one runs its Pallas kernels in interpret mode),
or over a bf16 index, or with no Engine keys at all (the reference's
defaults: backend xla over f32 storage).
Responses must be equal up to generated ids and timestamps, which each app
draws itself; ids are compared through a per-app renaming, so references
between responses (a citation's documentId, a chunk's id) must line up too.
Both apps read one fixed clock on the ingest and search paths, so recency
scores are the same to the bit.
"""

import json
import re
from datetime import datetime, timezone

import pytest

import omni_recall_tpu.ingest.service as jingest
import omni_recall_tpu.search.engine as jengine
import omni_recall_tpu_torch.ingest.service as tingest
import omni_recall_tpu_torch.search.engine as tengine

from omni_recall_tpu.config import load_config as jload
from omni_recall_tpu.server.app import build_app as jbuild
from omni_recall_tpu.server.testing import TestClient as JClient
from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.config import load_config as tload
from omni_recall_tpu_torch.contracts import to_wire
from omni_recall_tpu_torch.search.engine import RecallEngine
from omni_recall_tpu_torch.search.service import RecallSearchService
from omni_recall_tpu_torch.server.app import build_app as tbuild
from omni_recall_tpu_torch.server.testing import TestClient as TClient

OVERRIDES = {
    "Embeddings:Provider": "Hash", "Embeddings:Dim": 64, "Engine:EmbeddingDim": 64,
    "Engine:Backend": "pallas", "Engine:ScanDtype": "int8", "Engine:Refine": "false",
    "Engine:DirectSelect": "true", "Engine:DeviceExactCos": "true",
    "Engine:CapacityBlock": 128, "Engine:BloomBits": 1024,
    "Ingestion:ChunkSizeWords": 20, "Ingestion:ChunkOverlapWords": 4,
}
DOCS = [
    ("hopper.md", b"# Hopper\nThe H100 reads device memory at terabytes per second. "
     b"Tensor cores multiply int8 tiles and shared memory holds the working set of "
     b"one block. Kernels written by hand control every rounding step and every load."),
    ("recall.txt", b"Certified exact recall ranks chunks by cosine similarity, keyword "
     b"overlap and recency. The certificate compares the kth exact score with the "
     b"largest upper bound of every excluded chunk, and widens the candidates when "
     b"it fails."),
    ("garden.txt", b"Tomatoes need sun and steady water. Basil grows beside them and "
     b"marigolds keep pests away from the beds in early summer; mulch keeps the soil "
     b"moist through August."),
]
QUERIES = ["tensor cores int8 tiles", "certificate upper bound candidates",
           "basil tomatoes water", "shared memory rounding", "recency keyword cosine"]
_ID_KEY = re.compile(r"(^id$|Id$)")
_TIME_KEY = re.compile(r"(At|AtUtc|Utc)$")


class _Renamer:
    def __init__(self):
        self.names: dict[str, str] = {}

    def __call__(self, value):
        return self.names.setdefault(value, f"id{len(self.names)}")


def _normalize(obj, rename):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if _TIME_KEY.search(k):
                out[k] = "<time>" if v is not None else None
            elif _ID_KEY.search(k) and isinstance(v, str):
                out[k] = rename(v)
            else:
                out[k] = _normalize(v, rename)
        return out
    if isinstance(obj, list):
        return [_normalize(v, rename) for v in obj]
    return obj


def _run(client, rename):
    """Drive one app; returns the normalized (status, body) transcript."""
    log = []

    def record(resp):
        body = resp.json() if resp.body else None
        log.append((resp.status, _normalize(body, rename)))
        return body

    doc_ids = []
    for name, data in DOCS:
        doc_ids.append(record(client.upload("/api/documents/upload", filename=name,
                                            data=data))["documentId"])
    for q in QUERIES:
        record(client.post("/api/recall/search", json_body={"query": q, "topK": 4}))
    record(client.get("/api/documents"))
    for doc_id in doc_ids:
        record(client.get(f"/api/documents/{doc_id}"))
        record(client.get(f"/api/documents/{doc_id}/chunks"))
    record(client.delete(f"/api/documents/{doc_ids[1]}"))
    for q in QUERIES[:3]:
        record(client.post("/api/recall/search", json_body={"query": q, "topK": 10}))
    # probes
    record(client.post("/api/recall/search", json_body={"query": "  "}))           # 400
    record(client.post("/api/recall/search", body=b"{not json",
                       headers={"content-type": "application/json"}))          # 400
    record(client.get(f"/api/documents/{doc_ids[1]}"))                          # 404
    record(client.get("/api/recall/search"))                                     # 405
    record(client.upload("/api/documents/upload", filename="x.exe", data=b"MZ"))  # 415
    return log


class _FixedClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2026, 9, 1, 12, 0, tzinfo=timezone.utc)


@pytest.fixture(scope="module")
def transcripts():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jingest, jengine, tingest, tengine):
            mp.setattr(module, "datetime", _FixedClock)
        japp = jbuild(jload(settings_file=None, env={}, overrides=OVERRIDES))
        tapp = tbuild(tload(settings_file=None, env={}, overrides=OVERRIDES), device="cpu")
        yield _run(JClient(japp), _Renamer()), _run(TClient(tapp), _Renamer()), tapp


def test_responses_equal_the_jax_app(transcripts):
    jlog, tlog, _ = transcripts
    assert len(jlog) == len(tlog)
    for (js, jb), (ts, tb) in zip(jlog, tlog):
        assert ts == js
        assert tb == jb


def test_probe_status_codes(transcripts):
    _, tlog, _ = transcripts
    assert [s for s, _ in tlog[-5:]] == [400, 400, 404, 405, 415]
    assert [s for s, _ in tlog[:3]] == [201, 201, 201]


def test_searches_return_citations_and_metrics(transcripts):
    _, tlog, tapp = transcripts
    searches = [b for s, b in tlog[3:3 + len(QUERIES)]]
    assert all(b["citations"] for b in searches)
    assert tapp.engine.stats["searches_total"] == len(QUERIES) + 3
    client = TClient(tapp)
    metrics = client.get("/metrics")
    assert metrics.status == 200
    text = metrics.body.decode()
    assert f"omni_searches_total {len(QUERIES) + 3}" in text
    # every engine counter, and no span totals with tracing off
    for key, value in tapp.engine.stats.items():
        assert f"# TYPE omni_{key} counter\nomni_{key} {value}\n" in text
    assert "omni_span" not in text
    health = client.get("/health").json()
    assert any(d["name"] == "tpu-engine" for d in health["dependencies"])


def test_tracing_exports_span_totals_on_metrics():
    """``Engine:Tracing`` turns the recorder on: /metrics adds each span's
    count, wall and CPU seconds as counters, over the coalescer's path."""
    from omni_recall_tpu_torch.utils import tracing

    tracing.disable()
    overrides = {**OVERRIDES, "Engine:Tracing": "true", "Engine:CoalesceWindowMs": 1}
    tapp = None
    try:
        tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
        assert tracing.enabled()
        client = TClient(tapp)
        for name, data in DOCS:
            assert client.upload("/api/documents/upload", filename=name, data=data).status == 201
        for q in QUERIES:
            assert client.post("/api/recall/search",
                               json_body={"query": q, "topK": 4}).status == 200
        text = client.get("/metrics").body.decode()
        totals = tracing.totals()
        kept = tracing.records()
    finally:
        tracing.disable()
        if tapp is not None and tapp.search_executor is not None:
            tapp.search_executor.close()
    lines = dict(line.rsplit(" ", 1) for line in text.splitlines() if not line.startswith("#"))
    assert int(lines["omni_searches_total"]) == len(QUERIES)
    for name in ("coalesce.collect", "engine.dispatch", "engine.finalize", "finalize.wait"):
        count, wall, cpu = totals[name]
        assert int(lines[f'omni_span_count_total{{span="{name}"}}']) == count > 0
        assert float(lines[f'omni_span_wall_seconds_total{{span="{name}"}}']) == wall > 0
        assert float(lines[f'omni_span_cpu_seconds_total{{span="{name}"}}']) == cpu
    # the server keeps the totals alone: no rows, so nothing to drop
    assert "omni_span_dropped_total" not in lines
    assert kept["name"].size == 0 and kept["dropped"] == 0 and kept["threads"] == {}


@pytest.mark.parametrize("direct", ["true", "false"])
def test_refine_configuration_responses_equal_the_jax_app(direct):
    """Engine:Refine=true (the reference's default: residual planes, K3),
    with the direct selection and with the refine selection."""
    overrides = {**OVERRIDES, "Engine:Refine": "true", "Engine:DirectSelect": direct}
    with pytest.MonkeyPatch.context() as mp:
        for module in (jingest, jengine, tingest, tengine):
            mp.setattr(module, "datetime", _FixedClock)
        japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
        tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
        assert tapp.engine.device_index.refine
        jlog, tlog = _run(JClient(japp), _Renamer()), _run(TClient(tapp), _Renamer())
    assert tlog == jlog


def test_sharded_app_responses_equal_shards_0_and_the_jax_app():
    """Engine:Shards=2 (two CPU shards on the port, two virtual devices on
    the JAX side) with the refine planes, refine selection and device-exact
    cosine: the transcript equals the port's Shards=0 app and the JAX
    sharded app."""
    overrides = {**OVERRIDES, "Engine:Refine": "true", "Engine:CapacityBlock": 512,
                 "Engine:Shards": 2}
    with pytest.MonkeyPatch.context() as mp:
        for module in (jingest, jengine, tingest, tengine):
            mp.setattr(module, "datetime", _FixedClock)
        japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
        tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
        single = tbuild(tload(settings_file=None, env={},
                              overrides={**overrides, "Engine:Shards": 0}), device="cpu")
        assert tapp.engine.device_index.mesh.n_shards == 2
        assert single.engine.device_index.mesh is None
        logs = [_run(client, _Renamer())
                for client in (JClient(japp), TClient(tapp), TClient(single))]
    assert logs[1] == logs[0]
    assert logs[1] == logs[2]
    assert any(k[0] == "refine_select_dd" for k in tapp.engine._sharded_scorer.calls)


def test_ocr_provider_builds_the_extractor():
    """Ocr:Provider=DocumentIntelligence (or AzureDocumentIntelligence) builds
    the Document Intelligence extractor as the JAX app does; None and
    unknown names keep the no-op extractor."""
    from omni_recall_tpu.extract.ocr import DocumentIntelligenceOcrTextExtractor as JOcr
    from omni_recall_tpu_torch.extract.ocr import DocumentIntelligenceOcrTextExtractor as TOcr

    for provider, built in (("DocumentIntelligence", True), ("AzureDocumentIntelligence", True),
                            ("Tesseract", False), ("None", False)):
        overrides = {**OVERRIDES, "Ocr:Provider": provider, "Ocr:Endpoint": "https://ocr.invalid",
                     "Ocr:ApiKey": "k"}
        tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
        japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
        tocr, jocr = tapp.pdf_extractor.ocr, japp.pdf_extractor.ocr
        assert isinstance(tocr, TOcr) is built and isinstance(jocr, JOcr) is built
        assert type(tocr).__name__ == type(jocr).__name__
        assert tapp.pdf_extractor.min_chars == japp.pdf_extractor.min_chars


def _apps(overrides):
    with pytest.MonkeyPatch.context() as mp:
        for module in (jingest, jengine, tingest, tengine):
            mp.setattr(module, "datetime", _FixedClock)
        japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
        tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
        jlog, tlog = _run(JClient(japp), _Renamer()), _run(TClient(tapp), _Renamer())
        oracle = RecallSearchService(
            RecallEngine(tapp.store, None, EngineOptions(
                backend="oracle", recent_window=tapp.config.engine.recent_window),
                device="cpu"),
            tapp.embedding_client,
        )
        client = TClient(tapp)
        for q in QUERIES:
            got = client.post("/api/recall/search", json_body={"query": q, "topK": 4}).json()
            assert got == json.loads(json.dumps(to_wire(oracle.search(q, 4)))), q
    return tapp, jlog, tlog


def test_server_with_no_engine_keys_serves_the_reference_defaults():
    """No Engine keys at all: the reference's defaults (backend xla over f32
    storage, 768 dims, 2048 bloom bits). Uploads and searches equal the JAX
    app's, and every search equals the oracle backend's response."""
    tapp, jlog, tlog = _apps({"Embeddings:Provider": "Hash",
                              "Ingestion:ChunkSizeWords": 20,
                              "Ingestion:ChunkOverlapWords": 4})
    engine = tapp.engine
    assert engine.options.backend == "xla" and engine.device_index.scan_dtype == "f32"
    assert engine.stats["searches_total"] > 0
    assert tlog == jlog


def test_bf16_scan_storage_serves():
    """Engine:ScanDtype=bf16 under the pallas backend (K6)."""
    tapp, jlog, tlog = _apps({**OVERRIDES, "Engine:ScanDtype": "bf16"})
    assert tapp.engine.device_index.scan_dtype == "bf16"
    assert tlog == jlog


@pytest.mark.parametrize("method, path, title", [
    ("POST", "/api/documents/train", "Local models"),
])
def test_unported_routes_answer_501_naming_their_roadmap_item(method, path, title):
    """The route that once answered 501 (naming ROADMAP.md's "Local models")
    is served now: with a provider that cannot be trained both apps answer
    the same 409 problem, never 404, 405 or 501 (POST /api/documents/train
    must not fall through to /api/documents/{document_id})."""
    tclient = TClient(tbuild(tload(settings_file=None, env={}, overrides=OVERRIDES),
                             device="cpu"))
    jclient = JClient(jbuild(jload(settings_file=None, env={}, overrides=OVERRIDES)))
    tresp, jresp = (c.post(path, json_body={}) for c in (tclient, jclient))
    assert tresp.status == jresp.status == 409
    assert tresp.json() == jresp.json()
    assert title not in tresp.json()["detail"]
    bad = [(c.post(path, json_body={"steps": 0}).status) for c in (tclient, jclient)]
    assert bad == [400, 400]


class _ScriptedChat:
    """A chat client that answers every prompt with the same cited text."""

    def __init__(self, contracts):
        self.contracts = contracts
        self.prompts = []

    def complete(self, request):
        self.prompts.append(request.prompt)
        return self.contracts.AiChatResponse(
            text="Tensor cores multiply int8 tiles [1].\n\n The certificate  compares "
                 "bounds [2] [7].", model="scripted-1", provider="Scripted")


CHAT_PROMPTS = ["how do tensor cores multiply int8 tiles?",
                "what does the certificate compare?", "basil and tomatoes", "   "]


def _chat_transcript(client, rename):
    log = []
    for name, data in DOCS:
        client.upload("/api/documents/upload", filename=name, data=data)
    for prompt in CHAT_PROMPTS:
        resp = client.post("/api/chat", json_body={"prompt": prompt, "topK": 3})
        log.append((resp.status, _normalize(resp.json(), rename)))
    resp = client.post("/api/chat", body=b"{not json", headers={"content-type": "application/json"})
    log.append((resp.status, _normalize(resp.json(), rename)))
    return log


@pytest.mark.parametrize("method, path", [
    ("POST", "/api/chat"),
    ("GET", "/swagger/v1/swagger.json"),
    ("GET", "/swagger"),
    ("GET", "/"),
])
def test_ported_routes_answer_as_the_jax_app(method, path):
    """Chat, the OpenAPI document, the API docs page and the UI page answer
    as the JAX app's routes: POST /api/chat the same DTOs under the same
    scripted chat client and, with the default remote chain and no keys,
    the same recall-only fallback; the documents and pages byte for byte."""
    import omni_recall_tpu.contracts as jcontracts
    import omni_recall_tpu_torch.contracts as tcontracts

    with pytest.MonkeyPatch.context() as mp:
        for module in (jingest, jengine, tingest, tengine):
            mp.setattr(module, "datetime", _FixedClock)
        if method == "GET":
            japp = jbuild(jload(settings_file=None, env={}, overrides=OVERRIDES))
            tapp = tbuild(tload(settings_file=None, env={}, overrides=OVERRIDES), device="cpu")
            jresp, tresp = JClient(japp).get(path), TClient(tapp).get(path)
            assert tresp.status == jresp.status == 200
            assert tresp.body == jresp.body

            def headers(resp):  # the response time is each app's own
                return {k: v for k, v in resp.headers.items() if k != "X-Response-Time-Ms"}
            assert headers(tresp) == headers(jresp)
            if path.endswith(".json"):
                assert tresp.json() == jresp.json() and "/api/chat" in tresp.json()["paths"]
            return
        jchat, tchat = _ScriptedChat(jcontracts), _ScriptedChat(tcontracts)
        japp = jbuild(jload(settings_file=None, env={}, overrides=OVERRIDES), chat_router=jchat)
        tapp = tbuild(tload(settings_file=None, env={}, overrides=OVERRIDES),
                      chat_router=tchat, device="cpu")
        jlog = _chat_transcript(JClient(japp), _Renamer())
        tlog = _chat_transcript(TClient(tapp), _Renamer())
        assert tlog == jlog and tchat.prompts == jchat.prompts
        assert any(body.get("provider") == "Scripted" for status, body in tlog if status == 200)
        # the default remote chain with no API keys: the reference's fallback
        japp = jbuild(jload(settings_file=None, env={}, overrides=OVERRIDES))
        tapp = tbuild(tload(settings_file=None, env={}, overrides=OVERRIDES), device="cpu")
        jlog = _chat_transcript(JClient(japp), _Renamer())
        tlog = _chat_transcript(TClient(tapp), _Renamer())
        assert tlog == jlog


def test_remote_embedding_provider_is_built():
    """Embeddings:Provider=Gemini builds the Gemini client (no call is made
    at construction), as the JAX app does; the dim goes to its requests."""
    from omni_recall_tpu_torch.ingest.embedding import GeminiEmbeddingClient

    overrides = {**OVERRIDES, "Embeddings:Provider": "Gemini"}
    tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
    japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
    assert isinstance(tapp.embedding_client, GeminiEmbeddingClient)
    assert type(japp.embedding_client).__name__ == "GeminiEmbeddingClient"
    assert tapp.embedding_client.output_dim == japp.embedding_client.output_dim == 64
    assert tapp.search_service.device_query is False


def test_local_chat_provider_not_ported_raises():
    """Ai:Provider=Local, once refused at construction, is served now: the
    app builds the on-card decoder as the primary chat client with the
    remote router nested as its fallback, as the JAX app does."""
    overrides = {**OVERRIDES, "Ai:Provider": "Local", "Ai:LocalWarmup": "false",
                 "Ai:LocalMaxNewTokens": "4"}
    tapp = tbuild(tload(settings_file=None, env={}, overrides=overrides), device="cpu")
    japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
    for app in (tapp, japp):
        assert app.chat_router._primary.provider_name == "local"
        assert type(app.chat_router._fallback).__name__ == "AiChatRouter"
    assert tapp.chat_router._primary.max_new_tokens == japp.chat_router._primary.max_new_tokens
    remote = tload(settings_file=None, env={}, overrides={**OVERRIDES, "Ai:Provider": "Remote"})
    assert tbuild(remote, device="cpu").config.ai.provider == "Remote"


def _snapshot_app(snapshot_dir, overrides=OVERRIDES):
    config = tload(settings_file=None, env={}, overrides={
        **overrides, "Storage:SnapshotDir": str(snapshot_dir)})
    return tbuild(config, device="cpu")


def test_snapshot_route_answers_409_without_a_directory():
    """POST /api/snapshot answers the reference's 409 problem when no
    Storage:SnapshotDir is configured."""
    client = TClient(tbuild(tload(settings_file=None, env={}, overrides=OVERRIDES),
                            device="cpu"))
    resp = client.post("/api/snapshot", json_body={})
    assert resp.status == 409
    body = resp.json()
    assert body["status"] == 409 and "Storage:SnapshotDir" in body["detail"]


def test_snapshot_route_saves_and_a_restart_restores(tmp_path):
    """POST /api/snapshot saves the store and the device slabs (200 with
    path, documents and chunks); a second app on the same directory restores
    the same documents and chunks through the slab fast path and answers
    the same searches."""
    app = _snapshot_app(tmp_path / "snap")
    assert app.restore_route is None  # nothing to restore yet
    client = TClient(app)
    for name, data in DOCS:
        assert client.upload("/api/documents/upload", filename=name, data=data).status == 201
    before = [client.post("/api/recall/search", json_body={"query": q, "topK": 3}).json()
              for q in QUERIES]
    resp = client.post("/api/snapshot", json_body={})
    assert resp.status == 200
    body = resp.json()
    chunks = sum(d.chunk_count for d in app.store.list_documents(100))
    assert body == {"path": str(tmp_path / "snap" / "snapshot.d"),
                    "documents": len(DOCS), "chunks": chunks}
    assert chunks > len(DOCS)

    again = _snapshot_app(tmp_path / "snap")
    assert again.restore_route == "slabs"
    assert len(again.store.list_documents(100)) == len(DOCS)
    assert again.engine.device_index.n_rows == chunks
    client2 = TClient(again)
    docs = client2.get("/api/documents").json()
    assert sorted(d["fileName"] for d in docs) == sorted(name for name, _ in DOCS)
    after = [client2.post("/api/recall/search", json_body={"query": q, "topK": 3}).json()
             for q in QUERIES]
    assert after == before


def test_snapshot_restore_boots_empty_on_a_malformed_archive(tmp_path):
    (tmp_path / "snapshot.d").mkdir()
    (tmp_path / "snapshot.d" / "meta.json").write_text("{not json")
    app = _snapshot_app(tmp_path)
    assert app.restore_route is None and app.store.list_documents(10) == []


def test_snapshot_restore_raises_on_a_device_error(tmp_path, monkeypatch):
    """A failure of the card during the restore is not a malformed archive:
    the app does not boot empty over it."""
    import torch

    from omni_recall_tpu_torch.index import snapshot as snap

    app = _snapshot_app(tmp_path)
    TClient(app).upload("/api/documents/upload", filename=DOCS[0][0], data=DOCS[0][1])
    assert TClient(app).post("/api/snapshot", json_body={}).status == 200

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(snap, "restore_engine", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _snapshot_app(tmp_path)
