"""POST /api/documents/train on the port's app (omni_recall_tpu_torch), on
the CPU: the three tests of the JAX package's tests/test_train_route.py.

The route fine-tunes the local encoder on the ingested corpus
(models/finetune.py) and re-embeds everything through the reindex path.
The quality test ingests stdlib-documentation prose (the JAX package's
eval/real_corpus.py builds the documents and the queries) through the
upload route, measures recall@10 through the search route before and after
training, and requires the trained encoder to beat the untrained one and
reach 0.7.
"""

from __future__ import annotations

import pytest
import torch

from omni_recall_tpu.eval import real_corpus
from omni_recall_tpu_torch.config import load_config
from omni_recall_tpu_torch.ingest.embedding import LocalEncoderEmbeddingClient
from omni_recall_tpu_torch.models.encoder import EncoderConfig
from omni_recall_tpu_torch.server.app import build_app
from omni_recall_tpu_torch.server.testing import TestClient

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs in parallel worker processes, and these tensors are
    small: one intra-op thread a process (also in the threads the batcher
    and the ingestion start) keeps the workers from oversubscribing the
    cores (without it these files ran 20-75 times slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SUBSET = ["json", "argparse", "re", "csv", "heapq", "textwrap"]
DIM = 64
_CFG = EncoderConfig(vocab_size=4096, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                     max_len=48, out_dim=DIM)
_OVERRIDES = {
    "Embeddings:Provider": "Local",
    "Embeddings:Dim": DIM,
    "Embeddings:DeviceQuery": False,
    "Engine:EmbeddingDim": DIM,
    "Engine:Backend": "xla",
    "Engine:CapacityBlock": 512,
}


def _local_app():
    config = load_config(settings_file=None, env={}, overrides=_OVERRIDES)
    client = LocalEncoderEmbeddingClient(DIM, cfg=_CFG, device="cpu")
    app = build_app(config, embedding_client=client, device="cpu")
    return app, TestClient(app)


def _subset_docs():
    keep = {f"{m}.txt" for m in SUBSET}
    return [(f, t) for f, t in real_corpus.build_documents() if f in keep]


def _subset_queries():
    keep = {f"{m}.txt" for m in SUBSET}
    return [(q, e) for q, e in real_corpus.QUERIES if e in keep]


def _recall_at_10(client: TestClient, queries) -> float:
    hits = 0
    for question, expected in queries:
        resp = client.post("/api/recall/search", json_body={"query": question, "topK": 10})
        assert resp.status == 200
        hits += expected in {c["fileName"] for c in resp.json()["citations"]}
    return hits / len(queries)


def test_train_route_improves_recall_and_reembeds():
    app, client = _local_app()
    docs = _subset_docs()
    for file_name, text in docs:
        resp = client.upload("/api/documents/upload", filename=file_name,
                             data=text.encode("utf-8"), fields={"sourceType": "file"})
        assert resp.status == 201, resp.body
    queries = _subset_queries()
    assert len(queries) >= 8
    before = _recall_at_10(client, queries)

    resp = client.post("/api/documents/train", json_body={"steps": 120})
    assert resp.status == 200, resp.body
    body = resp.json()
    assert body["documentCount"] == len(docs)
    assert body["chunkCount"] > len(docs)  # multi-chunk documents
    assert body["embeddedCount"] == body["chunkCount"]
    assert body["failedCount"] == 0
    assert body["steps"] == 120
    assert "trained" in body["model"]

    after = _recall_at_10(client, queries)
    assert after > before, (before, after)
    assert after >= 0.7, (before, after)
    # the hot swap reached the serving client, and the index holds its rows
    assert "trained-120" in app.embedding_client.model
    chunks = sorted(app.store.get_chunks_by_document_id(app.store.list_documents(1)[0].id),
                    key=lambda c: c.chunk_index)
    want = app.embedding_client.embed_batch([c.content for c in chunks])
    assert [list(c.embedding) for c in chunks] == [r.vector for r in want]


def test_train_route_conflicts_without_local_provider():
    config = load_config(settings_file=None, env={},
                         overrides={"Engine:EmbeddingDim": 3, "Engine:Backend": "xla"})
    client = TestClient(build_app(config, device="cpu"))  # Embeddings:Provider=None
    resp = client.post("/api/documents/train", json_body={})
    assert resp.status == 409
    assert "not trainable" in resp.json()["title"]
    doc = client.get("/swagger/v1/swagger.json").json()
    assert "post" in doc["paths"]["/api/documents/train"]


def test_train_route_rejects_empty_corpus_and_bad_steps():
    _, client = _local_app()
    resp = client.post("/api/documents/train", json_body={})
    assert resp.status == 400  # nothing ingested yet
    for bad in ({"steps": 0}, {"steps": "many"}, {"steps": True}, {"seed": 1.5}):
        assert client.post("/api/documents/train", json_body=bad).status == 400, bad
    assert client.post("/api/documents/train", body=b"{not json").status == 400
