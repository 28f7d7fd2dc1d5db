"""The real-corpus campaign of the port (omni_recall_tpu_torch/eval/
real_corpus.py) against the JAX package's on the CPU.

pydoc renders the running interpreter's standard library, so the documents
are compared within this one process. Ingestion stamps upload times and the
JAX campaign scores recency at ``datetime.now``: both are frozen to one
clock here, so two runs score alike. Held: the documents equal JAX's, the
test subset's chunks (ids aside: documents take ``uuid4`` ids) and their
hash embeddings equal JAX's, the hash provider's recall@10 equal to JAX's
on the subset and on the whole corpus, and every query of the keyword-only
and hash providers served by the port's int8 engine (its plain versions
here) DTO-identical to the oracle."""

import datetime as dt

import pytest
import torch

import omni_recall_tpu.ingest.service as jingest
import omni_recall_tpu_torch.ingest.service as tingest
from omni_recall_tpu.eval import real_corpus as jreal
from omni_recall_tpu.models import hash_embedder as jhash
from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.eval import real_corpus
from omni_recall_tpu_torch.models import hash_embedder

SUBSET = ["json", "argparse", "re", "csv", "heapq", "textwrap"]
NOW = dt.datetime(2026, 9, 1, 12, 0, tzinfo=dt.timezone.utc)
REAL_DATETIME = dt.datetime


class FixedClock(REAL_DATETIME):
    @classmethod
    def now(cls, tz=None):
        return NOW


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    """One clock for both packages' ingestion."""
    monkeypatch.setattr(jingest, "datetime", FixedClock)
    monkeypatch.setattr(tingest, "datetime", FixedClock)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def docs():
    """pydoc's first render of a module in a process differs from the later
    ones (reading a class's ``__annotations__`` creates it, and the later
    renders list it), so the documents are rendered once before the render
    that is compared and used."""
    real_corpus.build_documents()
    return real_corpus.build_documents()


def _subset(docs):
    keep = {f"{m}.txt" for m in SUBSET}
    return [(f, t) for f, t in docs if f in keep], \
        [(q, e) for q, e in real_corpus.QUERIES if e in keep]


def test_documents_and_queries_are_jax_s(docs):
    assert docs == jreal.build_documents()
    assert real_corpus.MODULES == jreal.MODULES and real_corpus.QUERIES == jreal.QUERIES
    assert len(docs) == len(real_corpus.MODULES)
    # real prose, not stubs (the JAX test's check, on its subset)
    assert all(len(t.split()) > 300 for _, t in _subset(docs)[0])


def test_subset_chunks_are_jax_s(docs):
    sub, _ = _subset(docs)
    got = real_corpus.ingest_corpus(lambda t: hash_embedder.embed_text(t, real_corpus.DIM),
                                    docs=sub)
    want = jreal.ingest_corpus(lambda t: jhash.embed_text(t, jreal.DIM), docs=sub)

    def chunks(store):
        return [(d.file_name, d.chunk_count, [(c.chunk_index, c.content, c.embedding,
                                               c.created_at_utc, c.id.split(":")[1])
                                              for c in store.get_chunks_by_document_id(d.id)])
                for d in store.list_documents(100)]

    assert chunks(got) == chunks(want)
    assert {d.file_name for d in got.list_documents(100)} == {f for f, _ in sub}
    assert all(len(c[2]) > 3 for c in chunks(got))


@pytest.mark.parametrize("subset", [True, False], ids=["subset", "whole"])
def test_hash_recall_equals_jax(docs, subset):
    d, q = _subset(docs) if subset else (docs, real_corpus.QUERIES)
    got = real_corpus.recall_at_10(lambda t: hash_embedder.embed_text(t, real_corpus.DIM),
                                   docs=d, queries=q, now=NOW, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        # the JAX campaign's ``datetime.now``, imported inside its
        # recall_at_10 (only around the call: pydoc renders the datetime
        # module's classes, so the documents are built before)
        mp.setattr(dt, "datetime", FixedClock)
        want = jreal.recall_at_10(lambda t: jhash.embed_text(t, jreal.DIM), docs=d, queries=q)
    assert got == want
    assert got >= 0.6, got


@pytest.mark.parametrize("provider", ["none", "hash"])
def test_int8_engine_serves_the_campaign_as_the_oracle(docs, provider):
    """``device_options``: every query also through the int8 engine with
    the headline's features at the campaign's widths (d 64, 256 bits, m
    16): the keyword-only provider takes K5's plain version, hash K1's."""
    sub, queries = _subset(docs)
    fn = {"none": lambda t: [],
          "hash": lambda t: hash_embedder.embed_text(t, real_corpus.DIM)}[provider]
    record: dict = {}
    opts = EngineOptions(backend="pallas", scan_dtype="int8", recent_window=0,
                         embedding_dim=real_corpus.DIM, bloom_bits=256, capacity_block=512,
                         candidate_m=16, device_exact_cos=True, direct_select=True)
    rate = real_corpus.recall_at_10(fn, docs=sub, queries=queries, now=NOW, device="cpu",
                                    device_options=opts, record=record)
    assert record["queries"] == len(queries)
    assert not record["mismatches"], record["mismatches"][:1]
    assert record["device_recall"] == record["oracle_recall"] == rate


def test_campaign_needs_cuda_unless_cpu_is_asked(monkeypatch, docs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sub, queries = _subset(docs)
    with pytest.raises(RuntimeError, match="CUDA"):
        real_corpus.recall_at_10(lambda t: [], docs=sub, queries=queries)
    with pytest.raises(RuntimeError, match="CUDA"):
        real_corpus.evaluate_real_corpus(steps=1)
    from omni_recall_tpu_torch.tools import quality_real_corpus

    with pytest.raises(RuntimeError, match="CUDA"):
        quality_real_corpus.main(["--steps", "1"])


def test_training_texts_do_not_depend_on_the_embeddings(docs):
    """The campaign trains on the chunks of a store ingested without
    embeddings (``training_store``); the reference ingests them with the
    untrained encoder's. The chunks, and their order, are the same."""
    sub, _ = _subset(docs)

    def contents(store):
        return [c.content for d in store.list_documents(10**6)
                for c in store.get_chunks_by_document_id(d.id)]

    hashed = real_corpus.ingest_corpus(
        lambda t: hash_embedder.embed_text(t, real_corpus.DIM), docs=sub)
    bare = real_corpus.training_store(sub)
    assert contents(bare) == contents(hashed) and len(contents(bare)) > 50
