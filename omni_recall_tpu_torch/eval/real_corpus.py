"""Retrieval quality on a REAL text corpus (PyTorch port of
omni_recall_tpu/eval/real_corpus.py).

The synthetic quality campaign (eval/quality.py) demonstrates the
train-your-own-memory-embedder workflow on a generated cluster corpus; it
says nothing about real-corpus quality. This module runs the same
recall@10 measurement on real public prose: the Python standard library's
documentation (pydoc plain-text rendering of ~40 modules, rendered from the
running interpreter, no download), ingested through the NORMAL upload path
(ingest/service.py: chunker, dedupe, embedding client, store append — the
same code path as POST /api/documents/upload), and queried with
hand-written natural questions whose ground truth is the module each asks
about.

Providers measured (same roster as eval/quality.py, plus the keyword-only
baseline):
- ``none`` — no embeddings (Embeddings:Provider=None): the bloom keyword
  signal alone,
- ``hash`` — feature-hashed bag-of-words (models/hash_embedder.py),
- ``local-untrained`` — the transformer encoder at its seed init,
- ``local-trained`` — the encoder fine-tuned ON THE INGESTED CORPUS with
  the self-supervised inverse-cloze objective (models/finetune.py, the
  engine of POST /api/documents/train) — no eval question is ever seen at
  training time.

Scoring runs through the exact oracle engine, so differences are
attributable to the embeddings alone. Given ``device_options``, every
query is also served by a device engine with those options over the same
store, and its hits are held to the oracle's (``recall_at_10``'s
``record``). Ingestion stamps real upload times and queries score recency
at ``now`` (default ``datetime.now``): freeze both wherever two runs are
compared. Every entry point runs on CUDA unless the caller asks for the
CPU. Reference eval semantics:
src/OmniRecall.App/src/app/pages/eval/eval.page.ts:108-175 (expected file
in top-10 citations).
"""

from __future__ import annotations

from omni_recall_tpu_torch.config import EngineOptions, IngestionOptions
from omni_recall_tpu_torch.search.engine import RecallEngine

DIM = 64

# ~40 stdlib modules with substantial prose documentation. Each becomes one
# document "<name>.txt" through the normal upload path.
MODULES = [
    "json", "argparse", "re", "sqlite3", "smtplib", "datetime", "pathlib",
    "itertools", "functools", "collections", "subprocess", "threading",
    "asyncio", "logging", "unittest", "csv", "pickle", "gzip", "hashlib",
    "socket", "struct", "random", "math", "statistics", "decimal",
    "fractions", "heapq", "bisect", "array", "copy", "enum", "dataclasses",
    "typing", "inspect", "traceback", "tempfile", "shutil", "glob",
    "base64", "textwrap", "difflib", "queue",
]

# Natural-language eval cases: (question, expected document). Written to
# range from keyword-adjacent to fully paraphrased — real queries do both.
QUERIES: list[tuple[str, str]] = [
    ("how do I parse a JSON string into python objects", "json.txt"),
    ("serialize a dictionary to a JSON formatted file", "json.txt"),
    ("build a command line interface with flags and positional arguments",
     "argparse.txt"),
    ("print a usage and help message for my script options", "argparse.txt"),
    ("search text with a regular expression pattern", "re.txt"),
    ("substitute every match of a pattern in a string", "re.txt"),
    ("store rows in an embedded SQL database file", "sqlite3.txt"),
    ("execute a select query and fetch the results", "sqlite3.txt"),
    ("send an email message through an SMTP server", "smtplib.txt"),
    ("work with calendar dates and time differences", "datetime.txt"),
    ("format a timestamp as an ISO 8601 string", "datetime.txt"),
    ("object oriented filesystem paths and joining directories",
     "pathlib.txt"),
    ("chain several iterators together lazily", "itertools.txt"),
    ("cartesian product and permutations of sequences", "itertools.txt"),
    ("cache the results of an expensive function call", "functools.txt"),
    ("reduce a sequence with a binary function", "functools.txt"),
    ("a dictionary that remembers insertion order with a default value",
     "collections.txt"),
    ("count occurrences of elements in a list", "collections.txt"),
    ("run an external program and capture its output", "subprocess.txt"),
    ("spawn a shell command with a timeout", "subprocess.txt"),
    ("run code concurrently with locks and worker threads", "threading.txt"),
    ("coroutines with async and await event loop", "asyncio.txt"),
    ("write diagnostic messages with severity levels to a file",
     "logging.txt"),
    ("write unit tests with assertions and fixtures", "unittest.txt"),
    ("read comma separated values with a header row", "csv.txt"),
    ("save a python object to disk and load it back", "pickle.txt"),
    ("compress a file with the gzip format", "gzip.txt"),
    ("compute the SHA-256 digest of some bytes", "hashlib.txt"),
    ("open a TCP connection to a host and port", "socket.txt"),
    ("pack binary data into bytes with a format string", "struct.txt"),
    ("shuffle a list and draw a random sample", "random.txt"),
    ("trigonometric functions and square roots", "math.txt"),
    ("compute the mean median and standard deviation of data",
     "statistics.txt"),
    ("exact decimal arithmetic for money amounts", "decimal.txt"),
    ("arithmetic with exact rational numbers", "fractions.txt"),
    ("a priority queue that always pops the smallest item", "heapq.txt"),
    ("insert into a sorted list keeping it sorted", "bisect.txt"),
    ("a compact typed sequence of numeric values", "array.txt"),
    ("deep copy a nested data structure", "copy.txt"),
    ("define symbolic names bound to constant values", "enum.txt"),
    ("generate init and repr automatically for a class holding fields",
     "dataclasses.txt"),
    ("annotate function signatures with generic types", "typing.txt"),
    ("get the signature and source of a live function", "inspect.txt"),
    ("print the stack trace of an exception", "traceback.txt"),
    ("create a temporary file that deletes itself", "tempfile.txt"),
    ("recursively copy and remove directory trees", "shutil.txt"),
    ("find files matching a wildcard pattern", "glob.txt"),
    ("encode bytes as printable ASCII text", "base64.txt"),
    ("wrap a long paragraph to a fixed line width", "textwrap.txt"),
    ("compare two sequences and show a readable diff", "difflib.txt"),
    ("pass items between producer and consumer threads safely",
     "queue.txt"),
]


def build_documents() -> list[tuple[str, str]]:
    """(file_name, text) for each module: the pydoc plain-text rendering —
    real human-written prose (docstrings), rendered exactly as `pydoc`
    shows users."""
    import importlib
    import pydoc

    docs = []
    for name in MODULES:
        mod = importlib.import_module(name)
        txt = pydoc.plain(pydoc.render_doc(mod))
        docs.append((f"{name}.txt", txt))
    return docs


class _CallableClient:
    """Minimal embedding client for the ingestion service: wraps an
    ``embed(text) -> list[float]`` callable in the EmbeddingResult
    protocol."""

    def __init__(self, fn):
        from omni_recall_tpu_torch.ingest.embedding import (
            EmbeddingResult,
            EmbeddingStatus,
        )

        self._fn = fn
        self._ok = EmbeddingStatus.SUCCESS
        self._mk = EmbeddingResult

    def embed(self, text: str):
        return self._mk(vector=self._fn(text), status=self._ok)


def ingest_corpus(embed_fn, docs=None):
    """Ingest the real corpus through the NORMAL upload path
    (DocumentIngestionService.ingest: chunker 120/24, SHA-256 dedupe,
    embedding client, store append). Returns the populated store."""
    from omni_recall_tpu_torch.index.store import (
        InMemoryIngestionStore,
        InMemoryRawDocumentStore,
    )
    from omni_recall_tpu_torch.ingest.service import DocumentIngestionService

    store = InMemoryIngestionStore()
    service = DocumentIngestionService(
        store, InMemoryRawDocumentStore(), _CallableClient(embed_fn),
        IngestionOptions(max_upload_bytes=10 * 1024 * 1024),
    )
    for file_name, text in docs or build_documents():
        service.ingest(file_name, text, "text/plain")
    return store


def training_store(docs):
    """The fine-tune's texts: the chunks of the normally-ingested corpus.
    The reference ingests them with the untrained encoder's embeddings,
    which training never reads; the chunks are the same without them."""
    return ingest_corpus(lambda text: [], docs=docs)


def finetune_encoder_real(
    store, cfg=None, steps: int = 300, seed: int = 0, batch: int = 64, device="cuda",
):
    """Inverse-cloze contrastive fine-tune on the ingested corpus
    (models/finetune.py — shared with the POST /api/documents/train route
    so the campaign measures exactly what the route ships), on ``device``.
    Self-supervised — the eval questions are never seen. Returns (params,
    cfg)."""
    from omni_recall_tpu_torch.eval.quality import encoder_config
    from omni_recall_tpu_torch.models.finetune import inverse_cloze_finetune

    cfg = cfg or encoder_config()  # the campaigns' small encoder, out_dim DIM
    contents: list[str] = []
    for doc in store.list_documents(10**6):
        for c in store.get_chunks_by_document_id(doc.id):
            contents.append(c.content)
    params = inverse_cloze_finetune(
        contents, cfg, steps=steps, seed=seed, batch=batch, device=device
    )
    return params, cfg


def _dto(hits) -> list[tuple[str, float]]:
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


def _files(store, hits) -> set[str]:
    files = set()
    for h in hits:
        doc = store.get_document(h.chunk.document_id)
        if doc:
            files.add(doc.file_name)
    return files


def recall_at_10(embed_fn, docs=None, queries=None, now=None, device="cuda",
                 device_options: EngineOptions | None = None,
                 record: dict | None = None) -> float:
    """Expected file in the top-10 citations (reference eval semantics),
    through the exact oracle engine over the normally-ingested corpus,
    scored at ``now`` (default: ``datetime.now``). With ``device_options``
    a device engine over the same store serves every query too; ``record``
    (a dict) then receives {queries, oracle_recall, device_recall,
    mismatches: [(question, oracle DTO, device DTO)]}, the DTO being the
    hits' chunk ids and 4-decimal scores."""
    from datetime import datetime, timezone

    store = ingest_corpus(embed_fn, docs=docs)
    engine = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=0), device=device
    )
    device_engine = None
    if device_options is not None:
        device_engine = RecallEngine(store, options=device_options, device=device)
        device_engine.on_chunks_upserted(
            [c for d in store.list_documents(10**6)
             for c in store.get_chunks_by_document_id(d.id)], new=True)
    now = now or datetime.now(timezone.utc)
    hits = device_hits = 0
    mismatches = []
    queries = queries or QUERIES
    for question, expected in queries:
        vector = embed_fn(question)
        res = engine.search(question, vector, 10, now=now)
        hits += expected in _files(store, res)
        if device_engine is not None:
            got = device_engine.search(question, vector, 10, now=now)
            device_hits += expected in _files(store, got)
            if _dto(got) != _dto(res):
                mismatches.append((question, _dto(res), _dto(got)))
    if device_engine is not None and record is not None:
        record.update(queries=len(queries), oracle_recall=hits / len(queries),
                      device_recall=device_hits / len(queries), mismatches=mismatches)
    return hits / len(queries)


def evaluate_real_corpus(steps: int = 300, seed: int = 0, now=None, device="cuda",
                         device_options: EngineOptions | None = None,
                         records: dict | None = None, docs=None) -> dict[str, float]:
    """recall@10 per provider on the real corpus. Run via
    ``python -m omni_recall_tpu_torch.tools.quality_real_corpus``; numbers
    belong in the README. ``now``, ``device_options`` and ``records`` (a
    dict: a record per provider) go to ``recall_at_10``. ``docs`` defaults
    to ``build_documents()``: pass one rendering to runs that are compared,
    since pydoc's first rendering of a module in a process differs from the
    later ones."""
    from omni_recall_tpu_torch.device import resolve_device
    from omni_recall_tpu_torch.eval.quality import encoder_config, encoder_embed_fn
    from omni_recall_tpu_torch.models import encoder as enc
    from omni_recall_tpu_torch.models import hash_embedder

    dev = resolve_device(device)
    docs = docs or build_documents()
    results: dict[str, float] = {}

    def recall(name, fn):
        rec: dict = {}
        results[name] = recall_at_10(fn, docs=docs, now=now, device=dev,
                                     device_options=device_options, record=rec)
        if records is not None:
            records[name] = rec

    # keyword-only baseline (Embeddings:Provider=None, the out-of-box
    # config): cosine is exactly 0 everywhere — on this corpus the bloom
    # keyword signal alone is strong (module names and API words appear
    # verbatim in queries), so embedding providers must BEAT this to be
    # worth their cost
    recall("none", lambda text: [])
    recall("hash", lambda text: hash_embedder.embed_text(text, DIM))
    cfg = encoder_config()
    recall("local-untrained", encoder_embed_fn(enc.init_params(seed, cfg), cfg, dev))
    trained = finetune_encoder_real(training_store(docs), cfg=cfg, steps=steps, seed=seed,
                                    device=dev)[0]
    recall("local-trained", encoder_embed_fn(trained, cfg, dev))
    return results


def main() -> None:  # pragma: no cover - CLI convenience
    import json

    print(json.dumps(evaluate_real_corpus(), indent=1))


if __name__ == "__main__":
    main()
