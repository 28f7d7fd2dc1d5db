"""The self-contained deployment's serving corpus: a fine-tuned local encoder
embeds both the rows and the queries (counterpart of the repository's
``bench.py build_localq_engine``).

The bench's recipe, step by step:

- the corpus: ``"topic c{k}x note r{i}"`` for n rows, cluster ``k`` drawn by
  ``default_rng(7)`` over max(256, n // 24) clusters (about 24 rows a
  cluster token),
- the fine-tune (``finetune``): from the seed-0 init, 600 AdamW(3e-4) steps
  of 256 inverse-cloze pairs ``"c{k}x"`` -> the row's content, rows drawn
  by ``default_rng(3)``,
- the index: the rows embedded by the trained encoder, days spread evenly
  over a year (rounded to 3 places), the bench's engine options with the
  AUTO coarse layout (``coarse_sub = coarse_t = 0``), and the client
  attached to the engine (``attach_device_embedder``),
- the requests: ``"c{k}x"`` text-only queries, top-10.

``n`` and ``cfg`` are parameters; their defaults are the bench's (2^16 rows,
``LQ_CFG``: vocab 8192, d_model 128, 2 layers, max_len 32). Everything runs
on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta

import numpy as np

from omni_recall_tpu_torch.models.encoder import EncoderConfig

LQ_CFG = EncoderConfig(vocab_size=8192, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                       max_len=32, out_dim=768)
LQ_STEPS = 600
LQ_PAIRS = 256
SLAB = 4096


def corpus(n: int) -> tuple[np.ndarray, list[str], int]:
    """(cluster of each row, the rows' contents, the cluster count)."""
    n_clusters = max(256, n // 24)
    assign = np.random.default_rng(7).integers(0, n_clusters, size=n)
    return assign, [f"topic c{assign[i]}x note r{i}" for i in range(n)], n_clusters


def finetune(cfg: EncoderConfig, assign: np.ndarray, contents: list[str],
             steps: int = LQ_STEPS, device="cuda", on_step=None):
    """The bench's fine-tune: from the seed-0 init, ``steps`` AdamW(3e-4)
    steps of 256 pairs "c{k}x" -> content, rows by ``default_rng(3)``.
    Returns the trained state dict (on the device)."""
    from omni_recall_tpu_torch.models import encoder
    from omni_recall_tpu_torch.models.finetune import train_pairs

    rng = np.random.default_rng(3)

    def pairs(_step):
        rows = rng.integers(0, len(contents), size=LQ_PAIRS)
        return [f"c{assign[i]}x" for i in rows], [contents[i] for i in rows]

    return train_pairs(encoder.init_params(0, cfg), pairs, cfg, steps, lr=3e-4,
                       device=device, on_step=on_step)


def encode(client, contents: list[str], slab: int = SLAB) -> np.ndarray:
    """The rows' embeddings f32[n, out_dim], ``slab`` rows a forward."""
    out = np.empty((len(contents), client.dim), dtype=np.float32)
    for s0 in range(0, len(contents), slab):
        out[s0:s0 + slab] = client.embed_rows(contents[s0:s0 + slab])
    return out


def bench_options(n: int, d: int, bits: int):
    """The bench's localq engine options (tools/probe_localq.py's
    EngineOptions with the AUTO coarse layout)."""
    from omni_recall_tpu_torch.config import EngineOptions

    return EngineOptions(backend="pallas", embedding_dim=d, recent_window=0, candidate_m=128,
                         bloom_bits=bits, scan_dtype="int8",
                         capacity_block=max(8192, n // 64), device_exact_cos=True,
                         coarse_sub=0, coarse_t=0)


def load_engine(emb: np.ndarray, contents: list[str], opts, device="cuda"):
    """A RecallEngine over the rows (bulk-loaded, uploaded)."""
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.index.records import ChunkRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.ops import hashing
    from omni_recall_tpu_torch.search.engine import RecallEngine

    n = emb.shape[0]
    engine = RecallEngine(InMemoryIngestionStore(), options=opts, device=device)
    dix = engine.device_index
    bloom = hashing.chunk_signatures_batch([c.lower() for c in contents], dix.bloom_bits,
                                           dix.ngram, dix.bloom_hashes)
    days = np.round(np.linspace(0.0, 365.0, n), 3).astype(np.float32)
    cache: dict = {}
    meta = []
    for i in range(n):
        day = round(float(days[i]), 3)
        when = cache.get(day)
        if when is None:
            when = cache[day] = EPOCH + timedelta(days=day)
        meta.append(ChunkRecord(id=f"lq:{i}", document_id="lq", chunk_index=i,
                                content=contents[i], embedding=emb[i], created_at_utc=when,
                                seq=i))
    dix.bulk_load(emb, bloom, days, meta)
    dix.device_arrays()
    return engine


def build_localq_engine(n: int = 1 << 16, d: int = 768, bits: int = 1024, opts=None,
                        cfg: EncoderConfig | None = None, steps: int = LQ_STEPS,
                        device="cuda", timings: dict | None = None):
    """The bench's localq corpus and engine. Returns (engine,
    make_text_requests(seed, nb), n, client); ``timings`` (if given)
    receives the fine-tune, encode and index seconds and the losses."""
    from omni_recall_tpu_torch.ingest.embedding import LocalEncoderEmbeddingClient

    cfg = dataclasses.replace(cfg or LQ_CFG, out_dim=d)
    timings = timings if timings is not None else {}
    assign, contents, n_clusters = corpus(n)
    losses: list = []
    t0 = time.perf_counter()
    state = finetune(cfg, assign, contents, steps, device,
                     on_step=lambda i, loss: losses.append(loss))
    timings["losses"] = [float(x) for x in (losses[0], losses[-1])] if losses else []
    timings["finetune_s"] = time.perf_counter() - t0
    client = LocalEncoderEmbeddingClient(d, cfg=cfg, device=device)
    client.swap_params(state, tag=f"localq-{steps}")
    t0 = time.perf_counter()
    emb = encode(client, contents)
    timings["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    opts = dataclasses.replace(opts, coarse_sub=0, coarse_t=0) if opts is not None \
        else bench_options(n, d, bits)
    engine = load_engine(emb, contents, opts, device)
    engine.attach_device_embedder(client)
    timings["index_s"] = time.perf_counter() - t0

    def make_text_requests(seed: int, nb: int):
        r = np.random.default_rng(seed)
        return [(f"c{int(r.integers(n_clusters))}x", None, 10) for _ in range(nb)]

    return engine, make_text_requests, n, client
