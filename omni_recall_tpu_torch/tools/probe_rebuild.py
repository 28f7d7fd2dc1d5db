"""Where a shadow rebuild of the device index spends its time.

Counterpart of the repository's ``tools/probe_rebuild.py``: each stage of
``RecallEngine.rebuild_index`` timed apart on one store:

  fetch        the store's chunks of every document, sorted by seq
  append       a shadow DeviceIndex's append of them (bloom signatures,
               normalization, host mirrors)
  upload       that shadow's device planes (``device_arrays``: upload and
               quantize), ``trials`` times on fresh shadows
  rebuild      ``rebuild_index`` on an engine whose index holds none of the
               store's records: every row derived, then uploaded
  compact      ``rebuild_index`` again: every record is the index's own, so
               the planes are gathered on the device

``stages(engine)`` runs them on any engine over its store (the engine's
index is replaced by the two rebuilds); ``main`` builds the tool's store
(n random unit rows of d dims, one document, contents with 4096 keyword
tokens) and runs them on an empty engine over it.
``python -m omni_recall_tpu_torch.tools.probe_rebuild [--rows N] [--device cpu]``
prints one JSON line a stage (seconds and chunks/s) and a summary line.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import timedelta

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shadow(engine):
    from omni_recall_tpu_torch.index.device_index import DeviceIndex

    old = engine.device_index
    return DeviceIndex(
        old.dim, capacity_block=engine.options.capacity_block, bloom_bits=old.bloom_bits,
        ngram=old.ngram, bloom_hashes=old.bloom_hashes, scan_dtype=old.scan_dtype,
        refine=old.refine, exact_cos=old.exact_cos, device=old.device,
    )


def stages(engine, trials: int = 2) -> list[dict]:
    """The rebuild's stages on ``engine``'s store, each a record with its
    seconds and chunks/s; the rebuilds also carry their route."""
    device = engine.device_index.device
    out = []

    def timed(name, fn, n=None):
        _sync(device)
        t0 = time.perf_counter()
        value = fn()
        _sync(device)
        s = time.perf_counter() - t0
        rec = {"stage": name, "s": s}
        out.append(rec)
        return value, rec

    def fetch():
        chunks = []
        for doc in engine.store.list_documents(2**31 - 1):
            chunks.extend(engine.store.get_chunks_by_document_id(doc.id))
        chunks.sort(key=lambda c: c.seq)
        return chunks

    fetched, _ = timed("fetch", fetch)
    shadow = _shadow(engine)
    timed("append", lambda: shadow.append(fetched))
    del shadow
    for trial in range(trials):
        shadow = _shadow(engine)
        shadow.append(fetched)
        _, rec = timed("upload", shadow.device_arrays)
        rec["trial"] = trial
        del shadow
    route, rec = timed("rebuild", engine.rebuild_index)
    rec["route"] = route
    engine.device_index.device_arrays()
    route, rec = timed("compact", engine.rebuild_index)
    rec["route"] = route
    for rec in out:
        rec["rows"] = len(fetched)
        rec["chunks_per_s"] = len(fetched) / rec["s"] if rec["s"] > 0 else None
    return out


def build_engine(n: int, d: int = 768, bits: int = 1024, device="cuda"):
    """The tool's store (n random unit rows, one document) under an engine
    (pallas, int8) whose index is still empty."""
    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.index.records import ChunkRecord, DocumentRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    now = EPOCH + timedelta(days=365.0)
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="rb", file_name="rb.txt", chunk_count=n))
    store.upsert_chunks([
        ChunkRecord(id=f"rb:{i}", document_id="rb", chunk_index=i,
                    content=f"topic c{i % 4096}x synthetic chunk", embedding=emb[i],
                    created_at_utc=now, seq=i)
        for i in range(n)
    ])
    opts = EngineOptions(backend="pallas", embedding_dim=d, recent_window=0, candidate_m=128,
                         bloom_bits=bits, scan_dtype="int8", capacity_block=8192)
    return RecallEngine(store, options=opts, device=device)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    records = stages(build_engine(args.rows, args.dim, device=device))
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"tool": "probe_rebuild", "rows": args.rows, "dim": args.dim,
                      "device": device.type, "stages": records}), flush=True)
    return records


if __name__ == "__main__":
    main()
