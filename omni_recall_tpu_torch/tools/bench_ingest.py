"""Ingestion at scale: the index append pipeline in chunks/s.

Counterpart of the repository's ``tools/bench_ingest.py`` (BASELINE.json
config 2): n chunks (default 100k) of d = 768 unit rows and 100-word
contents appended to a DeviceIndex (native bloom signatures, normalization,
host mirrors), then its device planes uploaded and quantized
(``device_arrays``), for f32 and int8 scan storage.
``python -m omni_recall_tpu_torch.tools.bench_ingest [--rows N] [--device cpu]``
prints one JSON line a storage type and a summary line.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import timedelta

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device


def chunks_of(n: int, d: int):
    """The tool's chunks: random unit rows, contents cycling 200 texts of
    100 words over a vocabulary of 5000."""
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.index.records import ChunkRecord

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    words = [f"word{i}" for i in range(5000)]
    contents = [" ".join(words[(i * 7 + j) % 5000] for j in range(100)) for i in range(200)]
    when = EPOCH + timedelta(days=1)
    return [
        ChunkRecord(id=f"c:{i}", document_id=f"doc_{i % 500}", chunk_index=i,
                    content=contents[i % 200], embedding=emb[i].tolist(),
                    created_at_utc=when, seq=i)
        for i in range(n)
    ]


def measure(chunks, d: int, device, scan_dtypes=("f32", "int8"),
            capacity_block: int = 16384) -> list[dict]:
    from omni_recall_tpu_torch.index.device_index import DeviceIndex

    n = len(chunks)
    out = []
    for scan_dtype in scan_dtypes:
        dix = DeviceIndex(d, capacity_block=capacity_block, bloom_bits=1024,
                          scan_dtype=scan_dtype, device=device)
        t0 = time.perf_counter()
        dix.append(chunks)
        append_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dix.device_arrays()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        upload_s = time.perf_counter() - t0
        out.append({"scan_dtype": scan_dtype, "rows": n, "append_s": append_s,
                    "append_chunks_per_s": n / append_s, "upload_s": upload_s,
                    "chunks_per_s": n / (append_s + upload_s)})
        del dix
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    records = measure(chunks_of(args.rows, args.dim), args.dim, device)
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"tool": "bench_ingest", "rows": args.rows, "dim": args.dim,
                      "device": device.type, "records": records}), flush=True)
    return records


if __name__ == "__main__":
    main()
