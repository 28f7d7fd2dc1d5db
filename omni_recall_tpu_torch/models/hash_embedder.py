"""Deterministic feature-hashing text embedder.

The reference delegates all embedding to the remote Gemini API
(src/OmniRecall.Api/Services/GeminiEmbeddingClient.cs). For offline operation,
tests, and reproducible benchmarks this module provides a local, fully
deterministic embedder: lowercase word unigrams + bigrams are feature-hashed
into a d-dim vector with ±1 signs and inverse-sqrt document-frequency-free
scaling, then L2-normalized. Texts sharing vocabulary land near each other in
cosine space, which gives eval corpora a realistic similarity structure
without any network dependency.
"""

from __future__ import annotations

import numpy as np

from omni_recall_tpu_torch.ops.hashing import fnv1a


def embed_text(text: str, dim: int = 768) -> list[float]:
    tokens = text.lower().split()
    if not tokens:
        return []
    vec = np.zeros(dim, dtype=np.float64)
    features = tokens + [f"{a}\x1f{b}" for a, b in zip(tokens, tokens[1:])]
    for feat in features:
        h = fnv1a(feat.encode("utf-8", errors="surrogatepass"), seed=7)
        idx = h % dim
        sign = 1.0 if (h >> 63) & 1 else -1.0
        vec[idx] += sign
    norm = float(np.linalg.norm(vec))
    if norm <= 0.0:
        return []
    return (vec / norm).astype(np.float32).tolist()
