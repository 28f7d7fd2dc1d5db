"""Reference-exact hybrid scorer (the permanent parity oracle).

Pure-Python/NumPy mirror of the reference's scoring loop
(src/OmniRecall.Api/Services/RecallSearchService.cs:59-119):

- ``cosine_similarity`` — float64 accumulation over float32 vectors; returns
  0 for empty/missing/length-mismatched vectors or non-positive norms
  (:69-88),
- ``keyword_score`` — lowercase whitespace split, order-preserving distinct,
  stop-word filter with fall-back to the raw terms when ALL terms are stop
  words, then the fraction of terms substring-contained (ordinal) in the
  lowercased content (:90-113),
- ``recency_score`` — exp(-age_days/30) with age clamped at 0 (:115-119),
- ``score_chunk`` — 0.7·cos + 0.2·kw + 0.1·recency (:66).

Every device path in this framework is tested against this module.
"""

from __future__ import annotations

import math
from datetime import datetime, timezone
from typing import Sequence

import numpy as np

from omni_recall_tpu_torch.stopwords import STOP_WORDS

COSINE_WEIGHT = 0.7
KEYWORD_WEIGHT = 0.2
RECENCY_WEIGHT = 0.1
RECENCY_HALF_LIFE_DAYS = 30.0
RECENT_WINDOW = 300  # candidate window, RecallSearchService.cs:26


def cosine_similarity(a: Sequence[float] | None, b: Sequence[float] | None) -> float:
    """float32 elementwise products accumulated in float64, like the C#
    ``double dot += (float)(a[i] * b[i])`` loop (:74-82). (The accumulation
    *order* differs — numpy pairwise vs sequential — which only matters on
    knife-edge ties far below score-rounding precision.)"""
    if a is None or b is None:
        return 0.0
    av = np.asarray(a, dtype=np.float32)
    bv = np.asarray(b, dtype=np.float32)
    if av.size == 0 or bv.size == 0 or av.size != bv.size:
        return 0.0
    dot = float(np.sum((av * bv).astype(np.float64)))
    norm_a = float(np.sum((av * av).astype(np.float64)))
    norm_b = float(np.sum((bv * bv).astype(np.float64)))
    if norm_a <= 0.0 or norm_b <= 0.0:
        return 0.0
    return dot / (math.sqrt(norm_a) * math.sqrt(norm_b))


def lower_invariant(s: str) -> str:
    """Per-character simple lowercase — .NET ToLowerInvariant semantics
    (RecallSearchService.cs lowercases query terms and content with it).
    Python's full-case str.lower() differs in two ways that break substring
    parity: U+0130 'I-dot' lowers to TWO characters (i + combining dot)
    instead of .NET's plain 'i', and final-sigma context mapping produces
    'ς' where .NET always yields 'σ'. Per-character mapping is context-free
    (fixes sigma) and the explicit table covers the multi-char expansions.

    EVERY content/query lowering in the pipeline (oracle, arena, bloom
    builders, engine host paths) must use THIS function, or keyword
    substring matching silently disagrees between stages."""
    if s.isascii():  # hot path: ASCII content never needs the slow walk
        return s.lower()
    out = []
    for ch in s:
        low = ch.lower()
        if len(low) != 1:
            low = _LOWER_MULTI.get(ch, ch)
        out.append(low)
    return "".join(out)


# full-case lowercase expansions that .NET's simple mapping collapses
_LOWER_MULTI = {"\u0130": "i"}


def query_terms(query: str) -> list[str]:
    """Distinct lowercased terms with the stop-word fallback rule (:95-108)."""
    raw_terms = list(dict.fromkeys(lower_invariant(t) for t in query.split()))
    if not raw_terms:
        return []
    terms = [t for t in raw_terms if t not in STOP_WORDS]
    return terms if terms else raw_terms


def keyword_score(query: str, content: str) -> float:
    if not query or not query.strip() or not content or not content.strip():
        return 0.0
    terms = query_terms(query)
    if not terms:
        return 0.0
    content_lower = lower_invariant(content)
    matches = sum(1 for t in terms if t in content_lower)
    return matches / len(terms)


def keyword_score_terms(terms: Sequence[str], content_lower: str) -> float:
    """Keyword score given pre-extracted terms and pre-lowercased content."""
    if not terms:
        return 0.0
    matches = sum(1 for t in terms if t in content_lower)
    return matches / len(terms)


def recency_score(created_at_utc: datetime | None, now: datetime | None = None) -> float:
    if created_at_utc is None:
        created_at_utc = datetime.min.replace(tzinfo=timezone.utc)
    if created_at_utc.tzinfo is None:
        created_at_utc = created_at_utc.replace(tzinfo=timezone.utc)
    now = now or datetime.now(timezone.utc)
    age_days = max(0.0, (now - created_at_utc).total_seconds() / 86400.0)
    return math.exp(-age_days / RECENCY_HALF_LIFE_DAYS)


def score_chunk(
    query: str,
    query_embedding: Sequence[float] | None,
    chunk_embedding: Sequence[float] | None,
    content: str,
    created_at_utc: datetime | None,
    now: datetime | None = None,
) -> float:
    return (
        COSINE_WEIGHT * cosine_similarity(query_embedding, chunk_embedding)
        + KEYWORD_WEIGHT * keyword_score(query, content)
        + RECENCY_WEIGHT * recency_score(created_at_utc, now)
    )
