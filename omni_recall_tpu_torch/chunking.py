"""Sliding-window word chunker.

Behavior-compatible with the reference chunker
(src/OmniRecall.Api/Services/SlidingWindowTextChunker.cs:5-36):

- whitespace word split (any Unicode whitespace, empty entries removed),
- chunk_size = max(1, cfg), overlap = clamp(cfg, 0, chunk_size - 1),
  step = max(1, chunk_size - overlap),
- windows re-joined with single spaces,
- iteration stops once a window reaches the end of the word list.
"""

from __future__ import annotations

import re

# C# char.IsWhiteSpace set: space separators (Zs), line/paragraph
# separators, and the BCL extras \t \n \v \f \r U+0085 — but NOT the
# information separators U+001C..U+001F that Python's str.split() also
# treats as whitespace. PDF-extracted text commonly carries those control
# chars, and splitting on them would shift every later chunk boundary.
_CSHARP_WS = re.compile(
    "[\t\n\v\f\r \u0085\u00a0\u1680"
    "\u2000-\u200a\u2028\u2029\u202f\u205f\u3000]+"
)


def _split_words(text: str) -> list[str]:
    return [w for w in _CSHARP_WS.split(text) if w]


def chunk_text(text: str, chunk_size_words: int, chunk_overlap_words: int) -> list[str]:
    if not text:
        return []

    words = _split_words(text)
    if not words:
        return []

    chunk_size = max(1, chunk_size_words)
    overlap = max(0, min(chunk_overlap_words, chunk_size - 1))
    step = max(1, chunk_size - overlap)

    chunks: list[str] = []
    i = 0
    n = len(words)
    while i < n:
        end = min(i + chunk_size, n)
        if end - i <= 0:
            break
        chunks.append(" ".join(words[i:end]))
        if i + chunk_size >= n:
            break
        i += step
    return chunks
