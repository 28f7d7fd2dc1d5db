"""Snippet building helper.

Mirrors the reference TextSnippetHelper
(src/OmniRecall.Api/Services/TextSnippetHelper.cs:5-11): newlines become
spaces, the result is trimmed, and content longer than ``max_length`` is
truncated with a ``...`` suffix. Search snippets use 180 chars
(RecallSearchService.cs:50); chunk previews use 220
(DocumentIngestionService.cs:204).
"""

from __future__ import annotations

SEARCH_SNIPPET_LEN = 180
PREVIEW_SNIPPET_LEN = 220


def build_snippet(content: str, max_length: int) -> str:
    normalized = content.replace("\n", " ").replace("\r", " ").strip()
    # length is counted in UTF-16 code units (C# string.Length): non-BMP
    # characters (emoji, rare CJK) count as 2. Truncation backs off one
    # unit rather than splitting a surrogate pair (C# substring would emit
    # a lone surrogate that JSON-encodes as U+FFFD — producing a valid
    # prefix instead is the only deliberate deviation).
    units = len(normalized.encode("utf-16-le")) // 2
    if units <= max_length:
        return normalized
    cut = normalized.encode("utf-16-le")[: max_length * 2]
    try:
        prefix = cut.decode("utf-16-le")
    except UnicodeDecodeError:
        prefix = cut[:-2].decode("utf-16-le")
    return prefix + "..."
