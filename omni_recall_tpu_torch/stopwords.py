"""Stop-word set used by the hybrid keyword scorer.

Mirrors the 28-entry ordinal set in the reference
(src/OmniRecall.Api/Services/RecallSearchService.cs:13-18).
"""

STOP_WORDS = frozenset(
    {
        "a", "an", "and", "are", "as", "at", "be", "by", "for", "from", "how",
        "in", "is", "it", "of", "on", "or", "that", "the", "to", "was", "what",
        "when", "where", "which", "who", "why", "with",
    }
)
