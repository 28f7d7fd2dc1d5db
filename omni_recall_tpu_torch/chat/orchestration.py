"""Grounded chat orchestration.

Behavioral mirror of src/OmniRecall.Api/Services/ChatOrchestrationService.cs:
recall -> evidence guard -> grounded prompt -> router -> post-process, with
the recall-only fallback on provider unavailability.

- Evidence guard (:58-65): citations >= max(1, MinimumCitationCount) AND any
  score >= max(0, MinimumStrongCitationScore); failing returns the guard
  response without calling the LLM (:23-30).
- Grounded prompt (:67-95): fixed preamble + numbered ``[i] file=... chunk=...
  score=F4`` context blocks + question + citing instructions.
- Post-process (:97-130): keep in-range ``[n]`` markers, strip out-of-range
  ones, collapse runs of 2+ horizontal whitespace, cap blank runs at one
  blank line, and filter returned citations to the referenced subset (all
  citations when none are referenced).
- Recall-only fallback (:132-155): top-N evidence list with F3 scores.
"""

from __future__ import annotations

import re

from omni_recall_tpu_torch.chat.router import AiChatRouter, AiProviderUnavailableError
from omni_recall_tpu_torch.config import ChatQualityOptions
from omni_recall_tpu_torch.contracts import AiChatRequest, ChatResponse, RecallCitation
from omni_recall_tpu_torch.search.service import RecallSearchService

_CITATION_MARKER = re.compile(r"\[(\d+)\]")
_HORIZONTAL_WS = re.compile(r"[ \t]{2,}")
_EXCESS_NEWLINES = re.compile(r"\n{3,}")


class ChatOrchestrationService:
    def __init__(
        self,
        recall_search_service: RecallSearchService,
        chat_router: AiChatRouter,
        quality_options: ChatQualityOptions | None = None,
    ) -> None:
        self.recall = recall_search_service
        self.router = chat_router
        self.options = quality_options or ChatQualityOptions()

    def complete(self, prompt: str, top_k: int) -> ChatResponse:
        recall = self.recall.search(prompt, top_k)
        options = self.options

        if not has_sufficient_evidence(recall.citations, options):
            return ChatResponse(
                options.insufficient_evidence_message,
                "guard",
                "insufficient-evidence",
                recall.citations,
            )

        grounded_prompt = build_grounded_prompt(prompt, recall.citations)

        try:
            response = self.router.complete(AiChatRequest(grounded_prompt))
        except AiProviderUnavailableError:
            if not options.enable_recall_only_fallback_on_provider_failure:
                raise
            fallback_answer = build_recall_only_fallback_answer(recall.citations, options)
            return ChatResponse(
                fallback_answer, "recall-only", "free-tier-fallback", recall.citations
            )

        answer, citations = post_process_answer(response.text, recall.citations)
        return ChatResponse(answer, response.provider, response.model, citations)


def has_sufficient_evidence(
    citations: list[RecallCitation], options: ChatQualityOptions
) -> bool:
    if len(citations) < max(1, options.minimum_citation_count):
        return False
    threshold = max(0.0, options.minimum_strong_citation_score)
    return any(c.score >= threshold for c in citations)


def build_grounded_prompt(user_question: str, citations: list[RecallCitation]) -> str:
    lines = [
        "You are an assistant that answers using the provided context snippets.",
        "The snippets can be partial excerpts from larger documents.",
        "If the user asks for improvements, critique, rewrite ideas, or optimization advice, provide actionable suggestions grounded in the snippet content.",
        "Only say you do not know when the snippets are clearly unrelated to the question.",
        "",
        "Context:",
    ]
    if not citations:
        lines.append("[no context]")
    else:
        for i, c in enumerate(citations):
            lines.append(f"[{i + 1}] file={c.file_name} chunk={c.chunk_index} score={c.score:.4f}")
            lines.append(c.snippet)
    lines.extend(
        [
            "",
            f"Question: {user_question}",
            "Answer concisely and cite snippet numbers like [1], [2] when used.",
            "When giving advice, include concrete changes and examples based on the snippets.",
        ]
    )
    return "\n".join(lines) + "\n"


def post_process_answer(
    answer: str, citations: list[RecallCitation]
) -> tuple[str, list[RecallCitation]]:
    if not answer or not answer.strip():
        return "", []
    if not citations:
        return answer.strip(), []

    referenced: list[int] = []

    def _replace(match: re.Match[str]) -> str:
        try:
            n = int(match.group(1))
        except ValueError:
            return ""
        if n < 1 or n > len(citations):
            return ""
        referenced.append(n)
        return f"[{n}]"

    normalized = _CITATION_MARKER.sub(_replace, answer)
    collapsed = _HORIZONTAL_WS.sub(" ", normalized)
    collapsed = _EXCESS_NEWLINES.sub("\n\n", collapsed).strip()

    unique_referenced = [citations[n - 1] for n in dict.fromkeys(referenced)]
    if not unique_referenced:
        return collapsed, list(citations)
    return collapsed, unique_referenced


def build_recall_only_fallback_answer(
    citations: list[RecallCitation], options: ChatQualityOptions
) -> str:
    max_citations = max(1, options.recall_only_fallback_max_citations)
    selected = citations[:max_citations]
    if not selected:
        return options.recall_only_fallback_message

    lines = [options.recall_only_fallback_message, "", "Top retrieved evidence:"]
    for i, c in enumerate(selected):
        lines.append(f"[{i + 1}] {c.file_name} (chunk {c.chunk_index}, score {c.score:.3f})")
        lines.append(c.snippet)
        if i < len(selected) - 1:
            lines.append("")
    return "\n".join(lines).strip()
