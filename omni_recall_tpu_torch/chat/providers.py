"""AI chat provider clients.

Behavioral mirrors of the reference clients, with the HTTP transport
injectable so tests replay scripted (status, body) sequences exactly like the
reference's fake HttpMessageHandlers (GeminiChatClientTests.cs:108-131).

- GeminiChatClient (GeminiChatClient.cs): model-chain failover — configured
  primary + configured-or-default fallbacks deduped case-insensitively
  (:97-116); 429 -> remember rate-limit, try next model (:56-61); other
  non-success fails over only for 403/404/5xx or a body containing
  resource_exhausted/quota/rate/"not found"/unavailable (:118-137), otherwise
  raises immediately; extracts the first non-blank candidates[].content.
  parts[].text (:139-168); missing text raises with blockReason/finishReason
  detail (:170-204).
- GitHubModelsChatClient (GitHubModelsChatClient.cs): OpenAI-style
  chat/completions with Bearer token and temperature 0.2 (:24-38); 429 raises
  rate-limit (:43-44); message content may be a string OR an array of text
  parts, concatenated (:62-121).
"""

from __future__ import annotations

import json
from typing import Any

from omni_recall_tpu_torch.chat.router import AiRateLimitError, HttpRequestError
from omni_recall_tpu_torch.config import GeminiOptions, GitHubModelsOptions
from omni_recall_tpu_torch.contracts import AiChatRequest, AiChatResponse
from omni_recall_tpu_torch.ingest.embedding import Transport, urllib_transport

_GEMINI_DEFAULT_FALLBACKS = [
    "gemini-2.5-flash-lite",
    "gemini-flash-latest",
    "gemini-flash-lite-latest",
    "gemini-3-flash-preview",
]

_FAILOVER_STATUSES = {403, 404, 429, 500, 502, 503, 504}
_FAILOVER_BODY_MARKERS = ("resource_exhausted", "quota", "rate", "not found", "unavailable")


class GeminiChatClient:
    provider_name = "gemini"

    def __init__(self, options: GeminiOptions, transport: Transport | None = None, timeout: float = 60.0):
        self.options = options
        self.transport = transport or urllib_transport
        self.timeout = timeout

    def _candidate_models(self) -> list[str]:
        primary = (self.options.model or "gemini-2.5-flash").strip()
        fallbacks = [m.strip() for m in (self.options.fallback_models or []) if m and m.strip()]
        if not fallbacks:
            fallbacks = _GEMINI_DEFAULT_FALLBACKS
        seen: dict[str, str] = {}
        for model in [primary, *fallbacks]:
            seen.setdefault(model.lower(), model)
        return list(seen.values())

    @staticmethod
    def _can_failover(status: int, body: str) -> bool:
        if status in _FAILOVER_STATUSES:
            return True
        lower = body.lower()
        return any(marker in lower for marker in _FAILOVER_BODY_MARKERS)

    def complete(self, request: AiChatRequest) -> AiChatResponse:
        if not self.options.api_key or not self.options.api_key.strip():
            raise RuntimeError("Gemini API key not configured.")

        payload = json.dumps(
            {"contents": [{"parts": [{"text": request.prompt}]}]}
        ).encode("utf-8")
        last_exception: Exception | None = None

        for model in self._candidate_models():
            url = f"{self.options.base_url}/models/{model}:generateContent?key={self.options.api_key}"
            try:
                resp = self.transport(
                    "POST", url, {"Content-Type": "application/json"}, payload, self.timeout
                )
            except Exception as exc:
                # transport-level failure (DNS/connect/reset): try the next
                # model in the chain like an HTTP-status failover — aborting
                # here would skip reachable fallback models; if every model
                # fails the router still sees a transient HttpRequestError
                last_exception = HttpRequestError(str(exc))
                last_exception.__cause__ = exc
                continue
            body = resp.body.decode("utf-8", errors="replace")

            if resp.status == 429:
                last_exception = AiRateLimitError(f"Gemini model '{model}' rate limited.")
                continue

            if resp.status >= 400:
                message = f"Gemini API returned {resp.status} for model '{model}': {body}"
                last_exception = HttpRequestError(message)
                if self._can_failover(resp.status, body):
                    continue
                raise last_exception

            root = json.loads(body)
            text = _extract_gemini_text(root)
            if text is None:
                reason = _missing_text_reason(root)
                raise RuntimeError(f"Gemini API response did not contain chat text. {reason}")
            if not text.strip():
                raise RuntimeError("Gemini API returned an empty response.")
            return AiChatResponse(text, model, self.provider_name)

        raise last_exception or RuntimeError("No Gemini models available for chat.")


def _extract_gemini_text(root: Any) -> str | None:
    candidates = root.get("candidates") if isinstance(root, dict) else None
    if not isinstance(candidates, list):
        return None
    for candidate in candidates:
        content = candidate.get("content") if isinstance(candidate, dict) else None
        if not isinstance(content, dict):
            continue
        parts = content.get("parts")
        if not isinstance(parts, list):
            continue
        for part in parts:
            if not isinstance(part, dict) or "text" not in part:
                continue
            value = part.get("text")
            if isinstance(value, str) and value.strip():
                return value
    return None


def _missing_text_reason(root: Any) -> str:
    details: list[str] = []
    if isinstance(root, dict):
        feedback = root.get("promptFeedback")
        if isinstance(feedback, dict):
            if "blockReason" in feedback:
                details.append(f"blockReason={feedback['blockReason']}")
            if "blockReasonMessage" in feedback:
                details.append(f"blockReasonMessage={feedback['blockReasonMessage']}")
        candidates = root.get("candidates")
        if isinstance(candidates, list):
            for candidate in candidates:
                if isinstance(candidate, dict) and "finishReason" in candidate:
                    details.append(f"finishReason={candidate['finishReason']}")
                    break
        if not details:
            return f"Top-level keys: {', '.join(root.keys())}."
    elif not details:
        return "Top-level keys: <not-an-object>."
    return "; ".join(details)


class GitHubModelsChatClient:
    provider_name = "github-models"

    def __init__(self, options: GitHubModelsOptions, transport: Transport | None = None, timeout: float = 60.0):
        self.options = options
        self.transport = transport or urllib_transport
        self.timeout = timeout

    def complete(self, request: AiChatRequest) -> AiChatResponse:
        token = self.options.token
        if not token or not token.strip():
            raise RuntimeError("GitHub Models token not configured.")

        model = self.options.model or "deepseek/DeepSeek-V3-0324"
        url = f"{self.options.base_url.rstrip('/')}/chat/completions"
        payload = json.dumps(
            {
                "model": model,
                "messages": [{"role": "user", "content": request.prompt}],
                "temperature": 0.2,
            }
        ).encode("utf-8")
        try:
            resp = self.transport(
                "POST", url,
                {"Content-Type": "application/json", "Authorization": f"Bearer {token}"},
                payload, self.timeout,
            )
        except Exception as exc:
            raise HttpRequestError(str(exc)) from exc
        body = resp.body.decode("utf-8", errors="replace")

        if resp.status == 429:
            raise AiRateLimitError("GitHub Models API rate limited.")
        if resp.status >= 400:
            raise HttpRequestError(f"GitHub Models API returned {resp.status}: {body}")

        root = json.loads(body)
        text = _extract_github_content(root)
        if text is None:
            reason = (
                f"Top-level keys: {', '.join(root.keys())}."
                if isinstance(root, dict)
                else "Response root was not a JSON object."
            )
            raise RuntimeError(f"GitHub Models API response did not contain chat text. {reason}")
        if not text.strip():
            raise RuntimeError("GitHub Models API returned an empty response.")
        return AiChatResponse(text, model, self.provider_name)


def _extract_github_content(root: Any) -> str | None:
    choices = root.get("choices") if isinstance(root, dict) else None
    if not isinstance(choices, list):
        return None
    for choice in choices:
        message = choice.get("message") if isinstance(choice, dict) else None
        if not isinstance(message, dict) or "content" not in message:
            continue
        content = message["content"]
        if isinstance(content, str):
            if content.strip():
                return content
            continue
        if isinstance(content, list):
            parts: list[str] = []
            for item in content:
                if isinstance(item, str):
                    if item.strip():
                        parts.append(item)
                elif isinstance(item, dict) and "text" in item:
                    piece = item.get("text")
                    if isinstance(piece, str) and piece.strip():
                        parts.append(piece)
            if parts:
                return "".join(parts)
    return None
