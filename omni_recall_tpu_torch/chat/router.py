"""Provider router: per-provider retry with exponential backoff, then
failover to the fallback provider.

Behavioral mirror of src/OmniRecall.Api/Services/AiChatRouter.cs:
- attempts per provider = max(1, MaxAttemptsPerProvider) (:50),
- transient = rate-limit | timeout | HTTP transport error (:96-99); any other
  exception fails the provider immediately (:83-90),
- backoff = base * 2^(attempt-1), capped at RetryMaxDelayMs; base 0 disables
  the delay (:101-121),
- both providers exhausted -> AiProviderUnavailableError carrying both inner
  exceptions (:39-42, :132-143).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from omni_recall_tpu_torch.config import AiRoutingOptions
from omni_recall_tpu_torch.contracts import AiChatRequest, AiChatResponse

logger = logging.getLogger(__name__)


class AiRateLimitError(Exception):
    pass


class HttpRequestError(Exception):
    """Transport-level HTTP failure (network error or non-success status)."""


class AiProviderUnavailableError(Exception):
    def __init__(self, message: str, primary_exception: Exception | None, fallback_exception: Exception | None):
        super().__init__(message)
        self.primary_exception = primary_exception
        self.fallback_exception = fallback_exception


def _is_transient(exc: Exception) -> bool:
    return isinstance(exc, (AiRateLimitError, TimeoutError, HttpRequestError))


@dataclass
class _AttemptResult:
    success: bool
    response: AiChatResponse | None
    exception: Exception | None


class AiChatRouter:
    # routers satisfy the IAiChatClient contract themselves, so a router
    # can nest as another router's fallback (used by Ai:Provider=Local to
    # keep the full Gemini -> GitHub Models chain behind the local decoder)
    provider_name = "router"

    def __init__(
        self,
        primary,
        fallback,
        options: AiRoutingOptions | None = None,
        sleep=time.sleep,
    ) -> None:
        self._primary = primary
        self._fallback = fallback
        self._options = options or AiRoutingOptions()
        self._sleep = sleep
        self.provider_name = (
            f"{primary.provider_name}->{fallback.provider_name}"
        )

    def complete(self, request: AiChatRequest) -> AiChatResponse:
        primary_result = self._try_provider(self._primary, request)
        if primary_result.success and primary_result.response is not None:
            return primary_result.response

        logger.warning(
            "Primary provider %s failed after retries. Falling back to %s.",
            self._primary.provider_name, self._fallback.provider_name,
        )
        fallback_result = self._try_provider(self._fallback, request)
        if fallback_result.success and fallback_result.response is not None:
            return fallback_result.response

        raise AiProviderUnavailableError(
            f"Both AI providers failed: primary={self._primary.provider_name}, "
            f"fallback={self._fallback.provider_name}",
            primary_result.exception,
            fallback_result.exception,
        )

    def _try_provider(self, client, request: AiChatRequest) -> _AttemptResult:
        attempts = max(1, self._options.max_attempts_per_provider)
        last_exception: Exception | None = None
        for attempt in range(1, attempts + 1):
            try:
                return _AttemptResult(True, client.complete(request), None)
            except Exception as exc:
                if not _is_transient(exc):
                    logger.warning(
                        "Non-transient failure from provider %s: %s",
                        client.provider_name, exc,
                    )
                    return _AttemptResult(False, None, exc)
                last_exception = exc
                logger.warning(
                    "Transient failure from provider %s on attempt %d/%d: %s",
                    client.provider_name, attempt, attempts, exc,
                )
                if attempt < attempts:
                    delay_ms = self._backoff_ms(attempt)
                    if delay_ms > 0:
                        self._sleep(delay_ms / 1000.0)
        return _AttemptResult(
            False, None, last_exception or RuntimeError("Unknown provider failure.")
        )

    def _backoff_ms(self, attempt_number: int) -> float:
        base_ms = max(0, self._options.retry_base_delay_ms)
        if base_ms == 0:
            return 0.0
        max_ms = max(base_ms, self._options.retry_max_delay_ms)
        return min(base_ms * (2.0 ** max(0, attempt_number - 1)), max_ms)
