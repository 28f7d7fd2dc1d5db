"""Document-intelligence OCR client.

Behavioral mirror of the reference's
AzureDocumentIntelligenceOcrTextExtractor
(src/OmniRecall.Api/Services/AzureDocumentIntelligenceOcrTextExtractor.cs):
POST the PDF bytes to ``{endpoint}/documentintelligence/documentModels/
prebuilt-read:analyze?api-version=...`` with the subscription-key header
(:32-36), then poll the ``operation-location`` every PollMs up to
MaxPollAttempts (:59-97). Status handling: running/notStarted -> keep
polling; succeeded -> analyzeResult.content (or root content); failed or
any rejection/timeout/transport error -> empty string (the extractor never
raises). The HTTP transport is injectable for tests."""

from __future__ import annotations

import http.client
import json
import logging

from omni_recall_tpu_torch.config import OcrOptions
from omni_recall_tpu_torch.ingest.embedding import Transport, urllib_transport

logger = logging.getLogger(__name__)


class DocumentIntelligenceOcrTextExtractor:
    def __init__(
        self,
        options: OcrOptions,
        transport: Transport | None = None,
        sleep=None,
        timeout: float = 30.0,
    ) -> None:
        import time

        self.options = options
        self.transport = transport or urllib_transport
        self.sleep = sleep if sleep is not None else time.sleep
        self.api_version = options.api_version or "2024-11-30"
        self.timeout = timeout

    def extract_text(self, data: bytes) -> str:
        endpoint = (self.options.endpoint or "").rstrip("/")
        key = self.options.key
        if not endpoint or not key or not key.strip():
            return ""

        analyze_url = (
            f"{endpoint}/documentintelligence/documentModels/"
            f"prebuilt-read:analyze?api-version={self.api_version}"
        )
        headers = {
            "Ocp-Apim-Subscription-Key": key,
            "Content-Type": "application/pdf",
        }
        try:
            resp = self.transport("POST", analyze_url, headers, data, self.timeout)
            if resp.status in (401, 403, 404):
                logger.warning("OCR analyze request rejected with %d", resp.status)
                return ""
            if resp.status >= 300:
                logger.warning("OCR analyze request failed with %d", resp.status)
                return ""
            operation_location = (getattr(resp, "headers", {}) or {}).get("operation-location", "")
            if not operation_location.strip():
                return ""

            poll_s = max(0, self.options.poll_ms) / 1000.0
            for attempt in range(1, max(1, self.options.max_poll_attempts) + 1):
                self.sleep(poll_s)
                status_resp = self.transport(
                    "GET", operation_location,
                    {"Ocp-Apim-Subscription-Key": key}, None, self.timeout,
                )
                if status_resp.status >= 300:
                    continue
                doc = json.loads(status_resp.body.decode("utf-8"))
                status = str(doc.get("status", "") or "").lower()
                if status in ("running", "notstarted"):
                    continue
                if status == "succeeded":
                    result = doc.get("analyzeResult")
                    if isinstance(result, dict) and isinstance(result.get("content"), str):
                        return result["content"].strip()
                    if isinstance(doc.get("content"), str):
                        return doc["content"].strip()
                    return ""
                if status == "failed":
                    return ""
            logger.warning(
                "OCR polling timed out after %d attempts", self.options.max_poll_attempts
            )
            return ""
        except (OSError, ValueError, KeyError, AttributeError,
                http.client.HTTPException) as exc:
            # AttributeError: a poll body of 'null'/array makes doc.get blow
            # up — the never-raises contract must still hold
            # HTTPException covers BadStatusLine/IncompleteRead etc., which
            # urllib raises for malformed responses and which are NOT
            # OSError subclasses — the never-raises contract must hold
            logger.warning("OCR extraction failed: %s", exc)
            return ""
