"""API clients for the eval harness: in-process (WSGI) and HTTP (PyTorch port
of omni_recall_tpu/eval/clients.py)."""

from __future__ import annotations

import json

from omni_recall_tpu_torch.eval.harness import TransientApiError
from omni_recall_tpu_torch.server.testing import TestClient


class InProcessClient:
    """Runs the eval against an in-process OmniRecallApp."""

    def __init__(self, app) -> None:
        self.client = TestClient(app)

    def _check(self, resp):
        if resp.status >= 400:
            raise TransientApiError(resp.body.decode("utf-8", "replace"), status=resp.status)
        return resp.json()

    def search_recall(self, question: str, top_k: int) -> dict:
        return self._check(
            self.client.post("/api/recall/search", json_body={"query": question, "topK": top_k})
        )

    def chat(self, prompt: str, top_k: int) -> dict:
        return self._check(
            self.client.post("/api/chat", json_body={"prompt": prompt, "topK": top_k})
        )

    def list_documents(self) -> list[dict]:
        return self._check(self.client.get("/api/documents"))

    def get_document_chunks(self, document_id: str) -> list[dict]:
        return self._check(self.client.get(f"/api/documents/{document_id}/chunks"))


class HttpApiClient:
    """Runs the eval against a live server over HTTP."""

    def __init__(self, base_url: str, timeout: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, method: str, path: str, payload: dict | None = None):
        import urllib.error
        import urllib.request

        body = json.dumps(payload).encode("utf-8") if payload is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": "application/json"}, method=method,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            raise TransientApiError(
                exc.read().decode("utf-8", "replace"), status=exc.code
            ) from exc
        except (TimeoutError, urllib.error.URLError, OSError) as exc:
            # URLError wraps connection-phase failures (connect timeout,
            # ECONNREFUSED, DNS) that are NOT TimeoutError — they must
            # classify as transient or the harness's x3 retry
            # (eval.page.ts:550-582 parity) never fires for them
            raise TransientApiError(f"timeout/connect: {exc}", status=None) from exc

    def search_recall(self, question: str, top_k: int) -> dict:
        return self._request("POST", "/api/recall/search", {"query": question, "topK": top_k})

    def chat(self, prompt: str, top_k: int) -> dict:
        return self._request("POST", "/api/chat", {"prompt": prompt, "topK": top_k})

    def list_documents(self) -> list[dict]:
        return self._request("GET", "/api/documents")

    def get_document_chunks(self, document_id: str) -> list[dict]:
        return self._request("GET", f"/api/documents/{document_id}/chunks")
