"""In-process test client for the WSGI app (WebApplicationFactory analog)."""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass
from typing import Any

from omni_recall_tpu_torch.server.http import Request, WsgiApp


@dataclass
class TestResponse:
    status: int
    body: bytes
    headers: dict[str, str]

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))


class TestClient:
    __test__ = False  # not a pytest collectible

    def __init__(self, app: WsgiApp) -> None:
        self.app = app

    def request(
        self,
        method: str,
        path: str,
        *,
        json_body: Any = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
        query: dict[str, list[str]] | None = None,
    ) -> TestResponse:
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        if json_body is not None:
            body = json.dumps(json_body).encode("utf-8")
            headers.setdefault("content-type", "application/json")
        headers.setdefault("content-length", str(len(body)))
        request = Request(
            method=method, path=path, query=query or {}, headers=headers, body=body
        )
        response = self.app.handle(request)
        return TestResponse(response.status, response.body, dict(response.headers))

    def get(self, path: str, **kwargs) -> TestResponse:
        return self.request("GET", path, **kwargs)

    def post(self, path: str, **kwargs) -> TestResponse:
        return self.request("POST", path, **kwargs)

    def delete(self, path: str, **kwargs) -> TestResponse:
        return self.request("DELETE", path, **kwargs)

    def upload(
        self,
        path: str,
        *,
        filename: str,
        data: bytes,
        field: str = "file",
        fields: dict[str, str] | None = None,
        content_length: int | None = None,
    ) -> TestResponse:
        boundary = f"omni-{uuid.uuid4().hex}"
        parts = []
        for name, value in (fields or {}).items():
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n{value}\r\n'.encode()
            )
        parts.append(
            (
                f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; '
                f'filename="{filename}"\r\nContent-Type: application/octet-stream\r\n\r\n'
            ).encode()
            + data
            + b"\r\n"
        )
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        headers = {
            "content-type": f"multipart/form-data; boundary={boundary}",
            "content-length": str(content_length if content_length is not None else len(body)),
        }
        return self.request("POST", path, body=body, headers=headers)
