"""Minimal WSGI micro-framework (stdlib only).

Replaces the reference's ASP.NET Core minimal-API hosting layer
(src/OmniRecall.Api/Program.cs). Provides: a router with ``{param}`` path
segments, JSON request/response helpers, a multipart/form-data parser (for
the upload endpoint), CORS, and RFC-7807-style problem responses matching the
reference's global exception handler (Program.cs:77-99).
"""

from __future__ import annotations

import json
import logging
import re
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable
from urllib.parse import parse_qs

from omni_recall_tpu_torch.contracts import to_wire

logger = logging.getLogger(__name__)

_STATUS_PHRASES = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    404: "Not Found", 405: "Method Not Allowed", 413: "Payload Too Large",
    415: "Unsupported Media Type", 500: "Internal Server Error",
    503: "Service Unavailable",
}


@dataclass
class UploadedFile:
    name: str          # form field name
    filename: str
    content_type: str
    data: bytes


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, list[str]]
    headers: dict[str, str]  # lower-cased keys
    body: bytes
    path_params: dict[str, str] = field(default_factory=dict)

    def query_int(self, name: str, default: int | None = None) -> int | None:
        values = self.query.get(name) or self.query.get(_snake_to_camel(name))
        if not values:
            return default
        try:
            return int(values[0])
        except ValueError:
            return default

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "")

    @property
    def content_length(self) -> int | None:
        raw = self.headers.get("content-length")
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None

    def form(self) -> tuple[dict[str, str], list[UploadedFile]]:
        return parse_multipart(self.content_type, self.body)


def _snake_to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    headers: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def json(payload: Any, status: int = 200, headers: dict[str, str] | None = None) -> "Response":
        data = json.dumps(to_wire(payload)).encode("utf-8")
        h = {"Content-Type": "application/json; charset=utf-8"}
        if headers:
            h.update(headers)
        return Response(status, data, h)

    @staticmethod
    def error(message: str, status: int = 400) -> "Response":
        """Reference shape: Results.BadRequest(new { error = ... })."""
        return Response.json({"error": message}, status)

    @staticmethod
    def problem(title: str, detail: str, status: int) -> "Response":
        """RFC-7807 ProblemDetails shape (Program.cs:88-96)."""
        return Response.json({"title": title, "detail": detail, "status": status}, status)

    @staticmethod
    def no_content() -> "Response":
        return Response(204, b"", {})


Handler = Callable[[Request], Response]


class Router:
    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern[str], Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        # literal segments are regex-escaped: an unescaped '.' in e.g.
        # '/swagger/v1/swagger.json' would match any character
        parts = re.split(r"(\{\w+\})", pattern.rstrip("/"))
        built = "".join(
            re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", p)
            if re.fullmatch(r"\{\w+\}", p) else re.escape(p)
            for p in parts
        )
        regex = re.compile("^" + built + "/?$")
        self._routes.append((method.upper(), regex, handler))

    def match(self, method: str, path: str) -> tuple[Handler | None, dict[str, str], bool]:
        """Returns (handler, params, path_exists)."""
        path_exists = False
        for route_method, regex, handler in self._routes:
            m = regex.match(path)
            if m:
                path_exists = True
                if route_method == method.upper():
                    return handler, m.groupdict(), True
        return None, {}, path_exists


def parse_multipart(content_type: str, body: bytes) -> tuple[dict[str, str], list[UploadedFile]]:
    """Parse multipart/form-data into (fields, files)."""
    match = re.search(r'boundary="?([^";]+)"?', content_type)
    if not match or "multipart/form-data" not in content_type.lower():
        raise ValueError("Expected multipart form data.")
    boundary = match.group(1).encode("utf-8")
    delimiter = b"--" + boundary

    fields: dict[str, str] = {}
    files: list[UploadedFile] = []
    sections = body.split(delimiter)
    for section in sections[1:]:
        if section.startswith(b"--"):
            break  # closing delimiter
        section = section.lstrip(b"\r\n")
        header_blob, _, content = section.partition(b"\r\n\r\n")
        if not _:
            continue
        content = content[:-2] if content.endswith(b"\r\n") else content
        headers: dict[str, str] = {}
        for line in header_blob.split(b"\r\n"):
            key, _, value = line.partition(b":")
            headers[key.decode("latin-1").strip().lower()] = value.decode("latin-1").strip()
        disposition = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disposition)
        file_m = re.search(r'filename="([^"]*)"', disposition)
        field_name = name_m.group(1) if name_m else ""
        if file_m is not None:
            files.append(
                UploadedFile(
                    name=field_name,
                    filename=file_m.group(1),
                    content_type=headers.get("content-type", "application/octet-stream"),
                    data=content,
                )
            )
        else:
            fields[field_name] = content.decode("utf-8", errors="replace")
    return fields, files


class WsgiApp:
    """Router + CORS + global exception handling as a WSGI callable."""

    def __init__(
        self,
        router: Router,
        allowed_origins: list[str] | None = None,
        max_body_bytes: int | None = None,
    ) -> None:
        self.router = router
        self.allowed_origins = [o.lower() for o in (allowed_origins or [])]
        # enforced BEFORE the body is buffered (the reference's equivalent
        # is Kestrel's MaxRequestBodySize): without it a huge Content-Length
        # is read fully into memory before any route-level 413 check runs
        self.max_body_bytes = max_body_bytes

    def _cors_headers(self, request: Request) -> dict[str, str]:
        origin = request.headers.get("origin")
        if origin and origin.lower() in self.allowed_origins:
            return {
                "Access-Control-Allow-Origin": origin,
                "Access-Control-Allow-Headers": "*",
                "Access-Control-Allow-Methods": "*",
            }
        return {}

    def handle(self, request: Request) -> Response:
        if request.method == "OPTIONS":
            return Response(204, b"", self._cors_headers(request))
        start = time.monotonic()
        handler, params, path_exists = self.router.match(request.method, request.path)
        if handler is None:
            response = Response.json(
                {"error": "Method not allowed." if path_exists else "Not found."},
                405 if path_exists else 404,
            )
        else:
            request.path_params = params
            try:
                response = handler(request)
            except Exception:
                logger.error(
                    "Unhandled exception for request %s\n%s",
                    request.path, traceback.format_exc(),
                )
                response = Response.problem(
                    "Unexpected server error",
                    "An unexpected error occurred while processing the request.",
                    500,
                )
        duration_ms = (time.monotonic() - start) * 1000.0
        cors = self._cors_headers(request)
        response.headers.update(cors)
        if self.allowed_origins:
            # shared caches must not serve one origin's ACAO to another
            response.headers.setdefault("Vary", "Origin")
        response.headers.setdefault("X-Response-Time-Ms", f"{duration_ms:.2f}")
        logger.info(
            "%s %s -> %d (%.2f ms)",
            request.method, request.path, response.status, duration_ms,
        )
        return response

    # -- WSGI protocol --

    def __call__(self, environ: dict[str, Any], start_response) -> list[bytes]:
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if self.max_body_bytes is not None and length > self.max_body_bytes:
            payload = json.dumps({
                "title": "Payload too large",
                "detail": "Request body exceeds the configured limit.",
                "status": 413,
            }).encode("utf-8")
            # the early return still needs CORS/Vary headers or a browser
            # SPA that trips the cap gets a CORS-blocked response it cannot
            # read (every other error path goes through handle())
            wsgi_headers = [
                ("Content-Type", "application/problem+json"),
                ("Content-Length", str(len(payload))),
            ]
            origin = environ.get("HTTP_ORIGIN")
            if origin and origin.lower() in self.allowed_origins:
                wsgi_headers += [
                    ("Access-Control-Allow-Origin", origin),
                    ("Access-Control-Allow-Headers", "*"),
                    ("Access-Control-Allow-Methods", "*"),
                ]
            if self.allowed_origins:
                wsgi_headers.append(("Vary", "Origin"))
            start_response("413 Payload Too Large", wsgi_headers)
            return [payload]
        body = environ["wsgi.input"].read(length) if length > 0 else b""
        headers = {
            key[5:].replace("_", "-").lower(): value
            for key, value in environ.items()
            if key.startswith("HTTP_")
        }
        if environ.get("CONTENT_TYPE"):
            headers["content-type"] = environ["CONTENT_TYPE"]
        if environ.get("CONTENT_LENGTH"):
            headers["content-length"] = environ["CONTENT_LENGTH"]
        request = Request(
            method=environ.get("REQUEST_METHOD", "GET"),
            path=environ.get("PATH_INFO", "/"),
            query=parse_qs(environ.get("QUERY_STRING", "")),
            headers=headers,
            body=body,
        )
        response = self.handle(request)
        phrase = _STATUS_PHRASES.get(response.status, "Unknown")
        out_headers = list(response.headers.items())
        out_headers.append(("Content-Length", str(len(response.body))))
        start_response(f"{response.status} {phrase}", out_headers)
        return [response.body]
