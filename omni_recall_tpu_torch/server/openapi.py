"""OpenAPI document for the REST surface (Swagger parity, Program.cs:74-75)."""

from __future__ import annotations


def build_openapi_document() -> dict:
    def ref(name: str) -> dict:
        return {"$ref": f"#/components/schemas/{name}"}

    citation = {
        "type": "object",
        "properties": {
            "documentId": {"type": "string"},
            "fileName": {"type": "string"},
            "chunkId": {"type": "string"},
            "chunkIndex": {"type": "integer"},
            "snippet": {"type": "string"},
            "score": {"type": "number", "format": "double"},
            "createdAtUtc": {"type": "string", "format": "date-time"},
        },
    }
    doc_id_param = {
        "name": "documentId", "in": "path", "required": True,
        "schema": {"type": "string"},
    }

    def body(schema_name: str) -> dict:
        return {
            "required": True,
            "content": {"application/json": {"schema": ref(schema_name)}},
        }

    def ok(schema_name: str) -> dict:
        return {
            "description": "OK",
            "content": {"application/json": {"schema": ref(schema_name)}},
        }

    return {
        "openapi": "3.0.1",
        "info": {"title": "Omni Recall TPU API", "version": "v1"},
        "paths": {
            "/api/documents/upload": {"post": {"tags": ["Documents"], "responses": {"201": {"description": "Created"}, "400": {"description": "Bad Request"}, "413": {"description": "Payload Too Large"}, "415": {"description": "Unsupported Media Type"}}}},
            "/api/documents": {"get": {"tags": ["Documents"], "responses": {"200": {"description": "OK"}}}},
            "/api/documents/{documentId}": {
                "parameters": [doc_id_param],
                "get": {"tags": ["Documents"], "responses": {"200": {"description": "OK"}, "404": {"description": "Not Found"}}},
                "delete": {"tags": ["Documents"], "responses": {"204": {"description": "No Content"}, "404": {"description": "Not Found"}}},
            },
            "/api/documents/{documentId}/chunks": {"parameters": [doc_id_param], "get": {"tags": ["Documents"], "responses": {"200": {"description": "OK"}, "404": {"description": "Not Found"}}}},
            "/api/documents/{documentId}/reindex": {"parameters": [doc_id_param], "post": {"tags": ["Documents"], "responses": {"200": {"description": "OK"}, "404": {"description": "Not Found"}}}},
            "/api/documents/train": {"post": {"tags": ["Documents"], "summary": "Fine-tune the local encoder on the ingested corpus and re-embed it", "responses": {"200": {"description": "OK"}, "400": {"description": "Bad Request"}, "409": {"description": "Conflict (provider not trainable)"}}}},
            "/api/recall/search": {"post": {"tags": ["Recall"], "requestBody": body("RecallSearchRequestDto"), "responses": {"200": ok("RecallSearchResponseDto"), "400": {"description": "Bad Request"}}}},
            "/api/chat": {"post": {"tags": ["Chat"], "requestBody": body("ChatRequestDto"), "responses": {"200": ok("ChatResponseDto"), "400": {"description": "Bad Request"}, "503": {"description": "Service Unavailable"}}}},
            "/health": {"get": {"tags": ["Health"], "responses": {"200": {"description": "OK"}, "503": {"description": "Service Unavailable"}}}},
            "/metrics": {"get": {"tags": ["Health"], "responses": {"200": {"description": "Prometheus text exposition"}}}},
        },
        "components": {
            "schemas": {
                "RecallCitationDto": citation,
                "RecallSearchRequestDto": {
                    "type": "object",
                    "properties": {"query": {"type": "string"}, "topK": {"type": "integer", "default": 5}},
                },
                "RecallSearchResponseDto": {
                    "type": "object",
                    "properties": {"query": {"type": "string"}, "citations": {"type": "array", "items": ref("RecallCitationDto")}},
                },
                "ChatRequestDto": {
                    "type": "object",
                    "properties": {"prompt": {"type": "string"}, "topK": {"type": "integer", "default": 5}},
                },
                "ChatResponseDto": {
                    "type": "object",
                    "properties": {
                        "answer": {"type": "string"},
                        "provider": {"type": "string"},
                        "model": {"type": "string"},
                        "citations": {"type": "array", "items": ref("RecallCitationDto")},
                    },
                },
            }
        },
    }
