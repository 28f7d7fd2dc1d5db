"""The port's host-only providers (chat router, chat providers and
orchestration, the Gemini and fake embedding clients, OCR) held to the JAX
package's own tests, and to the JAX modules on the same scripted inputs.

The port's modules are the JAX package's with their imports renamed, so
each test of tests/test_chat_router.py, test_chat_providers.py,
test_chat_orchestration.py and test_ocr.py is run again here with every
``omni_recall_tpu.`` import pointing at ``omni_recall_tpu_torch.`` (the
JAX files themselves stay as they are). Fake transports only: nothing here
touches the network.
"""

import json
import pathlib
import types

import pytest

HERE = pathlib.Path(__file__).resolve().parent
SOURCES = ("test_chat_router.py", "test_chat_providers.py", "test_chat_orchestration.py",
           "test_ocr.py")
_MODULES: dict[str, types.ModuleType] = {}


def _ported(name: str) -> types.ModuleType:
    """tests/<name> with its package imports renamed to the port's."""
    if name not in _MODULES:
        src = (HERE / name).read_text(encoding="utf-8")
        assert "omni_recall_tpu." in src
        src = src.replace("omni_recall_tpu.", "omni_recall_tpu_torch.")
        mod = types.ModuleType(f"ported_{name[:-3]}")
        mod.__file__ = str(HERE / name)
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)  # noqa: S102
        _MODULES[name] = mod
    return _MODULES[name]


def _cases():
    import ast

    out = []
    for name in SOURCES:
        tree = ast.parse((HERE / name).read_text(encoding="utf-8"))
        out += [(name, node.name) for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")]
    return out


@pytest.mark.parametrize("source, test", _cases(), ids=lambda v: v)
def test_the_jax_packages_test_passes_on_the_port(source, test):
    mod = _ported(source)
    assert not any(m.startswith("omni_recall_tpu.") for m in mod.__dict__.get("__all__", ()))
    getattr(mod, test)()


def _scripted(responses):
    calls = []

    def transport(method, url, headers, body, timeout):
        calls.append((method, url, headers, body))
        if not responses:
            raise ConnectionError("no scripted response left")
        return responses.pop(0)
    return transport, calls


def _gemini_scripts(package):
    mod = __import__(f"{package}.ingest.embedding", fromlist=["x"])
    ok = json.dumps({"embedding": {"values": [0.5, "x", 1, -2.25]}}).encode()
    return [
        [mod.SimpleHttpResponse(200, ok)],
        [mod.SimpleHttpResponse(429, b"{}")],
        [mod.SimpleHttpResponse(404, b""), mod.SimpleHttpResponse(200, ok)],
        [mod.SimpleHttpResponse(404, b""), mod.SimpleHttpResponse(404, b"")],
        [mod.SimpleHttpResponse(403, b"")],
        [mod.SimpleHttpResponse(500, b"")],
        [mod.SimpleHttpResponse(200, b"not json"), mod.SimpleHttpResponse(200, b"{}")],
        [mod.SimpleHttpResponse(200, json.dumps({"embedding": {}}).encode())],
    ]


def _gemini_run(package, key, model, output_dim):
    cfg = __import__(f"{package}.config", fromlist=["x"])
    mod = __import__(f"{package}.ingest.embedding", fromlist=["x"])
    out = []
    for script in _gemini_scripts(package):
        transport, calls = _scripted(list(script))
        client = mod.GeminiEmbeddingClient(
            cfg.GeminiOptions(api_key=key, embedding_model=model), transport=transport,
            output_dim=output_dim)
        for text in ("hello", "  "):
            r = client.embed(text)
            out.append((r.vector, r.status.value, r.model, r.message))
        out.append([(m, u, h, b) for m, u, h, b in calls])
    return out


@pytest.mark.parametrize("key, model, output_dim", [
    ("k&y", "models/Custom-Model", 768), ("key", "", None), ("", "x", 4),
])
def test_gemini_embedding_client_equals_the_jax_client(key, model, output_dim):
    """Results, statuses, messages and the requests sent (URL, headers,
    body) on the same scripted responses."""
    assert (_gemini_run("omni_recall_tpu_torch", key, model, output_dim)
            == _gemini_run("omni_recall_tpu", key, model, output_dim))


def test_fake_embedding_client_equals_the_jax_client():
    from omni_recall_tpu.ingest import embedding as j
    from omni_recall_tpu_torch.ingest import embedding as t

    def run(mod):
        c = mod.FakeEmbeddingClient(
            [mod.EmbeddingResult([0.1], mod.EmbeddingStatus.RATE_LIMITED, model="m")])
        out = [c.embed("a"), c.embed("b")]
        return [(r.vector, r.status.value, r.model) for r in out], c.calls

    assert run(t) == run(j)
