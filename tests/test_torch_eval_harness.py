"""The port's eval harness (omni_recall_tpu_torch/eval/harness.py and
clients.py) against the JAX package's, on the CPU: the six cases of
tests/test_eval_harness.py run through both packages' in-process apps with
the same scripted chat clients and embeddings, and every report must be
equal. Case ids are pinned (the harness draws them from ``uuid4``) and
``duration_ms`` is dropped (wall time); nothing else may differ. Then the
eval CLI (``python -m omni_recall_tpu_torch.eval``) in a subprocess, on the
CPU when asked and refusing without a card otherwise."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from omni_recall_tpu.chat import router as jrouter
from omni_recall_tpu.config import load_config as jload_config
from omni_recall_tpu.contracts import AiChatResponse as JResponse
from omni_recall_tpu.eval import clients as jclients
from omni_recall_tpu.eval import harness as jharness
from omni_recall_tpu.ingest import embedding as jemb
from omni_recall_tpu.server.app import build_app as jbuild_app
from omni_recall_tpu_torch.chat import router as trouter
from omni_recall_tpu_torch.config import load_config as tload_config
from omni_recall_tpu_torch.contracts import AiChatResponse as TResponse
from omni_recall_tpu_torch.eval import clients as tclients
from omni_recall_tpu_torch.eval import harness as tharness
from omni_recall_tpu_torch.ingest import embedding as temb
from omni_recall_tpu_torch.server.app import build_app as tbuild_app

ROOT = pathlib.Path(__file__).resolve().parent.parent
OVERRIDES = {"Engine:EmbeddingDim": 8, "Engine:CapacityBlock": 128,
             "AiRouting:MaxAttemptsPerProvider": 1, "AiRouting:RetryBaseDelayMs": 0}
PACKAGES = {
    "jax": dict(router=jrouter, load_config=jload_config, response=JResponse,
                clients=jclients, harness=jharness, emb=jemb, build_app=jbuild_app),
    "torch": dict(router=trouter, load_config=tload_config, response=TResponse,
                  clients=tclients, harness=tharness, emb=temb, build_app=tbuild_app),
}


class ScriptedClient:
    def __init__(self, name, steps, default, rate_limit_error):
        self.provider_name = name
        self.steps = list(steps)
        self.default = default
        self.rate_limit_error = rate_limit_error

    def complete(self, request):
        if self.steps:
            step = self.steps.pop(0)
        elif self.default is not None:
            step = self.default
        else:
            raise self.rate_limit_error("exhausted")
        if isinstance(step, Exception):
            raise step
        return step


def _app(pkg: str, chat_default):
    """tests/test_eval_harness.py's ``_app`` in the package ``pkg``;
    ``chat_default`` is "answer" (a citing answer), "down" (a rate-limit
    error) or "plain" (an answer citing nothing)."""
    p = PACKAGES[pkg]
    err = p["router"].AiRateLimitError
    default = {"answer": p["response"]("answer citing [1]", "m", "primary"),
               "down": err("down"), "plain": p["response"]("x", "m", "primary")}[chat_default]
    config = p["load_config"](settings_file=None, env={}, overrides=OVERRIDES)
    router = p["router"].AiChatRouter(
        ScriptedClient("primary", [], default, err), ScriptedClient("fallback", [], None, err),
        config.ai_routing, sleep=lambda s: None)
    fake = p["emb"].FakeEmbeddingClient(
        default=p["emb"].EmbeddingResult([1.0] + [0.0] * 7, p["emb"].EmbeddingStatus.SUCCESS))
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return p["build_app"](config, chat_router=router, embedding_client=fake, **extra)


def _report(pkg: str, chat_default: str, docs, cases):
    p = PACKAGES[pkg]
    app = _app(pkg, chat_default)
    for name, text in docs:
        app.ingestion_service.ingest(name, text, "file")
    client = p["clients"].InProcessClient(app)
    built = [p["harness"].EvalCase(q, f, k, id=f"case-{i}") for i, (q, f, k) in enumerate(cases)]
    report = p["harness"].EvalHarness(client).run(built)
    for r in report["results"]:
        del r["duration_ms"]
    return report


def _both(chat_default, docs, cases):
    want = _report("jax", chat_default, docs, cases)
    got = _report("torch", chat_default, docs, cases)
    assert got == want
    return got


def test_full_eval_run_pass_and_summary():
    report = _both("answer", [("alpha.txt", "alpha document about gardens and plants"),
                              ("beta.txt", "beta memo about finance and budgets")],
                   [("gardens and plants", "alpha.txt", 5),
                    ("finance and budgets", "beta.txt", 5),
                    ("finance and budgets", "MISSING.txt", 5)])
    assert report["summary"]["cases"] == 3
    assert report["summary"]["recall_hit_rate"] == 2 / 3
    statuses = [r["status"] for r in report["results"]]
    assert statuses.count("pass") == 2 and statuses.count("fail") == 1


def test_eval_partial_when_chat_unavailable():
    report = _both("down", [("alpha.txt", "alpha document about gardens")],
                   [("gardens", "alpha.txt", 5)])
    result = report["results"][0]
    assert result["status"] == "partial" and result["recall_hit"] is True
    assert "unavailable" in result["detail"].lower() or "Chat" in result["detail"]


def test_eval_guard_blocks_count_as_fail():
    report = _both("plain", [], [("anything", "missing.txt", 5)])
    result = report["results"][0]
    assert result["status"] == "fail" and result["chat_hit"] is False


def test_generate_cases_from_documents():
    """The generated cases (ids aside) are JAX's, and so is their report."""
    docs = [("doc.txt", "This is the first sentence about solar panels. " * 5)]
    generated = {}
    for pkg, p in PACKAGES.items():
        app = _app(pkg, "plain")
        for name, text in docs:
            app.ingestion_service.ingest(name, text, "file")
        cases = p["harness"].generate_cases(p["clients"].InProcessClient(app))
        generated[pkg] = [(c.question, c.expected_file, c.top_k) for c in cases]
    assert generated["torch"] == generated["jax"]
    assert generated["torch"] and all(f == "doc.txt" for _, f, _ in generated["torch"])
    assert any("solar panels" in q for q, _, _ in generated["torch"])
    _both("plain", docs, generated["torch"])


def test_batch_prompt_format():
    cases = [("Q one?", "f"), ("Q two?", "f")]
    prompts = {pkg: p["harness"].build_batch_prompt([p["harness"].EvalCase(q, f) for q, f in cases])
               for pkg, p in PACKAGES.items()}
    assert prompts["torch"] == prompts["jax"]
    assert "1. Q one?" in prompts["torch"] and "2. Q two?" in prompts["torch"]
    assert prompts["torch"].startswith("Answer each numbered question")


def test_to_topic_first_sentence_first_8_words():
    for text in ("One two three four five six seven eight nine. Rest.", "   ",
                 "Why? Because! it.", "single"):
        assert tharness.to_topic(text) == jharness.to_topic(text)
    assert tharness.to_topic("One two three four five six seven eight nine. Rest.") == \
        "One two three four five six seven eight"
    assert tharness.to_topic("   ") == "the first section"


def test_load_cases_matches_jax(tmp_path):
    path = tmp_path / "cases.json"
    path.write_text(json.dumps([
        {"question": "q1", "expectedFile": "a.txt", "topK": 3},
        {"question": "  ", "expectedFile": "b.txt"},
        {"question": "q3", "expected_file": "c.txt", "topK": "x", "id": "mine"},
        {"question": "q4", "expectedFile": "d.txt", "top_k": True},
    ]))
    want = [vars(c) for c in jharness.load_cases(str(path))]
    got = [vars(c) for c in tharness.load_cases(str(path))]
    assert got == want and len(got) == 3


def _cli(args, tmp_path, env_extra=None):
    for name, text in (("notes.txt", "Solar panels convert sunlight into electricity. The "
                        "inverter turns direct current into alternating current."),
                       ("garden.txt", "Tomatoes need sun and steady water. Basil grows well "
                        "beside them in the garden beds.")):
        (tmp_path / name).write_text(text)
    env = {k: v for k, v in os.environ.items() if not k.startswith("OMNI__")}
    env.update({"OMNI__Embeddings__Provider": "Hash", "OMNI__Engine__Backend": "xla",
                "PYTHONPATH": str(ROOT), **(env_extra or {})})
    return subprocess.run(
        [sys.executable, "-m", "omni_recall_tpu_torch.eval", "--in-process", "--ingest",
         str(tmp_path / "notes.txt"), str(tmp_path / "garden.txt"), "--generate", *args],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)


def test_cli_in_process_on_the_cpu(tmp_path):
    out = _cli(["--device", "cpu", "--out", str(tmp_path / "report.json")], tmp_path)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["recall_hit_rate"] == 1.0 and summary["cases"] >= 2
    assert json.loads((tmp_path / "report.json").read_text())["summary"] == summary


@pytest.mark.parametrize("device_args", [[], ["--device", "cuda"]])
def test_cli_without_a_card_refuses(tmp_path, device_args):
    """Without ``--device cpu`` the CLI asks for CUDA, and with no card it
    exits non-zero naming CUDA: no silent CPU fallback."""
    out = _cli(device_args, tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA" in out.stderr
