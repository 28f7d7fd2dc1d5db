"""Scriptable eval harness (CLI); PyTorch port of
omni_recall_tpu/eval/harness.py, host code copied as it is.

Behavioral mirror of the reference's browser eval runner
(src/OmniRecall.App/src/app/pages/eval/eval.page.ts) — the recall@k parity
instrument. Semantics preserved:

- cases = {question, expectedFile, topK}; grouped by normalized (trim +
  lowercase) expected file (:231-242, :470-472),
- per-case recall probe: topK clamped 1..10, hit when any citation fileName
  matches the expected file (normalized) (:244-289), with x3 retry on
  transient errors (429/503/504 or timeout/rate-limit/unavailable text,
  250ms*attempt backoff, :550-582),
- one batched chat per group: numbered multi-question prompt (:346-360),
  topK = group max; chat hit = citation match AND provider != 'guard'
  (:314-319); provider-unavailable -> the group counts as 'unavailable',
- statuses: pass(recall&chat) / partial(recall & chat-unavailable) / fail /
  error (:362-412),
- case auto-generation from document chunks via 3 question templates with
  topic extraction from the first sentence (:483-515),
- pacing knobs (reference defaults 900ms/probe, 12.5s/group, 20s
  unavailable backoff, :57-59) default to 0 here for offline providers.

Usage:
  python -m omni_recall_tpu_torch.eval --cases cases.json --base-url http://...
  python -m omni_recall_tpu_torch.eval --in-process --generate [--device cpu]
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field


@dataclass
class EvalCase:
    question: str
    expected_file: str
    top_k: int = 5
    id: str = field(default_factory=lambda: f"case-{uuid.uuid4().hex[:12]}")


@dataclass
class EvalResult:
    case_id: str
    status: str  # pass | partial | fail | error
    recall_hit: bool
    chat_hit: bool
    expected_file: str
    recall_top_file: str
    provider_model: str
    detail: str
    duration_ms: int


def _normalize(file_name: str) -> str:
    return file_name.strip().lower()


class TransientApiError(Exception):
    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status


def _is_transient(exc: Exception) -> bool:
    status = getattr(exc, "status", None)
    if status in (429, 503, 504):
        return True
    message = str(exc).lower()
    return any(k in message for k in ("timeout", "temporar", "rate limit", "unavailable"))


def _is_provider_unavailable(exc: Exception) -> bool:
    status = getattr(exc, "status", None)
    if status in (429, 503, 504):
        return True
    message = str(exc).lower()
    return any(
        k in message
        for k in ("both ai providers failed", "provider unavailable", "rate limit", "temporar")
    )


def build_batch_prompt(cases: list[EvalCase]) -> str:
    lines = "\n".join(f"{i + 1}. {c.question.strip()}" for i, c in enumerate(cases))
    return "\n".join(
        [
            "Answer each numbered question using only the retrieved context snippets.",
            "Keep each answer concise and actionable.",
            "Add citation markers like [1], [2] when evidence is used.",
            "Format exactly as numbered list items.",
            "",
            "Questions:",
            lines,
        ]
    )


def to_topic(snippet: str) -> str:
    cleaned = " ".join(snippet.split())
    if not cleaned:
        return "the first section"
    first_sentence = cleaned.replace("!", ".").replace("?", ".").split(".", 1)[0].strip()
    seed = first_sentence or cleaned
    return " ".join(seed.split()[:8])


def generate_cases(client) -> list[EvalCase]:
    """Auto-generate cases from uploaded documents (eval.page.ts:483-515)."""
    documents = client.list_documents()
    if not documents:
        return [EvalCase("Summarize the key points from my uploaded document.", "")]
    templates = [
        lambda topic, f: f'Summarize the section about "{topic}" in {f}.',
        lambda topic, f: f'What concrete outcomes are described in the "{topic}" section of {f}?',
        lambda topic, f: f'Rewrite the "{topic}" section from {f} with stronger, specific wording.',
    ]
    cases: list[EvalCase] = []
    for doc in documents[:8]:  # eval.page.ts:193
        file_name = doc["fileName"]
        chunks = client.get_document_chunks(doc["documentId"])
        candidates = sorted(
            (c for c in chunks if c.get("snippet", "").strip() and len(c["snippet"].strip()) > 20),
            key=lambda c: c["chunkIndex"],
        )[:6]
        if not candidates:
            cases.append(EvalCase(f"Summarize the key points from {file_name}.", file_name))
            continue
        used: set[str] = set()
        doc_cases: list[EvalCase] = []
        for i, chunk in enumerate(candidates):
            topic = to_topic(chunk["snippet"])
            question = templates[i % len(templates)](topic, file_name)
            key = f"{file_name}|{question}".lower()
            if key in used:
                continue
            used.add(key)
            doc_cases.append(EvalCase(question, file_name))
            if len(doc_cases) >= 4:
                break
        cases.extend(doc_cases)
    return cases[:20]  # global cap, eval.page.ts:206


class EvalHarness:
    def __init__(
        self,
        client,
        probe_delay_s: float = 0.0,
        group_delay_s: float = 0.0,
        unavailable_delay_s: float = 0.0,
        sleep=time.sleep,
    ) -> None:
        self.client = client
        self.probe_delay_s = probe_delay_s
        self.group_delay_s = group_delay_s
        self.unavailable_delay_s = unavailable_delay_s
        self.sleep = sleep

    def _with_retry(self, work, max_attempts: int = 3):
        last: Exception | None = None
        for attempt in range(1, max_attempts + 1):
            try:
                return work()
            except Exception as exc:
                last = exc
                if not _is_transient(exc) or attempt >= max_attempts:
                    raise
                self.sleep(0.25 * attempt)
        raise last or RuntimeError("Evaluation request failed.")

    def _run_recall_probe(self, case: EvalCase) -> dict:
        expected = case.expected_file.strip()
        question = case.question.strip()
        top_k = min(10, max(1, case.top_k or 5))
        if not question or not expected:
            return {
                "case": case, "recall_hit": False, "top_file": "",
                "error": "Question and expected file are required.", "top_k": top_k,
            }
        try:
            recall = self._with_retry(lambda: self.client.search_recall(question, top_k))
            expected_norm = _normalize(expected)
            hit = any(_normalize(c["fileName"]) == expected_norm for c in recall["citations"])
            top_file = recall["citations"][0]["fileName"] if recall["citations"] else ""
            return {"case": case, "recall_hit": hit, "top_file": top_file, "error": "", "top_k": top_k}
        except Exception as exc:
            return {"case": case, "recall_hit": False, "top_file": "", "error": str(exc), "top_k": top_k}

    def _run_batch_chat(self, group: list[EvalCase]) -> dict:
        valid = [c for c in group if c.expected_file.strip() and c.question.strip()]
        if not valid:
            return {"available": False, "chat_hit": False, "guard": False,
                    "provider_model": "n/a", "detail": "No valid questions in this batch."}
        top_k = max(min(10, max(1, c.top_k or 5)) for c in valid)
        expected_norm = _normalize(valid[0].expected_file)
        prompt = build_batch_prompt(valid)
        try:
            chat = self._with_retry(lambda: self.client.chat(prompt, top_k))
            hit = any(_normalize(c["fileName"]) == expected_norm for c in chat["citations"])
            guard = chat["provider"] == "guard"
            return {
                "available": True, "chat_hit": hit and not guard, "guard": guard,
                "provider_model": f"{chat['provider']} / {chat['model']}",
                "detail": "Insufficient evidence guard." if guard else "Batch chat complete.",
            }
        except Exception as exc:
            prefix = "Chat unavailable" if _is_provider_unavailable(exc) else "Chat failed"
            return {"available": False, "chat_hit": False, "guard": False,
                    "provider_model": "n/a", "detail": f"{prefix}: {exc}"}

    @staticmethod
    def _result(probe: dict, chat: dict, duration_ms: int) -> EvalResult:
        case: EvalCase = probe["case"]
        if probe["error"]:
            return EvalResult(case.id, "error", False, False, case.expected_file,
                              probe["top_file"], "n/a", f"Recall error: {probe['error']}", duration_ms)
        if not chat["available"]:
            status = "partial" if probe["recall_hit"] else "fail"
            return EvalResult(case.id, status, probe["recall_hit"], False, case.expected_file,
                              probe["top_file"], chat["provider_model"], chat["detail"], duration_ms)
        notes = []
        if not probe["recall_hit"]:
            notes.append("Recall miss")
        if not chat["chat_hit"]:
            notes.append("Insufficient evidence guard" if chat["guard"] else "Chat citation miss")
        if not notes:
            notes.append("Passed")
        status = "pass" if probe["recall_hit"] and chat["chat_hit"] else "fail"
        return EvalResult(case.id, status, probe["recall_hit"], chat["chat_hit"],
                          case.expected_file, probe["top_file"], chat["provider_model"],
                          " | ".join(notes), duration_ms)

    def run(self, cases: list[EvalCase]) -> dict:
        groups: dict[str, list[EvalCase]] = {}
        for case in cases:
            key = _normalize(case.expected_file) or f"__case__{case.id}"
            groups.setdefault(key, []).append(case)

        results: list[EvalResult] = []
        group_list = list(groups.values())
        for gi, group in enumerate(group_list):
            probes = []
            for case in group:
                start = time.monotonic()
                probe = self._run_recall_probe(case)
                probe["probe_start"] = start
                probe["duration_ms"] = int((time.monotonic() - start) * 1000)
                probes.append(probe)
                if self.probe_delay_s:
                    self.sleep(self.probe_delay_s)
            chat = self._run_batch_chat(group)
            for probe in probes:
                # durationMs spans from the case's probe start through the
                # batch-chat stage (eval.page.ts:162 stamps at run start)
                total_ms = int((time.monotonic() - probe["probe_start"]) * 1000)
                results.append(self._result(probe, chat, total_ms))
            if gi < len(group_list) - 1:  # between groups only (:166)
                if not chat["available"] and self.unavailable_delay_s:
                    self.sleep(self.unavailable_delay_s)
                elif self.group_delay_s:
                    self.sleep(self.group_delay_s)

        n = len(results) or 1
        summary = {
            "cases": len(results),
            "recall_hit_rate": sum(r.recall_hit for r in results) / n,
            "chat_hit_rate": sum(r.chat_hit for r in results) / n,
            "pass": sum(r.status == "pass" for r in results),
            "partial": sum(r.status == "partial" for r in results),
            "fail": sum(r.status == "fail" for r in results),
            "error": sum(r.status == "error" for r in results),
        }
        return {
            "summary": summary,
            "results": [r.__dict__ for r in results],
        }


def load_cases(path: str) -> list[EvalCase]:
    raw = json.loads(open(path, encoding="utf-8").read())
    cases = []
    for i, c in enumerate(raw):
        # parseCase parity (eval.page.ts:450-452): non-numeric topK
        # defaults to 5, blank questions are DROPPED (not error-counted)
        question = str(c.get("question") or "")
        if not question.strip():
            continue
        top_k = c.get("topK", c.get("top_k"))
        if not isinstance(top_k, (int, float)) or isinstance(top_k, bool):
            top_k = 5
        cases.append(EvalCase(
            question=question,
            expected_file=c.get("expectedFile", c.get("expected_file", "")),
            top_k=int(top_k),
            id=c.get("id", f"case-{i}"),
        ))
    return cases
