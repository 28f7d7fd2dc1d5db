"""The port's continuous batcher (omni_recall_tpu_torch/chat/serving.py),
its local chat client (chat/local.py) and ``Ai:Provider=Local`` in the
app, on the CPU at a small size (d_model 32, 2 layers, max_len 160).

Pinned down: greedy streams equal ``decoder.generate``'s for the same
prompt, bit for bit (a request joining mid-generation included); a slot's
stream does not depend on the batch's composition; EOS frees a slot for a
queued request; sampling is reproducible per request, and equal to the JAX
batcher's streams; both schedulers answer alike; the app answers
``POST /api/chat`` through the batcher and ``/health`` shows ``ai-local``.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from omni_recall_tpu.chat.serving import ContinuousBatcher as JBatcher
from omni_recall_tpu.config import load_config as jload
from omni_recall_tpu.models import decoder as jdec
from omni_recall_tpu.server.app import build_app as jbuild
from omni_recall_tpu_torch.chat.local import LocalDecoderChatClient
from omni_recall_tpu_torch.chat.serving import ContinuousBatcher
from omni_recall_tpu_torch.config import load_config
from omni_recall_tpu_torch.contracts import AiChatRequest
from omni_recall_tpu_torch.models import decoder
from omni_recall_tpu_torch.models import encoder as tenc
from omni_recall_tpu_torch.server.app import build_app
from omni_recall_tpu_torch.server.testing import TestClient

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs in parallel worker processes, and these tensors are
    small: one intra-op thread a process (also in the threads the batcher
    and the ingestion start) keeps the workers from oversubscribing the
    cores (without it these files ran 20-75 times slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFG = decoder.DecoderConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=160)
STATE = decoder.init_params(7, CFG)
WEIGHTS = decoder.serving_weights(STATE, CFG, "cpu")
BUCKETS = (32, 64)


def _batcher(temperature=0.0, slots=2, chunk=4, weights=WEIGHTS):
    return ContinuousBatcher(decoder, weights, CFG, slots=slots, chunk=chunk,
                             temperature=temperature, prompt_buckets=BUCKETS)


def _reference(toks, n_steps, temperature=0.0, seed=0):
    bucket = next((b for b in BUCKETS if b >= len(toks) and b + n_steps <= CFG.max_len),
                  CFG.max_len - n_steps)
    out = decoder.generate(WEIGHTS, decoder.pad_left_batch([toks], bucket), CFG, n_steps,
                           seed, temperature=temperature)[0].tolist()
    clean = []
    for t in out:
        if t in (decoder.EOS, decoder.PAD):
            break
        clean.append(t)
    return clean


def _run_all(batcher, prompts, seeds, max_new):
    results = [None] * len(prompts)

    def run(i):
        results[i] = batcher.generate_sync(prompts[i], seeds[i], max_new)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


def test_greedy_streams_equal_generate_with_more_requests_than_slots():
    batcher = _batcher(slots=2, chunk=4)
    prompts = [decoder.encode_text(f"prompt number {i} " * (i + 1)) for i in range(5)]
    try:
        results = _run_all(batcher, prompts, list(range(5)), 20)
        for i, toks in enumerate(prompts):
            assert results[i] == _reference(toks, 20), i
    finally:
        batcher.shutdown()


def test_request_joining_mid_generation_keeps_both_streams():
    batcher = _batcher(slots=2, chunk=4)
    first, second = decoder.encode_text("alpha prompt"), decoder.encode_text("beta text")
    try:
        req = batcher.submit(first, 0, 24)
        while batcher.chunks_run < 2 and not req.event.is_set():
            req.event.wait(0.001)
        joined = batcher.generate_sync(second, 0, 24)
        req.event.wait()
        assert batcher.chunks_run > 2
        assert req.tokens == _reference(first, 24)
        assert joined == _reference(second, 24)
    finally:
        batcher.shutdown()


def test_isolation_under_concurrent_requests():
    toks_a = decoder.encode_text("alpha prompt")
    alone = _batcher()
    try:
        want = alone.generate_sync(toks_a, 0, 10)
    finally:
        alone.shutdown()
    batcher = _batcher(slots=3)
    try:
        res = _run_all(batcher, [toks_a, decoder.encode_text("a very different beta prompt"),
                                 decoder.encode_text("gamma")], [0, 0, 0], 10)
        assert res[0] == want and res[1]
    finally:
        batcher.shutdown()


def test_eos_frees_the_slot_for_a_queued_request():
    """An all-zero LM head ties every emittable logit: greedy picks EOS, the
    lowest id, so the first request ends at once and its slot admits the
    queued one (1 slot, 2 requests)."""
    eos = decoder.serving_weights({**STATE, "lm_head": torch.zeros_like(STATE["lm_head"])},
                                  CFG, "cpu")
    batcher = _batcher(slots=1, weights=eos)
    try:
        assert _run_all(batcher, [decoder.encode_text("one"), decoder.encode_text("two")],
                        [0, 0], 32) == [[], []]
        assert batcher.chunks_run == 2
    finally:
        batcher.shutdown()


def test_budget_retires_and_the_slot_is_reusable():
    batcher = _batcher(slots=1, chunk=4)
    toks = decoder.encode_text("budget test")
    try:
        out = batcher.generate_sync(toks, 0, 5)
        assert len(out) <= 5
        assert batcher.generate_sync(toks, 0, 5) == out
    finally:
        batcher.shutdown()


def test_sampling_is_reproducible_per_request_and_equals_jax():
    toks = decoder.encode_text("sample me")
    alone = _batcher(temperature=0.8)
    try:
        want = alone.generate_sync(toks, 123, 12)
    finally:
        alone.shutdown()
    assert want
    batcher = _batcher(temperature=0.8)
    try:
        res = _run_all(batcher, [toks, decoder.encode_text("other")], [123, 9], 12)
        assert res[0] == want
    finally:
        batcher.shutdown()
    jparams = jdec.init_params(jax.random.PRNGKey(7), jdec.DecoderConfig(
        d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=160, compute_dtype="float32"))
    f32 = decoder.DecoderConfig(**{**CFG.__dict__, "compute_dtype": "float32"})
    mine = ContinuousBatcher(decoder, decoder.serving_weights(
        tenc.params_from_numpy(jax.tree.map(np.asarray, jparams)), f32, "cpu"), f32,
        slots=2, chunk=4, temperature=0.8, prompt_buckets=BUCKETS)
    theirs = JBatcher(jdec, jax, jparams, jdec.DecoderConfig(**f32.__dict__), slots=2,
                      chunk=4, temperature=0.8, prompt_buckets=BUCKETS)
    try:
        for seed in (1, 2):
            assert mine.generate_sync(toks, seed, 16) == theirs.generate_sync(toks, seed, 16)
    finally:
        mine.shutdown()
        theirs.shutdown()


def test_chunked_prefill_serves_the_same_stream_in_f32():
    f32 = decoder.DecoderConfig(**{**CFG.__dict__, "compute_dtype": "float32"})
    w = decoder.serving_weights(STATE, f32, "cpu")
    toks = decoder.encode_text("chunked prefill " * 3)
    whole = ContinuousBatcher(decoder, w, f32, slots=2, chunk=4, prompt_buckets=BUCKETS)
    chunked = ContinuousBatcher(decoder, w, f32, slots=2, chunk=4, prompt_buckets=BUCKETS,
                                prefill_chunk=16, prefill_budget=1)
    try:
        assert whole.generate_sync(toks, 0, 12) == chunked.generate_sync(toks, 0, 12)
    finally:
        whole.shutdown()
        chunked.shutdown()


def test_both_schedulers_answer_alike_and_deterministically():
    kw = dict(max_new_tokens=10, cfg=CFG, params=STATE, device="cpu")
    cont = LocalDecoderChatClient(scheduler="continuous", chunk_tokens=4, **kw)
    coal = LocalDecoderChatClient(scheduler="coalesce", **kw)
    try:
        prompts = [f"compare schedulers {i}" for i in range(3)]
        a = [cont.complete(AiChatRequest(p)).text for p in prompts]
        b = [coal.complete(AiChatRequest(p)).text for p in prompts]
        assert a == b and all(a)
        results = {}

        def worker(p):
            results[p] = coal.complete(AiChatRequest(p)).text

        threads = [threading.Thread(target=worker, args=(p,)) for p in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert [results[p] for p in prompts] == b
        resp = cont.complete(AiChatRequest(prompts[0]))
        assert (resp.provider, resp.model) == ("local", "local-decoder")
    finally:
        cont.shutdown()


def test_empty_answer_raises_and_warmup_runs():
    eos = {**STATE, "lm_head": torch.zeros_like(STATE["lm_head"])}
    client = LocalDecoderChatClient(params=eos, cfg=CFG, max_new_tokens=4, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="empty answer"):
            client.complete(AiChatRequest("anything"))
        t = client.warmup_async()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        client.shutdown()


def test_checkpoint_from_either_package_loads(tmp_path):
    path = str(tmp_path / "dec.npz")
    jcfg = jdec.DecoderConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=160)
    jparams = jdec.init_params(jax.random.PRNGKey(7), jcfg)
    jdec.save_params(path, jparams, jcfg)
    client = LocalDecoderChatClient(checkpoint=path, max_new_tokens=8, device="cpu")
    assert client.cfg == CFG and path in client.model
    want = tenc.flatten_tree(jax.tree.map(np.asarray, jparams))
    assert all(np.array_equal(client.weights.p[k].numpy(), v) for k, v in want.items())


LOCAL_OVERRIDES = {
    "Ai:Provider": "Local", "Ai:LocalMaxNewTokens": "12", "Ai:LocalWarmup": "false",
    "Embeddings:Provider": "Hash", "Embeddings:Dim": 64, "Engine:EmbeddingDim": 64,
    "Engine:Backend": "xla", "Ingestion:ChunkSizeWords": 20,
    "ChatQuality:EnableRecallOnlyFallbackOnProviderFailure": "true",
}


def test_local_provider_answers_chat_through_the_batcher():
    app = build_app(load_config(settings_file=None, env={}, overrides=LOCAL_OVERRIDES),
                    device="cpu")
    client = TestClient(app)
    try:
        assert app.chat_router._primary is app.local_chat
        assert app.local_chat._scheduler == "continuous"
        resp = client.upload("/api/documents/upload", filename="notes.txt",
                             data=b"Basil grows beside tomatoes and needs steady water.")
        assert resp.status == 201
        seen = []
        batcher = app.local_chat._get_batcher()
        real = batcher.generate_sync
        batcher.generate_sync = lambda toks, seed, n: seen.append((toks, seed)) or real(
            toks, seed, n)
        resp = client.post("/api/chat", json_body={"prompt": "Basil grows beside tomatoes and needs steady water."})
        assert resp.status == 200, resp.body
        assert len(seen) == 1 and batcher.chunks_run >= 1
        body = resp.json()
        # the untrained decoder answers (or the guard falls back to recall):
        # either way the answer comes through the local provider's path
        assert body["answer"]
    finally:
        app.local_chat.shutdown()


def test_health_shows_ai_local_as_the_jax_app_does():
    overrides = {**LOCAL_OVERRIDES, "Engine:Backend": "oracle"}
    tapp = build_app(load_config(settings_file=None, env={}, overrides=overrides),
                     device="cpu")
    japp = jbuild(jload(settings_file=None, env={}, overrides=overrides))
    mine, theirs = tapp.health_service.probe(), japp.health_service.probe()
    assert [(d.name, d.status) for d in mine.dependencies] == [
        (d.name, d.status) for d in theirs.dependencies]
    names = {d.name: d.status for d in mine.dependencies}
    assert names["ai-local"] == "healthy" and "ai-gemini" not in names
    assert mine.status == theirs.status == "healthy"


def test_a_failed_chunk_fails_its_requests_and_the_batcher_recovers(monkeypatch):
    """An error in a decode chunk fails every in-flight request and rebuilds
    the serving state on the same device; later requests are served."""
    batcher = _batcher()
    real = decoder.decode_chunk
    calls = {"n": 0}

    def failing_once(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected chunk failure")
        return real(*a, **kw)

    monkeypatch.setattr(decoder, "decode_chunk", failing_once)
    toks = decoder.encode_text("recover me")
    try:
        with pytest.raises(RuntimeError, match="injected"):
            batcher.generate_sync(toks, 0, 12)
        assert batcher.generate_sync(toks, 0, 12) == _reference(toks, 12)
        assert batcher._state.logits.device.type == "cpu"
    finally:
        batcher.shutdown()
