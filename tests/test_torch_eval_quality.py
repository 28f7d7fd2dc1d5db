"""The retrieval quality campaign of the port (omni_recall_tpu_torch/eval/
quality.py) against the JAX package's (omni_recall_tpu/eval/quality.py) on
the CPU, at the JAX test's length (150 fine-tune steps).

- The fine-tune's batches: the first steps' (query, content) pairs, drawn
  from ``random.Random(seed)`` and shuffled by ``np.random.default_rng(seed)``,
  are JAX's text for text.
- ``hash`` recall@10 equals JAX's exactly (same embeddings, the oracle).
- ``local-untrained`` is within 1/n of JAX's (n cases): the seed-0 weights
  are JAX's within a few f32 ulps, so at most one case may flip on a
  near-tie.
- ``local-trained`` is within 0.03 of JAX's: 150 AdamW steps in another
  framework drift apart in their last bits.
- The JAX test's three orderings hold for the port: hash >= 0.8, trained >
  untrained, trained >= hash.
"""

import numpy as np
import pytest
import torch

from omni_recall_tpu.eval import quality as jquality
from omni_recall_tpu.models import encoder as jenc
from omni_recall_tpu_torch.eval import corpus, quality
from omni_recall_tpu_torch.models import encoder
from omni_recall_tpu_torch.models import finetune as tft

STEPS = 150


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_first_pairs_and_shuffle_order_are_jax_s(monkeypatch):
    """Three steps' batches of both fine-tunes, text for text (the JAX train
    step replaced by one that returns its inputs: only the draws matter)."""
    jax_texts = []
    real_tokenize = jenc.tokenize_batch

    def recording_tokenize(texts, cfg):
        jax_texts.append(list(texts))
        return real_tokenize(texts, cfg)

    class _NoOpt:
        def init(self, params):
            return ()

    monkeypatch.setattr(jenc, "tokenize_batch", recording_tokenize)
    monkeypatch.setattr(jenc, "make_train_step",
                        lambda cfg, opt: (_NoOpt(), lambda p, o, q, c: (p, o, 0.0)))
    jstore, _ = jquality.build_corpus()
    jquality.finetune_encoder_on_corpus(jstore, steps=3, seed=0)

    port_texts = []

    def recording_train(params, pairs, cfg, steps, lr=3e-4, device="cuda", on_step=None):
        assert lr == 3e-4
        for step in range(steps):
            port_texts.extend(pairs(step))
        return params

    monkeypatch.setattr(tft, "train_pairs", recording_train)
    store, _ = corpus.build_corpus()
    quality.finetune_encoder_on_corpus(store, steps=3, seed=0, device="cpu")
    assert len(port_texts) == len(jax_texts) == 6
    assert port_texts == jax_texts
    assert all(len(batch) == 64 for batch in port_texts)


@pytest.fixture(scope="module")
def results():
    return jquality.evaluate_embedders(steps=STEPS), \
        quality.evaluate_embedders(steps=STEPS, device="cpu")


def _n_cases() -> int:
    store, _ = corpus.build_corpus()
    return len(corpus.generate_cases(store))


def test_hash_recall_equals_jax(results):
    want, got = results
    assert got["hash"] == want["hash"]


def test_untrained_encoder_within_one_case_of_jax(results):
    want, got = results
    assert abs(got["local-untrained"] - want["local-untrained"]) <= 1.0 / _n_cases() + 1e-12


def test_trained_encoder_within_tolerance_of_jax(results):
    want, got = results
    assert abs(got["local-trained"] - want["local-trained"]) <= 0.03, (got, want)


def test_trained_encoder_beats_hash_baseline(results):
    _, got = results
    assert got["hash"] >= 0.8, got
    assert got["local-trained"] > got["local-untrained"], got
    assert got["local-trained"] >= got["hash"], got


def test_encoder_embed_fn_is_one_forward_a_text():
    cfg = quality.encoder_config()
    embed = quality.encoder_embed_fn(encoder.init_params(0, cfg), cfg, "cpu")
    v = np.asarray(embed("notes on subject001"))
    assert v.shape == (corpus.DIM,) and abs(float(np.linalg.norm(v)) - 1.0) < 1e-5


def test_campaign_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quality.evaluate_embedders(steps=1)
    cfg = quality.encoder_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        quality.encoder_embed_fn(encoder.init_params(0, cfg), cfg)
