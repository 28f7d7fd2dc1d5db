"""The local models' tools of the port (omni_recall_tpu_torch/tools:
``localq``, ``probe_localq``, ``train_embedder_demo``, ``train_chat_demo``,
``bench_decode``) on the CPU at small sizes: each runs end to end, and the
localq recipe draws the bench's corpus and pairs."""

import numpy as np
import pytest
import torch

from omni_recall_tpu_torch.models import encoder
from omni_recall_tpu_torch.tools import (
    bench_decode,
    localq,
    probe_localq,
    train_chat_demo,
    train_embedder_demo,
)

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

SMALL = encoder.EncoderConfig(vocab_size=2048, d_model=32, n_layers=1, n_heads=2, d_ff=64,
                              max_len=16, out_dim=64)


def test_localq_corpus_is_the_bench_recipe():
    assign, contents, n_clusters = localq.corpus(1 << 12)
    assert n_clusters == 256  # max(256, n // 24)
    want = np.random.default_rng(7).integers(0, 256, size=1 << 12)
    assert np.array_equal(assign, want)
    assert contents[5] == f"topic c{want[5]}x note r5"
    assert localq.LQ_CFG == encoder.EncoderConfig(vocab_size=8192, d_model=128, n_layers=2,
                                                  n_heads=4, d_ff=256, max_len=32,
                                                  out_dim=768)


def test_localq_fine_tune_pairs_are_the_bench_draws(monkeypatch):
    from omni_recall_tpu_torch.models import finetune

    assign, contents, _ = localq.corpus(1024)
    seen = []
    monkeypatch.setattr(finetune, "train_pairs",
                        lambda params, pairs, cfg, steps, **kw: seen.extend(
                            pairs(i) for i in range(steps)))
    localq.finetune(SMALL, assign, contents, steps=2, device="cpu")
    rng = np.random.default_rng(3)
    for queries, rows_contents in seen:
        rows = rng.integers(0, 1024, size=256)
        assert queries == [f"c{assign[i]}x" for i in rows]
        assert rows_contents == [contents[i] for i in rows]


def test_localq_engine_serves_and_resolves_after_training():
    timings = {}
    engine, make_reqs, n, client = localq.build_localq_engine(
        2048, d=64, bits=256, cfg=SMALL, steps=40, device="cpu", timings=timings)
    assert n == 2048 and engine._device_embedder is client
    assert timings["losses"][1] < timings["losses"][0]
    from datetime import timedelta

    from omni_recall_tpu_torch.index.device_index import EPOCH

    reqs = make_reqs(1, 16)
    res = engine.search_batch(reqs, now=EPOCH + timedelta(days=365.0))
    assert len(res) == 16 and all(len(r) == 10 for r in res)


def test_probe_localq_runs(capsys):
    out = probe_localq.main(["--rows", "2048", "--batch", "32", "--groups", "2", "--steps",
                             "5", "--device", "cpu"])
    assert out["qps"] > 0 and len(out["split"]) == 3
    assert '"summary": "probe_localq"' in capsys.readouterr().out


def test_train_embedder_demo_improves_retrieval():
    out = train_embedder_demo.main(["--steps", "30", "--device", "cpu"])
    assert out["loss_last"] < out["loss_first"]
    assert out["accuracy_after"] > out["accuracy_before"]


def test_train_chat_demo_trains_and_answers(tmp_path, monkeypatch):
    from omni_recall_tpu_torch.models import decoder

    monkeypatch.setattr(train_chat_demo, "CFG", decoder.DecoderConfig(
        d_model=32, n_layers=1, n_heads=2, d_ff=64, max_len=320))
    path = str(tmp_path / "chat.npz")
    out = train_chat_demo.main(["--steps", "30", "--device", "cpu", "--save", path])
    assert out["loss_last"] < out["loss_first"] and len(out["answers"]) == 4
    state, cfg = decoder.load_params(path)
    assert cfg.d_model == 32 and "lm_head" in state


def test_bench_decode_runs():
    out = bench_decode.main(["--d", "32", "--layers", "1", "--heads", "2", "--ff", "64",
                             "--batch", "2", "--prompt", "16", "--steps", "4",
                             "--max-len", "256", "--device", "cpu"])
    assert out["prefill_ms"] > 0 and out["decode_ms_per_step"] == pytest.approx(
        (out["generate_ms"] - out["prefill_ms"]) / 4)
    assert "full_window_generate_ms" in out
