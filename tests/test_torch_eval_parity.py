"""The recall@10 parity campaign of the port (omni_recall_tpu_torch/eval/
corpus.py ``parity_campaign``) on the CPU, with the kernels' plain
versions: over the same seeded corpus and the 200+ generated cases of
tests/test_eval_parity.py, the port's int8 device engine is DTO-identical
to its float64 oracle (every citation field, the score rounded to 4
decimals), the port's oracle citations equal the JAX package's oracle
citations case for case, and the hit rate is at least 0.8. Run at the JAX
test's engine (d 64, 256 bloom bits, capacity 512, m 16) and with the
headline's features (device-exact cosine, direct selection) at the same
widths."""

from dataclasses import asdict

import pytest
import torch

from omni_recall_tpu.config import EngineOptions as JOptions
from omni_recall_tpu.eval import corpus as jcorpus
from omni_recall_tpu.models import hash_embedder as jhash
from omni_recall_tpu.search.engine import RecallEngine as JEngine
from omni_recall_tpu.search.service import RecallSearchService as JService
from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.eval import corpus

JAX_TEST = dict(backend="pallas", embedding_dim=corpus.DIM, capacity_block=512,
                candidate_m=16, bloom_bits=256, recent_window=0, scan_dtype="int8")
ENGINES = {"jax_test": JAX_TEST,
           "headline_features": dict(JAX_TEST, device_exact_cos=True, direct_select=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _HashProvider:
    def embed(self, text: str):
        class R:
            vector = jhash.embed_text(text, jcorpus.DIM)
        return R()


@pytest.fixture(scope="module")
def jax_oracle_citations():
    store, _ = jcorpus.build_corpus()
    svc = JService(JEngine(store, None, JOptions(backend="oracle", recent_window=0)),
                   _HashProvider())
    cases = jcorpus.generate_cases(store, min_cases=200)
    return [(c.question, [asdict(x) for x in svc.search(c.question, c.top_k,
                                                        now=jcorpus.NOW).citations])
            for c in cases]


def test_corpus_and_cases_are_jax_s():
    jstore, jchunks = jcorpus.build_corpus()
    tstore, tchunks = corpus.build_corpus()
    assert [(c.id, c.content, c.embedding, c.created_at_utc) for c in tchunks] == \
        [(c.id, c.content, c.embedding, c.created_at_utc) for c in jchunks]
    assert [(c.question, c.expected_file, c.top_k) for c in corpus.generate_cases(tstore)] == \
        [(c.question, c.expected_file, c.top_k) for c in jcorpus.generate_cases(jstore)]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_recall_at_10_parity_campaign_oracle_vs_int8(engine, jax_oracle_citations):
    report = corpus.parity_campaign(EngineOptions(**ENGINES[engine]), device="cpu")
    assert report["cases"] >= 200
    assert not report["mismatches"], \
        f"{len(report['mismatches'])} DTO mismatches; first: {report['mismatches'][0]}"
    # the port's oracle is the JAX package's, case for case
    assert report["oracle"] == [c for _, c in jax_oracle_citations]
    assert report["hit_rate"] >= 0.8, report["hit_rate"]


def test_parity_campaign_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        corpus.parity_campaign(EngineOptions(**JAX_TEST))
