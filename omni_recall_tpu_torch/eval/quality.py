"""Retrieval QUALITY campaign: recall@10 per embedding provider (PyTorch port
of omni_recall_tpu/eval/quality.py).

The parity campaign (``eval/corpus.py parity_campaign``) proves the device
path returns bit-identical rankings to the float64 oracle — but says
nothing about whether those rankings are GOOD. This module measures the
number a user actually cares about: the recall@10 hit rate (expected
document retrieved in the top 10, the eval semantics of
src/OmniRecall.App/src/app/pages/eval/eval.page.ts:108-175) on one fixed
corpus + case set (eval/corpus.py), across embedding providers:

- ``hash`` — the deterministic feature-hashed bag-of-words embedder
  (models/hash_embedder.py), the out-of-box local provider,
- ``local-untrained`` — the transformer encoder at its seed init
  (models/encoder.py ``init_params``: the JAX package's seed-0 weights),
- ``local-trained`` — the same encoder contrastively fine-tuned ON THE
  CORPUS ITSELF (``finetune_encoder_on_corpus``). Training pairs use
  paraphrase templates DISJOINT from the three eval templates, so the
  gain reflects domain adaptation to the corpus, not memorizing the
  eval questions.

The pairs are drawn from ``random.Random(seed)`` and the batches from
``np.random.default_rng(seed)`` in the reference's order, so both packages
train on the same batches; the steps are ``models/encoder.py``'s AdamW(3e-4)
(``models/finetune.train_pairs``). Scoring runs through the exact oracle
engine: quality differences are then attributable to the EMBEDDINGS alone.
Every entry point runs on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import random

import numpy as np

from omni_recall_tpu_torch.config import EngineOptions
from omni_recall_tpu_torch.eval.corpus import DIM, NOW, build_corpus, generate_cases
from omni_recall_tpu_torch.eval.harness import to_topic
from omni_recall_tpu_torch.models import hash_embedder
from omni_recall_tpu_torch.search.engine import RecallEngine

# paraphrase templates for TRAINING pairs — deliberately disjoint from the
# three eval templates in eval/corpus.py generate_cases. Question-shaped
# variants teach the encoder that interrogative filler carries no content
# (real queries are questions); none shares an eval template's surface form.
_TRAIN_TEMPLATES = (
    "notes on {t}",
    "information regarding {t}",
    "tell me about {t}",
    "{t} overview",
    "facts concerning {t}",
    "where do my notes mention {t}?",
    "can you look up {t} for me?",
    "is there anything written on {t}?",
    "show me every record covering {t}",
    "{t} - find the relevant entries",
)


def encoder_config():
    """The campaigns' small encoder (quality.py:145-148, real_corpus.py:
    220-223): out_dim is both corpora's DIM, 64."""
    from omni_recall_tpu_torch.models import encoder

    return encoder.EncoderConfig(
        vocab_size=8192, d_model=128, n_layers=2, n_heads=4, d_ff=256,
        max_len=48, out_dim=DIM,
    )


def training_pairs(store, seed: int = 0) -> list[tuple[str, str]]:
    """(filler-augmented topic paraphrase, chunk content) for every chunk of
    every document, drawn from ``random.Random(seed)`` as the reference
    draws them."""
    rng = random.Random(seed)

    def _rand_word():
        import string as _s

        return "".join(rng.choices(_s.ascii_lowercase, k=rng.randint(3, 9)))

    def _augment(q: str) -> str:
        # filler-word augmentation: real queries carry words the corpus has
        # never seen (interrogative scaffolding, typos); their hashed token
        # embeddings sit at random init and dilute the mean-pooled topic
        # signal. Injecting random unseen words at TRAIN time makes that
        # noise in-distribution, so the encoder learns to keep the topic
        # component dominant under arbitrary filler.
        words = q.split()
        for _ in range(rng.randint(0, 3)):
            words.insert(rng.randint(0, len(words)), _rand_word())
        return " ".join(words)

    pairs: list[tuple[str, str]] = []
    for doc in store.list_documents(10**6):
        chunks = sorted(
            store.get_chunks_by_document_id(doc.id), key=lambda c: c.chunk_index
        )
        if not chunks:
            continue
        topic = to_topic(chunks[0].content)
        for c in chunks:
            tmpl = rng.choice(_TRAIN_TEMPLATES)
            pairs.append((_augment(tmpl.format(t=topic)), c.content))
    return pairs


def finetune_encoder_on_corpus(
    store, cfg=None, steps: int = 200, seed: int = 0, batch: int = 64, device="cuda",
):
    """Contrastive (InfoNCE, in-batch negatives) fine-tune of the local
    encoder on (topic-paraphrase query, chunk content) pairs drawn from the
    corpus documents: each step shuffles the pair order with
    ``np.random.default_rng(seed)`` and takes its first ``batch``. Returns
    (params, cfg); params is a state dict on ``device``."""
    from omni_recall_tpu_torch.models import encoder
    from omni_recall_tpu_torch.models.finetune import train_pairs

    cfg = cfg or encoder_config()
    pairs = training_pairs(store, seed)
    nrng = np.random.default_rng(seed)
    order = np.arange(len(pairs))

    def batch_pairs(_step):
        nrng.shuffle(order)
        idx = order[:batch]
        return [pairs[i][0] for i in idx], [pairs[i][1] for i in idx]

    params = train_pairs(encoder.init_params(seed, cfg), batch_pairs, cfg, steps, lr=3e-4,
                         device=device)
    return params, cfg


def encoder_embed_fn(params, cfg, device="cuda"):
    """``embed(text) -> list[float]``: one forward of the text alone (the
    reference's ``_encoder_embed_fn``), on ``device``."""
    import torch

    from omni_recall_tpu_torch.models import encoder

    model = encoder.Encoder.from_state(params, cfg, device)
    dev = next(model.parameters()).device

    def embed(text: str):
        ids = torch.from_numpy(encoder.tokenize_batch([text], cfg)).to(dev)
        return model(ids)[0].cpu().numpy().tolist()

    return embed


def _recall_at_10(embed, device="cuda") -> float:
    store, _ = build_corpus(embed=embed)
    cases = generate_cases(store)
    engine = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=0), device=device
    )
    hits = 0
    for case in cases:
        res = engine.search(case.question, embed(case.question), case.top_k, now=NOW)
        files = set()
        for h in res:
            doc = store.get_document(h.chunk.document_id)
            if doc:
                files.add(doc.file_name)
        hits += case.expected_file in files
    return hits / len(cases)


def evaluate_embedders(steps: int = 200, seed: int = 0, device="cuda") -> dict[str, float]:
    """recall@10 per provider on the shared corpus/case set. The trained
    encoder must beat the hash baseline (tests/test_torch_eval_quality.py
    holds that) — the quality target the parity campaign cannot see."""
    from omni_recall_tpu_torch.device import resolve_device
    from omni_recall_tpu_torch.models import encoder as enc

    dev = resolve_device(device)
    results: dict[str, float] = {}
    results["hash"] = _recall_at_10(
        lambda text: hash_embedder.embed_text(text, DIM), dev
    )
    store, _ = build_corpus()  # texts only; embeddings replaced per provider
    cfg = encoder_config()
    untrained = enc.init_params(seed, cfg)
    results["local-untrained"] = _recall_at_10(encoder_embed_fn(untrained, cfg, dev), dev)
    trained, cfg_t = finetune_encoder_on_corpus(store, cfg=cfg, steps=steps, seed=seed,
                                                device=dev)
    results["local-trained"] = _recall_at_10(encoder_embed_fn(trained, cfg_t, dev), dev)
    return results


def main() -> None:  # pragma: no cover - CLI convenience
    import argparse
    import json

    parser = argparse.ArgumentParser(description="recall@10 per embedding provider")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    print(json.dumps(evaluate_embedders(args.steps, args.seed, args.device), indent=1))


if __name__ == "__main__":
    main()
