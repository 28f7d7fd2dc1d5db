"""Inverse-cloze self-supervised fine-tuning of the local encoder (PyTorch
port of omni_recall_tpu/models/finetune.py).

The objective: a random 3-8 word span of a chunk (plus filler-word
augmentation) must retrieve its own chunk against in-batch negatives,
entirely self-supervised. It is the engine behind ``POST
/api/documents/train`` (ingest/service.py ``train_embedder``): the provider
is trained on the ingested corpus, then every chunk is re-embedded through
the normal reindex path.

The pairs and the rows are drawn as the JAX package draws them
(``random.Random(seed)`` for spans and fillers, ``np.random.default_rng(seed)``
for rows), so both packages train on the same batches. Each batch's token
ids are cut to a power-of-two width (``encoder.bucket_ids``): padding is
masked, so the loss is the max_len-padded one.
"""

from __future__ import annotations

import random
import string

import numpy as np


def pair_maker(seed: int):
    """``make_pair(content) -> (query, content)`` over ``random.Random(seed)``."""
    rng = random.Random(seed)

    def rand_word() -> str:
        return "".join(rng.choices(string.ascii_lowercase, k=rng.randint(3, 9)))

    def make_pair(content: str) -> tuple[str, str]:
        words = content.split()
        span = rng.randint(3, 8)
        if len(words) > span:
            s0 = rng.randint(0, len(words) - span)
            q_words = words[s0: s0 + span]
        else:
            q_words = list(words)
        for _ in range(rng.randint(0, 2)):
            q_words.insert(rng.randint(0, len(q_words)), rand_word())
        return " ".join(q_words), content

    return make_pair


def train_pairs(params, pairs, cfg, steps: int, lr: float = 3e-4, device="cuda",
                on_step=None):
    """AdamW(lr) on the encoder from ``params`` (a state dict) over
    ``pairs(step) -> (queries, contents)``; ``on_step(step, loss)`` sees
    each loss (a 0-d tensor on the device). Returns the trained state dict
    (f32, on the device)."""
    import torch

    from omni_recall_tpu_torch.models import encoder

    master = encoder.trainable(params, device)
    optimizer, train_step = encoder.make_train_step(cfg, encoder.AdamW(lr))
    opt_state = optimizer.init(master)
    dev = next(iter(master.values())).device
    for step in range(steps):
        queries, contents = pairs(step)
        q_ids = torch.from_numpy(encoder.bucket_ids(encoder.tokenize_batch(queries, cfg)))
        c_ids = torch.from_numpy(encoder.bucket_ids(encoder.tokenize_batch(contents, cfg)))
        master, opt_state, loss = train_step(master, opt_state, q_ids.to(dev), c_ids.to(dev))
        if on_step is not None:
            on_step(step, loss)
    return {k: v.detach() for k, v in master.items()}


def inverse_cloze_finetune(contents: list[str], cfg, steps: int = 300, seed: int = 0,
                           batch: int = 64, params=None, device="cuda", on_step=None):
    """Fine-tune (or train from the seed init when ``params`` is None) the
    models/encoder.py transformer on ``contents`` with the inverse-cloze
    contrastive objective, on ``device`` (CUDA unless "cpu" is asked).
    Returns the trained state dict."""
    from omni_recall_tpu_torch.models import encoder

    if not contents:
        raise ValueError("inverse_cloze_finetune requires a non-empty corpus")
    make_pair = pair_maker(seed)
    if params is None:
        params = encoder.init_params(seed, cfg)
    nrng = np.random.default_rng(seed)
    batch = min(batch, max(2, len(contents)))

    def pairs(_step):
        idx = nrng.integers(0, len(contents), size=batch)
        drawn = [make_pair(contents[i]) for i in idx]
        return [p[0] for p in drawn], [p[1] for p in drawn]

    return train_pairs(params, pairs, cfg, steps, lr=3e-4, device=device, on_step=on_step)
