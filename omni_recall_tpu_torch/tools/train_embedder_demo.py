"""Local embedder fine-tuning demo: train the transformer encoder
contrastively on synthetic (query, chunk) pairs and show retrieval accuracy
improving (counterpart of the repository's ``tools/train_embedder_demo.py``).

``python -m omni_recall_tpu_torch.tools.train_embedder_demo [--steps N]
[--save PATH] [--device cpu]``; a saved checkpoint serves with
``OMNI__Embeddings__Provider=Local OMNI__Embeddings__Checkpoint=PATH``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.models import encoder

CFG = encoder.EncoderConfig(vocab_size=8192, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                            max_len=24, out_dim=128)


def make_dataset(rng, n_topics: int = 64, per_topic: int = 4):
    """Paraphrase-style pairs: queries and chunks share topic tokens."""
    topics = [[f"t{t}w{j}" for j in range(6)] for t in range(n_topics)]
    queries, chunks, labels = [], [], []
    for t, words in enumerate(topics):
        for i in range(per_topic):
            queries.append(" ".join(rng.permutation(words)[:3].tolist() + [f"q{i}"]))
            chunks.append(" ".join(rng.permutation(words)[:5].tolist()
                                   + [f"detail{i}", "filler"]))
            labels.append(t)
    return queries, chunks, np.asarray(labels)


def retrieval_accuracy(params, cfg, queries, chunks, labels, device) -> float:
    model = encoder.Encoder.from_state(params, cfg, device)
    q = model(torch.from_numpy(encoder.tokenize_batch(queries, cfg)))
    c = model(torch.from_numpy(encoder.tokenize_batch(chunks, cfg)))
    top1 = (q @ c.T).argmax(dim=1).cpu().numpy()
    return float((labels[top1] == labels).mean())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--save", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    queries, chunks, labels = make_dataset(rng)
    params = encoder.init_params(0, CFG)
    acc0 = retrieval_accuracy(params, CFG, queries, chunks, labels, device)
    master = encoder.trainable(params, device)
    optimizer, train_step = encoder.make_train_step(CFG, encoder.AdamW(3e-4))
    state = optimizer.init(master)
    order = np.arange(len(queries))
    losses = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        rng.shuffle(order)
        idx = order[:64]
        q_ids = torch.from_numpy(encoder.tokenize_batch([queries[i] for i in idx], CFG))
        c_ids = torch.from_numpy(encoder.tokenize_batch([chunks[i] for i in idx], CFG))
        master, state, loss = train_step(master, state, q_ids.to(device), c_ids.to(device))
        losses.append(loss)
    train_s = time.perf_counter() - t0
    trained = {k: v.detach() for k, v in master.items()}
    acc1 = retrieval_accuracy(trained, CFG, queries, chunks, labels, device)
    out = {"accuracy_before": acc0, "accuracy_after": acc1, "steps": args.steps,
           "train_s": train_s, "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    if args.save:
        encoder.save_params(args.save, trained, CFG)
        out["saved"] = args.save
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
