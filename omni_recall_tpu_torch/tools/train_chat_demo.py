"""Local chat decoder training demo: train the causal transformer on
grounded-QA rows laid out as the serving path lays them out (the
orchestration layer's grounded prompt, tail-truncated and left-padded as
chat/local.py does), then answer through the real LocalDecoderChatClient
(counterpart of the repository's ``tools/train_chat_demo.py``).

``python -m omni_recall_tpu_torch.tools.train_chat_demo [--steps N]
[--save PATH] [--device cpu]``; a saved checkpoint serves with
``OMNI__Ai__Provider=Local OMNI__Ai__LocalCheckpoint=PATH``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from omni_recall_tpu_torch.chat.local import LocalDecoderChatClient
from omni_recall_tpu_torch.chat.orchestration import build_grounded_prompt
from omni_recall_tpu_torch.contracts import AiChatRequest, RecallCitation
from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.models import decoder, encoder

MAX_NEW = 48
CFG = decoder.DecoderConfig(d_model=128, n_layers=3, n_heads=4, d_ff=512, max_len=320)
PAIRS = [
    ("where does the index live?", "The index lives in device HBM as int8 slabs.",
     " In device HBM as int8 slabs. [1]"),
    ("what bounds the keyword term?", "The keyword term is bounded by the per-query bloom cap.",
     " The per-query bloom cap. [1]"),
    ("how is exactness kept?", "Exactness is kept by a runtime certificate check.",
     " A runtime certificate check. [1]"),
    ("what merges shard results?", "Shard results are merged by a stable co-sort on scores.",
     " A stable co-sort on scores. [1]"),
]


def grounded(question: str, snippet: str) -> str:
    citation = RecallCitation(document_id="doc_demo", file_name="notes.txt",
                              chunk_id="doc_demo:0000", chunk_index=0, snippet=snippet,
                              score=0.5, created_at_utc="2026-01-01T00:00:00Z")
    return build_grounded_prompt(question, [citation])


def make_batch(cfg: decoder.DecoderConfig, client: LocalDecoderChatClient):
    """Rows as serving sees them: the grounded prompt tail-truncated and
    left-padded to the client's bucket, the answer and EOS after it, PAD to
    max_len (PAD targets are masked in the loss)."""
    rows, bucket = [], None
    for question, snippet, answer in PAIRS:
        toks = decoder.encode_text(grounded(question, snippet),
                                   max_bytes=cfg.max_len - MAX_NEW - 1)
        b = client._bucket_for(len(toks))
        if bucket not in (None, b):
            raise ValueError("all demo prompts must share one bucket")
        bucket = b
        tail = [decoder._BYTE0 + c for c in answer.encode()] + [decoder.EOS]
        row = np.zeros(cfg.max_len, dtype=np.int32)
        row[:b] = decoder.pad_left_batch([toks], b)[0]
        row[b:b + len(tail)] = tail
        rows.append(row)
    return torch.from_numpy(np.stack(rows)), bucket


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--save", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    params = decoder.init_params(0, CFG)
    client = LocalDecoderChatClient(params=params, cfg=CFG, max_new_tokens=MAX_NEW,
                                    scheduler="coalesce", device=device)
    batch, bucket = make_batch(CFG, client)
    master = encoder.trainable(params, device)
    optimizer, train_step = decoder.make_train_step(CFG)
    state = optimizer.init(master)
    losses = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        master, state, loss = train_step(master, state, batch.to(device))
        losses.append(loss)
    train_s = time.perf_counter() - t0
    trained = {k: v.detach() for k, v in master.items()}
    client = LocalDecoderChatClient(params=trained, cfg=CFG, max_new_tokens=MAX_NEW,
                                    device=device)
    hits, answers = 0, []
    try:
        for question, snippet, answer in PAIRS:
            try:
                text = client.complete(AiChatRequest(grounded(question, snippet))).text
            except RuntimeError as exc:  # an empty answer
                text = f"<{exc}>"
            answers.append(text[:60])
            hits += text.strip().startswith(answer.strip()[:20])
    finally:
        client.shutdown()
    out = {"bucket": bucket, "steps": args.steps, "train_s": train_s,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "recovered": hits, "pairs": len(PAIRS), "answers": answers}
    if args.save:
        decoder.save_params(args.save, trained, CFG)
        out["saved"] = args.save
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
