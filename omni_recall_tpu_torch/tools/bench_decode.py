"""Serving benchmark of the local chat decoder: prefill tokens/s and
KV-cache decode ms a step (counterpart of the repository's
``tools/bench_decode.py``; seed-init weights, whose speed does not depend
on training).

``python -m omni_recall_tpu_torch.tools.bench_decode [--d 1024] [--layers 12]
[--heads 16] [--ff 4096] [--batch 32] [--prompt 448] [--steps 128]
[--max-len N] [--device cpu]`` prints one JSON line: prefill ms and tokens/s,
generate ms and new tokens/s, the decode ms a step (generate less prefill),
and, when max_len leaves room, the same with the whole cache read each step
(``full_window``). Times are CUDA events on the card, the host clock on the
CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.models import decoder
from omni_recall_tpu_torch.tools import median_ms


def run(cfg: decoder.DecoderConfig, batch: int, prompt_len: int, steps: int,
        device, runs: int = 3) -> dict:
    """Prefill and generate timings of ``cfg`` at (batch, prompt_len, steps)."""
    w = decoder.serving_weights(decoder.init_params(0, cfg), cfg, device)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        decoder._BYTE0, decoder._BYTE0 + 256, size=(batch, prompt_len), dtype=np.int64)
    ).to(device)
    prefill_ms = median_ms(lambda: decoder.prefill(w, ids, cfg), device, runs=runs)
    gen_ms = median_ms(lambda: decoder.generate(w, ids, cfg, steps), device, runs=runs)
    out = {"params_m": sum(v.numel() for v in w.p.values()) / 1e6, "batch": batch,
           "prompt": prompt_len, "steps": steps, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": batch * prompt_len / prefill_ms * 1e3,
           "generate_ms": gen_ms, "new_tokens_per_s": batch * steps / gen_ms * 1e3,
           "decode_ms_per_step": (gen_ms - prefill_ms) / steps,
           "attend": decoder.attend_window(cfg, prompt_len, steps)}
    if cfg.max_len > out["attend"]:
        full_ms = median_ms(lambda: decoder.generate(w, ids, cfg, steps, full_window=True),
                            device, runs=runs)
        out.update(full_window_generate_ms=full_ms,
                   full_window_decode_ms_per_step=(full_ms - prefill_ms) / steps)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--d", type=int, default=1024)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--heads", type=int, default=16)
    parser.add_argument("--ff", type=int, default=4096)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--prompt", type=int, default=448)
    parser.add_argument("--steps", type=int, default=128)
    parser.add_argument("--max-len", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = decoder.DecoderConfig(d_model=args.d, n_layers=args.layers, n_heads=args.heads,
                                d_ff=args.ff,
                                max_len=max(args.max_len, args.prompt + args.steps))
    out = {"config": dict(cfg.__dict__),
           **run(cfg, args.batch, args.prompt, args.steps, device)}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
