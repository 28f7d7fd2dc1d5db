"""Counterparts of the repository's ``tools/``: the probes that reach a TPU
kernel, and host-only tools.

Each module mirrors its tool by name, holds the probe's CUDA kernel wrapper
beside its plain PyTorch version, and runs the tool's own sweep from
``main`` (``python -m omni_recall_tpu_torch.tools.<name>``):

- ``profile_kernel`` (T1): K6's body split into cosine, cosine + keyword and
  the full top-9 extraction.
- ``probe_pipe`` (T2): K1's coarse scan, software-pipelined.
- ``probe_keys_emit`` (T4): K1's scan with three emit layouts of its
  packed-key extraction.
- ``profile_bloomT`` (T5): K4's int8 body over row-major and transposed
  bloom.
- ``probe_serve`` (T3): K3's body over pre-gathered candidate slabs, and the
  tool's split of a serving batch into its device stages.

Host-only tools (no kernel of their own), each beside the module it drives:

- ``probe_rebuild``: the stages of a shadow rebuild of the device index.
- ``sweep_10m``: K1 over the compact 10M store at several batches and
  layouts.
- ``bench_ingest``: the index append pipeline in chunks/s.

The tools of row sharding (parallel/):

- ``sharded_check``: the sharded scorer's scans and refine_select_dd
  against the single-device ops, on a mesh of one or more shards.
- ``probe_sharded_timing``: a sharded coarse scan per call on the host
  clock, as device time, and beside the unsharded K1.

The stand-alone stage probes of the serving device stage (no kernel of
their own; each ``main`` times its stages with CUDA events beside the host
clock and a bound, ``stages.py``, and holds them to the whole path they
split):

- ``profile_int8``: K4 by (B, bloom bits, t, sub).
- ``sweep_coarse``: K1 at t = 1 (K7a) and its merge by (B, block, sub).
- ``probe_scan_decomp``: the coarse scan's wrapper, stage by stage.
- ``profile_refine``: the coarse scan, K3, the gather and the selection.
- ``probe_direct_serve``: the refine and the direct selection with K2.
- ``probe_gather_sorted``: the candidates' row gather, random or sorted.

``quality_real_corpus`` runs the real-corpus recall@10 campaign
(eval/real_corpus.py).

The local models' tools (the fine-tuned encoder and the chat decoder):

- ``localq``: the bench's localq corpus, its fine-tuned encoder and engine
  (``build_localq_engine``); ``probe_localq``: where its batches go.
- ``train_embedder_demo``, ``train_chat_demo``: train the encoder and the
  decoder and show the gain; ``bench_decode``: prefill and decode rates.
"""

from __future__ import annotations

import torch

from omni_recall_tpu_torch.utils.profiling import median_ms  # noqa: F401


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bits (f32 compared through its int32 bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
