"""Top-k with payload: one stable co-sort (port of omni_recall_tpu/ops/merge.py).

Tie semantics are the engine's deterministic contract: equal values keep
their original (ascending-position) order, so the lowest position wins.
``torch.topk`` promises no order among ties, hence the stable sort.
"""

from __future__ import annotations

import torch


def top_k_with_payload(vals: torch.Tensor, payload: torch.Tensor, k: int):
    """Descending top-k of ``vals`` along the last axis with the aligned
    ``payload`` co-sorted. Returns (top_vals, top_payload), each
    ``vals.shape[:-1] + (k,)``."""
    neg, order = torch.sort(-vals, dim=-1, stable=True)
    return -neg[..., :k], torch.gather(payload, -1, order[..., :k])
