"""Compact candidate selection straight from the scan (port of
omni_recall_tpu/ops/refine.py ``direct_select_from_scan``).

The residual-int8 refine stage of the JAX module (the K3 TPU kernel) needs
the residual planes, which this port's index does not hold yet; direct
selection is the only compact path here, exactly as for the JAX package's
``DeviceIndex(refine=False)`` indexes.
"""

from __future__ import annotations

import torch


def direct_select_from_scan(vals_full: torch.Tensor, idxs_full: torch.Tensor, t_out: int):
    """Top-t_out slice of the scan/merge output (sorted descending by scan
    bound) plus one certificate bound

        bound = max(scan boundary,            # rows the scan excluded
                    (t_out+1)-th scan bound)  # candidates the slice dropped

    so every row not in the slice has a sound upper bound <= ``bound``; the
    engine's certificate check is unchanged. Returns (rows [B, k],
    ubs [B, k], bound [B]), k = min(t_out, m)."""
    b, m1 = vals_full.shape
    m = m1 - 1
    k = min(t_out, m)
    rows = idxs_full[:, :k]
    ubs = vals_full[:, :k]
    if m > k:
        tail = vals_full[:, k]
    else:
        tail = torch.full((b,), float("-inf"), dtype=vals_full.dtype, device=vals_full.device)
    bound = torch.maximum(vals_full[:, -1], tail)
    return rows, ubs, bound
