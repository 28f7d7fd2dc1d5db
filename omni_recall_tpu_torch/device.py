"""Device selection for the port's entry points.

Entry points (``DeviceIndex``, ``RecallEngine``, the server) run on CUDA
unless the caller asks for the CPU. There is no silent CPU fallback: asking
for CUDA on a machine without a usable card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (server: --device cpu) to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def is_device_error(exc: BaseException) -> bool:
    """True for a failure of the card or its runtime: out of memory, a
    failed launch, an illegal address. Such errors pass through every
    fallback of the port, which exist for bad inputs (a malformed snapshot,
    a parameter mismatch), not for a bad device."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)
