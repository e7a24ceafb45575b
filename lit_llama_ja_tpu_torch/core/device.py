"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default. Without a card that default
raises: the port never drops to the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
