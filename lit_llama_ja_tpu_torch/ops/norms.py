"""RMSNorm (counterpart of `lit_llama_ja_tpu/ops/norms.py`)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean-of-squares RMSNorm: ``scale * x / sqrt(mean(x^2) + eps)``.

    Statistics are computed in float32 regardless of input dtype.
    """
    x32 = x.float()
    norm_x = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x_normed = x32 * torch.rsqrt(norm_x + eps)
    return (scale.float() * x_normed).to(x.dtype)
