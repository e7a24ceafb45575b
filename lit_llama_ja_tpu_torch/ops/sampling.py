"""Token sampling (counterpart of `lit_llama_ja_tpu/ops/sampling.py`).

Temperature, top-k, top-p, then a categorical draw from a ``torch.Generator``. The
draws differ from JAX's PRNG, so only greedy decoding matches the JAX package token
for token.
"""
from __future__ import annotations

from typing import Optional

import torch


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest set whose probability mass ≥ ``top_p``.

    The top-1 token is always kept (its preceding mass is 0 < top_p). Ties at
    the nucleus boundary are all kept. Applies along the last axis.
    """
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    inf = torch.full_like(sorted_logits, float("inf"))
    kept = torch.where(mass_before < top_p, sorted_logits, inf)
    thresh = torch.min(kept, dim=-1, keepdim=True).values  # smallest kept logit
    return torch.where(logits < thresh, float("-inf"), logits)


def sample_token(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample one token id from ``logits`` of shape ``(V,)``; returns an int64 scalar
    tensor on the logits' device.

    temperature == 0.0 is greedy argmax. Filter order: temperature scale, then
    top-k, then top-p (nucleus mass measured after top-k).
    """
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k is not None:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return categorical(probs, generator)


def categorical(probs: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """One draw a row from ``probs`` (``(..., V)``, nonnegative): ``argmax(probs / q)``
    with ``q ~ Exp(1)``, the draw ``torch.multinomial(probs, 1)`` makes, bit for bit and
    from the same generator state, without its check of ``probs`` on the host, so a
    CUDA graph can capture it."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)
