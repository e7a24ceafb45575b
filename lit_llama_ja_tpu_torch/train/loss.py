"""Cross-entropy loss with ``ignore_index`` (counterpart of
`lit_llama_ja_tpu/train/loss.py`): the logsumexp runs in f32 whatever the logits'
dtype, and masked positions count neither in the sum nor in the token count."""
from __future__ import annotations

import torch


def token_nll_sum(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -1):
    """(sum NLL, token count) over positions where ``targets != ignore_index`` — the
    perplexity protocol's accumulator.

    Args:
      logits: ``(..., V)`` float; targets: ``(...)`` int.
    """
    logits = logits.float()
    mask = targets != ignore_index
    safe_targets = torch.where(mask, targets, torch.zeros_like(targets))
    logz = torch.logsumexp(logits, dim=-1)
    tok_logit = torch.gather(logits, -1, safe_targets[..., None].long()).squeeze(-1)
    nll = (logz - tok_logit) * mask
    return nll.sum(), mask.sum()


def cross_entropy_loss(
    logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -1
) -> torch.Tensor:
    """Mean token NLL over positions where ``targets != ignore_index``."""
    nll, count = token_nll_sum(logits, targets, ignore_index)
    return nll / torch.clamp(count, min=1)
