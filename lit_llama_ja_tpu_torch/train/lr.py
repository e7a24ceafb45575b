"""Learning-rate schedules (counterpart of `lit_llama_ja_tpu/train/lr.py`)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(
    learning_rate: float,
    warmup_iters: int,
    lr_decay_iters: int,
    min_lr: float,
):
    """Linear warmup then cosine decay to ``min_lr``; ``min_lr`` after decay ends.

    Returns ``schedule(it)``, a function of the iteration (the optimizer's update
    count, from 0). A Python number gives a float (the loop's printed ``lr``); a
    tensor (`train/step.AdamW`'s count on the device) gives an f32 tensor on its
    device, computed by tensor ops alone, as the JAX package computes it in f32, so
    that a captured step reads nothing back to the host.
    """

    def schedule(it):
        if isinstance(it, torch.Tensor):
            return _on_device(it)
        it = float(it)
        if it < warmup_iters:
            return learning_rate * it / max(warmup_iters, 1)
        if it > lr_decay_iters:
            return min_lr
        decay_ratio = (it - warmup_iters) / max(lr_decay_iters - warmup_iters, 1)
        decay_ratio = min(max(decay_ratio, 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * decay_ratio))
        return min_lr + coeff * (learning_rate - min_lr)

    def _on_device(it: torch.Tensor) -> torch.Tensor:
        it = it.to(torch.float32)
        warm = learning_rate * it / max(warmup_iters, 1)
        decay_ratio = ((it - warmup_iters) / max(lr_decay_iters - warmup_iters, 1)).clamp(0, 1)
        coeff = 0.5 * (1.0 + torch.cos(math.pi * decay_ratio))
        cos = min_lr + coeff * (learning_rate - min_lr)
        floor = torch.full_like(it, min_lr)
        return torch.where(it < warmup_iters, warm, torch.where(it > lr_decay_iters, floor, cos))

    return schedule
