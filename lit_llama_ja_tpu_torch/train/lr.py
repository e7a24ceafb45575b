"""Learning-rate schedules (counterpart of `lit_llama_ja_tpu/train/lr.py`)."""
from __future__ import annotations

import math


def cosine_with_warmup(
    learning_rate: float,
    warmup_iters: int,
    lr_decay_iters: int,
    min_lr: float,
):
    """Linear warmup then cosine decay to ``min_lr``; ``min_lr`` after decay ends.

    Returns ``schedule(it) -> float``, a plain function of the iteration (the
    optimizer's update count, from 0).
    """

    def schedule(it) -> float:
        it = float(it)
        if it < warmup_iters:
            return learning_rate * it / max(warmup_iters, 1)
        if it > lr_decay_iters:
            return min_lr
        decay_ratio = (it - warmup_iters) / max(lr_decay_iters - warmup_iters, 1)
        decay_ratio = min(max(decay_ratio, 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * decay_ratio))
        return min_lr + coeff * (learning_rate - min_lr)

    return schedule
