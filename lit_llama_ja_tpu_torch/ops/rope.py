"""Rotary position embeddings (counterpart of `lit_llama_ja_tpu/ops/rope.py`).

The table is ``(seq_len, head_dim // 2, 2)`` holding ``(cos, sin)`` pairs, applied by
real-pair rotation in float32.
"""
from __future__ import annotations

import torch


def build_rope_cache(
    seq_len: int,
    n_elem: int,
    base: int = 10000,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Precompute the (cos, sin) table of shape ``(seq_len, n_elem // 2, 2)``."""
    exponent = torch.arange(0, n_elem, 2, dtype=torch.float32, device=device) / n_elem
    theta = 1.0 / (base ** exponent)
    seq_idx = torch.arange(seq_len, dtype=torch.float32, device=device)
    idx_theta = torch.outer(seq_idx, theta)  # (seq_len, n_elem // 2)
    cache = torch.stack([torch.cos(idx_theta), torch.sin(idx_theta)], dim=-1)
    return cache.to(dtype)


def apply_rope(x: torch.Tensor, rope_cache: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` of shape ``(B, T, n_head, head_dim)`` by the (cos, sin) table.

    ``rope_cache`` has shape ``(T, head_dim // 2, 2)``, already gathered for the
    positions of the T tokens present in ``x``, or ``(B, T, head_dim // 2, 2)`` when
    each sequence of the batch sits at its own positions (the serving engines).
    """
    B, T, nh, hd = x.shape
    xs = x.float().reshape(B, T, nh, hd // 2, 2)
    rc = rope_cache.float().reshape(-1, T, 1, hd // 2, 2)
    cos, sin = rc[..., 0], rc[..., 1]
    x0, x1 = xs[..., 0], xs[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(B, T, nh, hd).to(x.dtype)
