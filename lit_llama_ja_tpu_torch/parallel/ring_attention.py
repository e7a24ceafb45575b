"""Ring attention: sequence-parallel causal attention with O(T/n) k/v memory a rank
(counterpart of `lit_llama_ja_tpu/parallel/ring_attention.py`).

The k/v blocks travel the ring one hop a step (`mesh.ring_shift`, one
``batch_isend_irecv``) while each rank folds the visiting block into an
online-softmax accumulator (the flash-attention recurrence, f32 statistics).

Causal masking: q rows on rank i sit at global positions ``i·Tb .. (i+1)·Tb``; the
block visiting at step s came from rank ``(i − s) mod n``, at column offset
``((i − s) mod n)·Tb``. Blocks wholly above the diagonal are computed and masked, as
in the JAX package; the guards of `_fold_block` keep such steps exact (zero weight,
no NaN).

Differentiable: the hops go through `mesh.ring_hop`, whose backward shifts the
gradients of a block one hop back (``ppermute``'s transpose, as ``jax.grad`` runs the
JAX loop), and autograd runs the folds' backward in plain PyTorch. A rank's dk and dv
are then the gradients of its own k and v slices, summed over every rank's q rows.
"""
from __future__ import annotations

import torch

from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, ring_hop


def _fold_block(m, l, acc, q, k_blk, v_blk, col_offset: int, row_offset: int):
    """One online-softmax step: fold ``(k_blk, v_blk)`` at global column offset
    ``col_offset`` into the running ``(m, l, acc)`` of q rows at ``row_offset``. All
    statistics f32; m starts at -inf, and a fully masked block adds nothing."""
    Tq, hd = q.shape[2], q.shape[3]
    S = k_blk.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk).float() * (1.0 / hd**0.5)
    row = torch.arange(Tq, device=q.device)[:, None] + row_offset
    col = torch.arange(S, device=q.device)[None, :] + col_offset
    s = torch.where(col <= row, s, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # m_new == -inf: no valid column yet for that row; subtract 0 so exp(-inf) = 0
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - m_safe)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v_blk).float()
    return m_new, l_new, acc * corr + pv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = "tp") -> torch.Tensor:
    """Causal attention over a sequence split along ``axis``, k/v streamed around the
    ring: `sp_attention.sequence_parallel_attention`'s contract (this rank's
    ``(B, n_head, T/n, head_dim)`` slices in and out), O(T/n) memory."""
    n, i = mesh.size(axis), mesh.index(axis)
    B, nh, Tb, hd = q.shape
    m = torch.full((B, nh, Tb, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nh, Tb, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nh, Tb, hd), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for s in range(n):
        src = (i - s) % n  # the rank the visiting block came from
        m, l, acc = _fold_block(m, l, acc, q, k_blk, v_blk, src * Tb, i * Tb)
        if s < n - 1:
            k_blk, v_blk = ring_hop([k_blk, v_blk], mesh, axis, step=1)
    return (acc / l).to(q.dtype)
