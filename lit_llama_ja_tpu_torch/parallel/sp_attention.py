"""Sequence-parallel (context-parallel) prefill attention (counterpart of
`lit_llama_ja_tpu/parallel/sp_attention.py`).

Each rank holds a ``T/n`` slice of q, k and v along the sequence, all-gathers k and v
over the axis, and computes its q rows' causal attention with a global row offset.
Scores exist only for the local q rows (``O(T²/n)``); k/v memory is ``O(T)``. The ring
variant (``impl="ring"`` -> `ring_attention.ring_attention`) never holds the full k/v.
Plain PyTorch, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch

from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, gather


def _offset_causal_sdpa(q, k, v, row_offset: int):
    """Causal attention where q rows sit at global positions ``row_offset..+Tq``."""
    Tq, hd = q.shape[2], q.shape[3]
    S = k.shape[2]
    att = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / hd**0.5)
    row = torch.arange(Tq, device=q.device)[:, None] + row_offset
    col = torch.arange(S, device=q.device)[None, :]
    att = torch.where(col <= row, att.float(), float("-inf"))
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "tp",
    impl: str = "allgather",
) -> torch.Tensor:
    """Causal attention over a sequence split along ``axis``.

    Args:
      q, k, v: this rank's ``(B, n_head, T/n, head_dim)`` slices, rank ``i`` holding
        positions ``[i·T/n, (i+1)·T/n)``.
      impl: ``"allgather"`` (k/v gathered, O(T) k/v memory; differentiable, the
        gather's backward reduce-scatters) or ``"ring"`` (k/v blocks passed around
        the ring, O(T/n)).
    Returns this rank's slice of the output.
    """
    if impl == "ring":
        from lit_llama_ja_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, mesh, axis=axis)
    if impl != "allgather":
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    k_full = gather(k, mesh, axis, 2)
    v_full = gather(v, mesh, axis, 2)
    return _offset_causal_sdpa(q, k_full, v_full, mesh.index(axis) * q.shape[2])
