"""Sequence-parallel full-sequence forward: long-context prefill or evaluation with
the activations and attention split over the sequence axis of a mesh (counterpart of
`lit_llama_ja_tpu/parallel/sp_forward.py`).

Differentiable, as JAX's: the attention's collectives have backward forms
(``allgather``: the gather's reduce-scatter; ``ring``: `mesh.RingHop`), and the logits
are gathered with `mesh.gather_replicated`, whose backward keeps the rank's own
positions. Under ``torch.no_grad()`` every collective is the plain one.

Token embeddings, blocks and logits compute on this rank's ``T/n`` positions; only the
attention crosses ranks (`sp_attention.sequence_parallel_attention`). T may exceed
``block_size``: the RoPE table is built out to T.
"""
from __future__ import annotations

import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.models.llama import apply_linear, index_layer, mlp_block
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.ops.rope import apply_rope, build_rope_cache
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, gather_replicated
from lit_llama_ja_tpu_torch.parallel.sp_attention import sequence_parallel_attention


def forward_sp(
    params,
    idx: torch.Tensor,  # (B, T), the same on every rank; T divisible by the axis size
    config: LLaMAConfig,
    mesh: Mesh,
    axis: str = "tp",
    attn_impl: str = "allgather",
    device="cuda",
) -> torch.Tensor:
    """Full-sequence forward with sequence-parallel attention: `models/llama.forward`'s
    math on the same (whole, replicated) ``params``, with T free of ``block_size``.
    ``attn_impl="ring"`` streams k/v blocks around the ring instead of all-gathering
    them. Returns the logits ``(B, T, V)`` on every rank (the slices all-gathered).

    Gradients: a loss that every rank computes alike from the whole logits gives each
    rank the gradients of its own positions' share, so each parameter's gradient on a
    rank is that rank's partial sum; the caller all-reduces the parameter gradients
    over ``axis`` (a sum) to get the gradient of the loss."""
    dev = resolve_device(device)
    idx = torch.as_tensor(idx, device=dev)
    B, T = idx.shape
    n, r = mesh.size(axis), mesh.index(axis)
    if T % n:
        raise ValueError(f"T={T} must divide over the '{axis}' axis ({n})")
    Tl = T // n
    rope = build_rope_cache(max(T, config.block_size), config.head_dim, config.rope_base,
                            device=dev)[r * Tl:(r + 1) * Tl]
    x = params["wte"]["weight"][idx[:, r * Tl:(r + 1) * Tl]]
    nh, hd = config.n_head, config.head_dim
    for l in range(config.n_layer):
        bp = index_layer(params["blocks"], l)
        h = rmsnorm(x, bp["rms_1"]["scale"], config.norm_eps)
        q, k, v = apply_linear(bp["attn"]["c_attn"], h).chunk(3, dim=-1)
        q = apply_rope(q.reshape(B, Tl, nh, hd), rope).transpose(1, 2)
        k = apply_rope(k.reshape(B, Tl, nh, hd), rope).transpose(1, 2)
        v = v.reshape(B, Tl, nh, hd).transpose(1, 2)
        y = sequence_parallel_attention(q, k, v, mesh, axis=axis, impl=attn_impl)
        x = x + apply_linear(bp["attn"]["c_proj"], y.transpose(1, 2).reshape(B, Tl, -1))
        x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["rms_2"]["scale"], config.norm_eps))
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return gather_replicated(apply_linear(params["lm_head"], x), mesh, axis, dim=1)
