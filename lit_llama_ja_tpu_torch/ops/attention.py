"""Scaled dot-product attention (counterpart of `lit_llama_ja_tpu/ops/attention.py`).

Entry points:
  * `causal_attention` — full-sequence causal attention (prefill and training). On
    CUDA tensors it always runs the hand-written flash-attention kernels
    (`ops/cuda/flash_attention`), at any T and any head dim up to 128: K2 forward and,
    under autograd, K6 backward. On CPU tensors it runs the plain softmax chain,
    which autograd differentiates, as the JAX package does off the TPU.
  * `decode_attention` and its int8 / int4 cache variants — queries against a
    fixed-size KV cache with a validity mask from positions. These are plain
    PyTorch on every device, as they are plain XLA in the JAX package.

The int8 and int4 KV-cache quantizers produce the same bytes as the JAX package.
"""
from __future__ import annotations

import torch

from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import flash_attention


def _sdpa(q, k, v, mask, scale):
    # q: (B, nh, Tq, hd), k/v: (B, nh, Tk, hd), mask: broadcastable to (B, nh, Tq, Tk)
    att = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    att = torch.where(mask, att.float(), float("-inf"))
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over a full sequence.

    Args:
      q, k, v: ``(B, n_head, T, head_dim)``.
    Returns:
      ``(B, n_head, T, head_dim)``.
    """
    if q.is_cuda:
        return flash_attention(q, k, v)
    T = q.shape[2]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))[None, None]
    return _sdpa(q, k, v, mask, scale)


def masked_softmax(att: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis that is NaN-proof in both directions (the JAX
    package's `infer/paged._masked_softmax`): an all-masked row gives zero weights, not
    NaN, and a masked entry weighs an exact 0, so junk in a shared page (the paged
    pool's trash page, written by idle slots) never reaches another row through
    ``0 * NaN``."""
    att = torch.where(mask, att, float("-inf"))
    m = torch.amax(att, dim=-1, keepdim=True)
    e = torch.exp(att - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    e = torch.where(mask, e, torch.zeros_like(e))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _slot_mask(S: int, input_pos: torch.Tensor) -> torch.Tensor:
    """(1, 1, T, S) mask: slot ``j`` is visible to query ``i`` iff ``j <= input_pos[i]``."""
    slot = torch.arange(S, dtype=input_pos.dtype, device=input_pos.device)
    return (slot[None, :] <= input_pos[:, None])[None, None]


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    input_pos: torch.Tensor,
) -> torch.Tensor:
    """Attention of T query tokens at positions ``input_pos`` against a full KV cache.

    Args:
      q: ``(B, n_head, T, head_dim)`` — the new tokens' queries.
      k, v: ``(B, n_head, S, head_dim)`` — the updated cache.
      input_pos: ``(T,)`` absolute positions of the query tokens.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return _sdpa(q, k, v, _slot_mask(k.shape[2], input_pos), scale)


def decode_attention_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,  # (B, nh, S, hd) int8
    k_scale: torch.Tensor,  # (B, nh, S, 1) f32
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    input_pos: torch.Tensor,
) -> torch.Tensor:
    """Decode attention against an INT8 KV cache (per-slot absmax scales).

    The k scale factors onto the scores and the v scale folds into the attention
    weights, so no dequantized cache is materialized.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = _slot_mask(k_q.shape[2], input_pos)
    att = torch.einsum("bhqd,bhkd->bhqk", q, k_q.to(q.dtype)) * k_scale[..., 0][
        :, :, None, :
    ].float()
    att = torch.where(mask, att * scale, float("-inf"))
    att = torch.softmax(att, dim=-1)
    att = att * v_scale[..., 0][:, :, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", att.to(q.dtype), v_q.to(q.dtype))


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per-slot (token, head) absmax INT8 quantization of new k/v entries.

    k, v: (B, nh, T, hd) -> (int8 values, f32 scales (B, nh, T, 1)).
    """

    def one(x):
        x32 = x.float()
        absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
        scale = torch.where(absmax == 0, 1.0, absmax / 127.0)
        q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
        return q, scale

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, ks, vq, vs


def prefix_attention(q: torch.Tensor, ak: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """Unmasked cross-attention against an adapter prefix: every query sees every
    prefix slot.

    Args:
      q: ``(B, n_head, T, head_dim)``; ak/av: ``(B, n_head, aT, head_dim)``.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = torch.ones((1, 1, 1, ak.shape[2]), dtype=torch.bool, device=q.device)
    return _sdpa(q, ak, av, mask, scale)


def quantize_kv4(k: torch.Tensor, v: torch.Tensor, head_axis: int = -2):
    """Per-(token, head) absmax INT4 quantization, packed 2 values/byte across
    adjacent head pairs (head 2j in the low nibble, 2j+1 in the high), keeping the
    full head_dim as the trailing axis — the JAX package's cache layout, byte for
    byte.

    k, v: (..., nh at ``head_axis``, ..., hd) with nh even ->
    (uint8 with nh/2 at ``head_axis``, f32 scales (..., 1) in the original
    per-head layout).
    """

    def one(x):
        x32 = x.float()
        absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
        scale = torch.where(absmax == 0, 1.0, absmax / 7.0)
        q = torch.clamp(torch.round(x32 / scale), -8, 7) + 8
        q = torch.movedim(q.to(torch.uint8), head_axis, -2)
        if q.shape[-2] % 2:
            raise ValueError("int4 KV needs an even head count")
        packed = q[..., 0::2, :] | (q[..., 1::2, :] << 4)
        return torch.movedim(packed, -2, head_axis), scale

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, ks, vq, vs


def _unpack4(packed: torch.Tensor):
    """(..., hd) uint8 head-pair planes -> centered int8 nibbles
    (lo = even heads, hi = odd heads)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return lo, hi


def _interleave_heads(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(B, nh/2, ...) even/odd head results -> (B, nh, ...) in head order."""
    B, nh2 = even.shape[:2]
    return torch.stack([even, odd], dim=2).reshape(B, 2 * nh2, *even.shape[2:])


def int4_scores(q: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """q (B, nh, T, hd) · head-pair-packed keys (B, nh/2, S, hd) → scores
    (B, nh, T, S). Even heads read the low nibbles, odd the high."""
    lo, hi = _unpack4(packed)
    ae = torch.einsum("bhqd,bhsd->bhqs", q[:, 0::2], lo.to(q.dtype))
    ao = torch.einsum("bhqd,bhsd->bhqs", q[:, 1::2], hi.to(q.dtype))
    return _interleave_heads(ae, ao)


def int4_values(att: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """att (B, nh, T, S) · head-pair-packed values (B, nh/2, S, hd) → y (B, nh, T, hd)."""
    vlo, vhi = _unpack4(packed)
    ye = torch.einsum("bhqs,bhsd->bhqd", att[:, 0::2], vlo.to(att.dtype))
    yo = torch.einsum("bhqs,bhsd->bhqd", att[:, 1::2], vhi.to(att.dtype))
    return _interleave_heads(ye, yo)


def decode_attention_quant4(
    q: torch.Tensor,  # (B, nh, T, hd)
    k_q: torch.Tensor,  # (B, nh/2, S, hd) uint8 head-pair packed
    k_scale: torch.Tensor,  # (B, nh, S, 1) f32
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    input_pos: torch.Tensor,
) -> torch.Tensor:
    """Decode attention against an INT4 head-pair-packed KV cache. The contraction
    splits over even/odd heads and the scales fold as in `decode_attention_quant`."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = _slot_mask(k_q.shape[2], input_pos)
    att = int4_scores(q, k_q)
    att = att * k_scale[..., 0][:, :, None, :].float()
    att = torch.where(mask, att * scale, float("-inf"))
    att = torch.softmax(att, dim=-1)
    att = (att * v_scale[..., 0][:, :, None, :]).to(q.dtype)
    return int4_values(att, v_q)
