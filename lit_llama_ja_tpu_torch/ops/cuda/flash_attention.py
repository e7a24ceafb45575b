"""Causal flash-attention forward: the wrapper of ``csrc/flash_attention_fwd.cu`` and
its plain PyTorch version.

Replaces the Pallas kernel `lit_llama_ja_tpu/ops/pallas/flash_attention.py:78
_flash_forward`. Returns ``(o, lse)``: ``o = softmax(q kᵀ / sqrt(hd), causal) v`` and
the per-row logsumexp of the scaled scores, which the backward kernel of the
training slice consumes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build

MAX_HEAD_DIM = 128


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version in f32: materializes the (T, T) scores."""
    T, hd = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    s = torch.where(causal, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over ``(B, n_head, T, head_dim)`` q, k, v -> ``(o, lse)`` with
    ``o`` like q (contiguous) and ``lse`` ``(B, n_head, T)`` f32.

    CPU tensors run `flash_attention_fwd_ref`. CUDA tensors launch the kernel, which
    takes bf16 inputs with an even head dim of at most 128, unit stride along the
    head dim and even strides elsewhere (views such as a transposed projection are
    fine); anything else raises.
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, nh, T, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v)
    B, nh, T, hd = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash-attention kernel takes bf16, got {name} {t.dtype}")
        if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(f"{name} needs unit stride along hd, even strides and "
                             f"4-byte alignment, got strides {t.stride()}")
    if hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim must be even and at most {MAX_HEAD_DIM}, got {hd}")
    o = torch.empty((B, nh, T, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return o, lse
    vec = hd % 8 == 0 and all(
        s % 8 == 0 for t in (q, k, v) for s in t.stride()[:3]
    ) and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _build.load("flash_attention_fwd", _bind)
    with torch.cuda.device(dev):
        status = lib.lljt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, nh, T, hd, *strides, math.log2(math.e) / math.sqrt(hd), int(vec),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    flash_attention_fwd.launches += 1
    _build.check(lib, status, "flash_attention_fwd")
    return o, lse


flash_attention_fwd.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    i, ll = ctypes.c_int, ctypes.c_longlong
    _build.bind(lib, "lljt_flash_fwd", 5, [i] * 4 + [ll] * 9 + [ctypes.c_float, i])
