"""Causal flash attention: the wrappers of ``csrc/flash_attention_fwd.cu`` (K2) and
``csrc/flash_attention_bwd.cu`` (K6), their plain PyTorch versions, and the autograd
function that joins them.

* `flash_attention_fwd` replaces the Pallas kernel
  `lit_llama_ja_tpu/ops/pallas/flash_attention.py:78 _flash_forward`. It returns
  ``(o, lse)``: ``o = softmax(q kᵀ / sqrt(hd), causal) v`` and the per-row logsumexp
  of the scaled scores, in natural-log units.
* `flash_attention_bwd` replaces `_flash_backward` (`:207`): dq, dk and dv from the
  forward's residuals, recomputing the probabilities from ``lse``.
* `flash_attention` is the counterpart of the custom VJP at `:283-304`: a
  `torch.autograd.Function` whose forward is K2 and whose backward is K6.
"""
from __future__ import annotations

import ctypes
import math

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build

MAX_HEAD_DIM = 128


def _causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 ``q kᵀ / sqrt(hd)`` with the positions above the diagonal at -inf."""
    T, hd = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    return torch.where(causal, s, float("-inf"))


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version in f32: materializes the (T, T) scores."""
    s = _causal_scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do):
    """Plain version in f32 of the backward: materializes the (T, T) matrices.
    Returns ``(dq, dk, dv)`` in q's dtype."""
    p = torch.exp(_causal_scores(q, k) - lse[..., None])  # masked positions -> 0
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    dd = (do32 * o.float()).sum(-1)
    ds = p * (dp - dd[..., None]) / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_same_shape(**tensors) -> None:
    shapes = {name: tuple(t.shape) for name, t in tensors.items()}
    first = next(iter(shapes.values()))
    if len(first) != 4 or any(s != first for s in shapes.values()):
        raise ValueError(f"{', '.join(shapes)} must share one (B, nh, T, hd) shape, got "
                         f"{', '.join(map(str, shapes.values()))}")


def _check_kernel_inputs(dev: torch.device, hd: int, **tensors) -> bool:
    """Raise on what the kernels do not take; returns whether 16-byte loads apply."""
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash-attention kernels take bf16, got {name} {t.dtype}")
        if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(f"{name} needs unit stride along hd, even strides and "
                             f"4-byte alignment, got strides {t.stride()}")
    if hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim must be even and at most {MAX_HEAD_DIM}, got {hd}")
    ts = tensors.values()
    return (hd % 8 == 0 and all(s % 8 == 0 for t in ts for s in t.stride()[:3])
            and all(t.data_ptr() % 16 == 0 for t in ts))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention over ``(B, n_head, T, head_dim)`` q, k, v -> ``(o, lse)`` with
    ``o`` like q (contiguous) and ``lse`` ``(B, n_head, T)`` f32.

    CPU tensors run `flash_attention_fwd_ref`. CUDA tensors launch the kernel, which
    takes bf16 inputs with an even head dim of at most 128, unit stride along the
    head dim and even strides elsewhere (views such as a transposed projection are
    fine); anything else raises.
    """
    _check_same_shape(q=q, k=k, v=v)
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v)
    B, nh, T, hd = q.shape
    dev = q.device
    vec = _check_kernel_inputs(dev, hd, q=q, k=k, v=v)
    o = torch.empty((B, nh, T, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return o, lse
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _build.load("flash_attention_fwd", _bind_fwd)
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


def flash_attention_bwd(q, k, v, o, lse, do):
    """Gradients ``(dq, dk, dv)`` of causal attention for the output gradient ``do``,
    from the forward's residuals ``o`` and ``lse`` (natural-log units, as
    `flash_attention_fwd` returns them). The outputs are contiguous and like q.

    CPU tensors run `flash_attention_bwd_ref`. CUDA tensors launch K6, which takes
    q, k, v and do as the K2 wrapper takes q, k, v (bf16, unit stride along the head
    dim, even strides, any layout autograd hands over) and ``lse`` as K2 returns it;
    anything else raises. ``D = Σ do·o`` per row is computed here in plain PyTorch,
    as the JAX package leaves it to XLA outside its Pallas kernels.
    """
    _check_same_shape(q=q, k=k, v=v, o=o, do=do)
    B, nh, T, hd = q.shape
    if tuple(lse.shape) != (B, nh, T):
        raise ValueError(f"lse must be (B, nh, T) = {(B, nh, T)}, got {tuple(lse.shape)}")
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, o, lse, do)
    dev = q.device
    vec = _check_kernel_inputs(dev, hd, q=q, k=k, v=v, do=do)
    if lse.device != dev or o.device != dev or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 and o and lse on {dev}, got lse {lse.dtype} on "
                         f"{lse.device}, o on {o.device}")
    dq, dk, dv = (torch.empty((B, nh, T, hd), dtype=q.dtype, device=dev) for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    lse = lse.contiguous()
    dd = (do.float() * o.float()).sum(-1)  # (B, nh, T) f32, contiguous
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    lib = _build.load("flash_attention_bwd", _bind_bwd)
    with torch.cuda.device(dev):
        status = lib.lljt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, nh, T, hd, *strides, 1.0 / math.sqrt(hd), math.log2(math.e) / math.sqrt(hd),
            int(vec), torch.cuda.current_stream(dev).cuda_stream,
        )
    flash_attention_bwd.launches += 1
    _build.check(lib, status, "flash_attention_bwd")
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward K2, saving (q, k, v, o, lse); backward K6. The saved q, k, v may be
    views of the projection that produced them, which keeps it alive until the
    backward, as JAX's residuals do."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable causal flash attention over ``(B, n_head, T, head_dim)``."""
    return _FlashAttention.apply(q, k, v)


def _bind_fwd(lib: ctypes.CDLL) -> None:
    i, ll = ctypes.c_int, ctypes.c_longlong
    _build.bind(lib, "lljt_flash_fwd", 5, [i] * 4 + [ll] * 9 + [ctypes.c_float, i])


def _bind_bwd(lib: ctypes.CDLL) -> None:
    i, ll, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    _build.bind(lib, "lljt_flash_bwd", 9, [i] * 4 + [ll] * 12 + [f, f, i])
