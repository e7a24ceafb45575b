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
import functools
import math
from typing import NamedTuple

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build

MAX_HEAD_DIM = 128
KV_ROWS = 64  # rows of each streamed k/v tile (flash::KV_ROWS in csrc/flash_common.cuh)
DKV_Q_ROWS, DKV_Q_ROWS_WIDE = 64, 32  # q/dO tile rows of the dkv kernel (dkv_q_rows)
FWD_STAGES = BWD_STAGES = 2  # depth of the cp.async rings (fwd_stages, bwd_stages)
REALIGN_MIN_ROWS = 65536  # realign narrow inputs from this many (B, head, token) rows on


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


def _check_kernel_inputs(dev: torch.device, hd: int, **tensors) -> None:
    """Raise on what the kernels do not take."""
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


class FlashPlan(NamedTuple):
    """How K2 and K6 run one call (see `flash_plan`)."""

    rows: int  # query rows of a K2 or dq block, keys of a dkv block: 64 or 128
    kv_rows: int  # rows of each k/v tile streamed by K2 and the dq kernel
    q_rows: int  # rows of each q/dO tile streamed by the dkv kernel
    stages: tuple  # depth of the cp.async rings of K2 and of K6
    width: int  # bytes a cp.async: 16, 8 or 4
    realign: tuple  # per input: copy it first into rows that start on 16 bytes
    smem: int  # bytes of dynamic shared memory of the largest of the three kernels


def padded_head_dim(hd: int) -> int:
    """The head dim of the kernels' shared tiles (HDP in ``csrc/flash_common.cuh``)."""
    return 64 if hd <= 64 else 80 if hd <= 80 else 128


def flash_smem(hd: int, rows: int) -> dict:
    """Dynamic shared memory of each kernel, as ``fwd_smem``, ``dq_smem`` and
    ``dkv_smem`` of the CUDA sources compute it: bf16 rows of HDP + 8 elements; K2 holds
    its q rows and a ring of k and v tiles; the dq kernel its q and dO rows and a ring of
    k and v tiles; the dkv kernel its k and v rows and a ring of q, dO, lse and D."""
    hdp = padded_head_dim(hd)
    row = 2 * (hdp + 8)
    q_rows = DKV_Q_ROWS_WIDE if hdp > 80 else DKV_Q_ROWS
    ring_f, ring_b = 2 * FWD_STAGES, 2 * BWD_STAGES  # k and v / q and dO tiles
    return {"fwd": (rows + ring_f * KV_ROWS) * row, "dq": (2 * rows + ring_b * KV_ROWS) * row,
            "dkv": (2 * rows + ring_b * q_rows) * row + 4 * ring_b * q_rows}


def row_alignment(strides, ptr: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that every row of a bf16 tensor with
    (batch, head, token) element strides ``strides`` and base address ``ptr`` starts
    on. The kernels copy a row's last partial chunk with fewer source bytes, so the
    head dim does not enter."""
    return next((w for w in (16, 8) if all((2 * s) % w == 0 for s in strides)
                 and ptr % w == 0), 4)


def flash_plan(B: int, nh: int, T: int, hd: int, strides, n_sm: int, ptrs=None) -> FlashPlan:
    """Block size and copy route of K2 and K6 for ``(B, nh, T, hd)`` inputs whose
    (batch, head, token) element strides are ``strides`` (one triple per tensor) and
    whose base addresses are ``ptrs`` (0 where not given).

    * ``rows``: 128 unless 128-row blocks would leave more than half the SMs idle, then
      64. K2 gives a warp 32 query rows, the dq kernel 16 rows, the dkv kernel 16 keys. On an
      H100 128 rows measured faster at every shape of ``chip_smoke.py``, the 7B prefill
      at T 512 included (32 heads x 4 blocks: 128 blocks on 132 SMs), where 64-row
      blocks of two warps fill the card but copy every k/v tile twice as often per row
      (``flash_probe``).
    * ``width`` and ``realign``: 16-byte copies where every input's rows start on 16
      bytes. An input whose rows do not (the 125M model's hd 78 views, whose heads lie
      156 bytes apart, allow only 4) is copied by the wrapper into a buffer whose rows
      are hd rounded up to 8 elements apart, when the call has at least
      `REALIGN_MIN_ROWS` rows: measured on an H100 (``flash_probe``), the
      copies and 16-byte ``cp.async`` beat 4-byte ``cp.async`` from the views at the
      125M training micro-batch (B 4, 10 heads, T 2048: 81,920 rows) in both kernels,
      and lose at one sequence of 2,048 tokens or fewer (20,480 rows), where the
      copies' launches cost more than the kernel saves. Otherwise ``width`` is the
      narrowest of the inputs' `row_alignment`.
    * ``kv_rows``, ``q_rows`` and ``stages`` are fixed by the kernels: 64-row k/v
      tiles, 64-row q/dO tiles in the dkv kernel (32 above hd 80, to keep its dk and dv
      accumulators in registers), rings of `FWD_STAGES` and `BWD_STAGES`.
    """
    blocks_128 = B * nh * -(-T // 128)
    rows = 128 if 2 * blocks_128 >= n_sm else 64
    ptrs = list(ptrs) if ptrs is not None else [0] * len(strides)
    widths = [row_alignment(st, p) for st, p in zip(strides, ptrs)]
    big = B * nh * T >= REALIGN_MIN_ROWS
    realign = tuple(big and w < 16 for w in widths)
    width = min(16 if r else w for w, r in zip(widths, realign))
    wide = padded_head_dim(hd) > 80
    return FlashPlan(rows=rows, kv_rows=KV_ROWS,
                     q_rows=DKV_Q_ROWS_WIDE if wide else DKV_Q_ROWS,
                     stages=(FWD_STAGES, BWD_STAGES),
                     width=width, realign=realign, smem=max(flash_smem(hd, rows).values()))


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _cached_plan(plan_fn, B, nh, T, hd, strides, n_sm, ptrs, min_rows):
    """`flash_plan` memoized on everything it reads (base addresses modulo 16 only), so
    that a call's host time stays that of a dictionary lookup."""
    return plan_fn(B, nh, T, hd, strides, n_sm, ptrs)


def _planned(tensors):
    """`flash_plan` for CUDA tensors, and the tensors with each input that the plan
    realigns replaced by a copy whose rows start on 16 bytes: a view of width hd of a
    fresh ``(B, nh, T, hd8)`` buffer (hd8: hd rounded up to 8)."""
    B, nh, T, hd = tensors[0].shape
    dev = tensors[0].device
    plan = _cached_plan(flash_plan, B, nh, T, hd, tuple(t.stride()[:3] for t in tensors),
                        _n_sm(dev.index or 0), tuple(t.data_ptr() % 16 for t in tensors),
                        REALIGN_MIN_ROWS)
    n = sum(plan.realign)
    if not n:
        return plan, list(tensors)
    bufs = iter(torch.empty((n, B, nh, T, hd + -hd % 8), dtype=tensors[0].dtype, device=dev))
    return plan, [next(bufs)[..., :hd].copy_(t) if r else t
                  for t, r in zip(tensors, plan.realign)]


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
    _check_kernel_inputs(dev, hd, q=q, k=k, v=v)
    o = torch.empty((B, nh, T, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=dev)
    if o.numel() == 0:
        return o, lse
    plan, (q, k, v) = _planned((q, k, v))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _build.load("flash_attention_fwd", _bind_fwd)
    with torch.cuda.device(dev):
        status = lib.lljt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, nh, T, hd, *strides, math.log2(math.e) / math.sqrt(hd), plan.rows,
            plan.width, torch.cuda.current_stream(dev).cuda_stream,
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
    _check_kernel_inputs(dev, hd, q=q, k=k, v=v, do=do)
    if lse.device != dev or o.device != dev or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 and o and lse on {dev}, got lse {lse.dtype} on "
                         f"{lse.device}, o on {o.device}")
    dq, dk, dv = (torch.empty((B, nh, T, hd), dtype=q.dtype, device=dev) for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    lse = lse.contiguous()
    dd = (do.float() * o.float()).sum(-1)  # (B, nh, T) f32, contiguous
    plan, (q, k, v, do) = _planned((q, k, v, do))
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    lib = _build.load("flash_attention_bwd", _bind_bwd)
    with torch.cuda.device(dev):
        status = lib.lljt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, nh, T, hd, *strides, 1.0 / math.sqrt(hd), math.log2(math.e) / math.sqrt(hd),
            plan.rows, plan.width, torch.cuda.current_stream(dev).cuda_stream,
        )
    flash_attention_bwd.launches += 1
    _build.check(lib, status, "flash_attention_bwd")
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward K2, saving (q, k, v, o, lse); backward K6. The saved q, k, v may be
    views of the projection that produced them, which keeps it alive until the
    backward, as JAX's residuals do. On CUDA, inputs that `flash_plan` realigns are
    copied here, once, and the copies are what K2 reads and the backward keeps, so K6
    does not copy them again."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda and q.shape == k.shape == v.shape and q.dim() == 4 and q.numel():
            _, (q, k, v) = _planned((q, k, v))
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
    _build.bind(lib, "lljt_flash_fwd", 5, [i] * 4 + [ll] * 9 + [ctypes.c_float, i, i])


def _bind_bwd(lib: ctypes.CDLL) -> None:
    i, ll, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    _build.bind(lib, "lljt_flash_bwd", 9, [i] * 4 + [ll] * 12 + [f, f, i, i])
