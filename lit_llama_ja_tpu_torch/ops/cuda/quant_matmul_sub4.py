"""Int2 and int3 dequant-matmuls: the wrappers of ``csrc/quant_matmul_sub4.cu`` (K4, K5)
and their plain PyTorch versions.

* `quant_matmul_int2` replaces the Pallas kernel
  `lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447 quant_matmul_int2`.
* `quant_matmul_int3` replaces `quant_matmul_int3` (`:323`); both TPU kernels share
  the body `_qmm_sub4_kernel` (`:81`), and both CUDA ones the library.

Each computes exactly ``x @ dequantize_with_k(params, K)`` over a pack whose stored
rows Kp (``sub4_pad_rows``) may exceed x's K, with scale groups of ``ceil(Kp / G)``
rows: the kernels read x as zero past K, so the pad rows add nothing. The tensor-core
GEMV shared with K1 and K3 (``csrc/qmm_gemv.cuh``, planned by `gemv_plan`) serves M <= 16
rows through the ``Int2Gemv`` / ``Int3Gemv`` decoders, the tensor-core GEMM of
``csrc/qmm_generic.cuh`` larger M.

Both wrappers also take the JAX functions' ``unpack`` names. The exact ones (None,
``"bf16"``, and for int2 ``"bf16_groupdeq"``) keep the route above; ``"int8dot"``,
``"int8dot_bc"`` and ``"int8dot_fused"`` (`A8_MODES`) compute the JAX kernel's W2A8 or
W3A8 numerics through `quant_matmul_int2_a8` / `quant_matmul_int3_a8` (the A8 kernel of
``csrc/qmm_a8.cuh`` with the int2 and int3 decoders of ``csrc/quant_matmul_sub4_a8.cu``;
plain versions `quant_matmul_int2_a8_ref` / `quant_matmul_int3_a8_ref`): x rounded to int8 per
(row, activation group of `sub4_a8_plan`), the exact integer sum of x̂·q with q = q2 or
q2 + 4·hi, folded into f32 a group at a time. On the TPU the JAX functions take these
modes by themselves at M <= 64 (int3 always, int2 for whole-column packs); here a caller
asks for them. Other names raise, the JAX kernel's ``"int8dot_diag_noand"`` among them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    GEMV_MAX_M,
    A8Plan,
    _dequant_matmul,
    a8_fold_ref,
    a8_launch,
    a8_prepare,
    check_groups,
    gemv_launch_args,
    jax_block_k,
    launch_gemm_plan,
    plan_tiles,
    prepare_launch,
)

_MAX_PAD = 2048  # stored rows beyond K that a sub-4-bit pack may carry (sub4_pad_rows)
A8_MODES = ("int8dot", "int8dot_bc", "int8dot_fused")
# the JAX kernels' default block_k at M <= 64 and above (_common_tiling): int2 packed
# rows, int3 bit-plane rows
INT2_BLOCK_K = (256, 512)
INT3_BLOCK_K = (128, 256)


def quant_matmul_int2_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version of K4."""
    return _dequant_matmul(x, {"qweight": qweight, "scales": scales, "zeros": zeros}, 2)


def quant_matmul_int3_ref(
    x: torch.Tensor, qweight: torch.Tensor, qweight_hi: torch.Tensor, scales: torch.Tensor,
    zeros: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K5."""
    return _dequant_matmul(x, {"qweight": qweight, "qweight_hi": qweight_hi,
                               "scales": scales, "zeros": zeros}, 3)


def _check(x, qweight, scales, zeros, qweight_hi=None):
    K = x.shape[-1]
    if qweight.dim() != 2 or qweight.dtype != torch.uint8:
        raise ValueError(f"qweight must be a 2-D uint8 (Kp/4, N) pack, got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    Kq, N = qweight.shape
    Kp = 4 * Kq
    if Kp % 8 or not 0 <= Kp - K < _MAX_PAD:
        raise ValueError(f"x has K={K} but qweight packs {Kp} rows (need K <= Kp < K + "
                         f"{_MAX_PAD}, Kp a multiple of 8)")
    if qweight_hi is not None and (qweight_hi.dtype != torch.uint8
                                   or tuple(qweight_hi.shape) != (Kp // 8, N)):
        raise ValueError(f"qweight_hi must be a uint8 ({Kp // 8}, {N}) bit plane, got "
                         f"{tuple(qweight_hi.shape)} {qweight_hi.dtype}")
    return K, Kp, N, check_groups(scales, zeros, N, Kp)


def _launch(name, fn, bits, x, qweight, qweight_hi, scales, zeros, K, Kp, N, G):
    weights = dict(qweight=qweight, scales=scales, zeros=zeros)
    if qweight_hi is not None:
        weights["qweight_hi"] = qweight_hi
    x2, out, lead = prepare_launch(name, x, N, **weights)
    M = x2.shape[0]
    if M == 0:
        return out.reshape(*lead, N)
    dev = x.device
    hi = 0 if qweight_hi is None else qweight_hi.data_ptr()
    lib = _build.load("quant_matmul_sub4", _bind)
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            status = lib.lljt_qmm_sub4_gemv(
                x2.data_ptr(), qweight.data_ptr(), hi, scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, Kp, N, G, bits,
                *gemv_launch_args(x2, N, G, bits, qweight, scales, zeros, Kp, qweight_hi),
            )
        else:
            packed = [qweight] if qweight_hi is None else [qweight, qweight_hi]
            plan = launch_gemm_plan(dev, x2, N, packed, scales, zeros)
            status = lib.lljt_qmm_sub4_gemm(
                x2.data_ptr(), qweight.data_ptr(), hi, scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, Kp, N, G, bits, *plan,
                torch.cuda.current_stream(dev).cuda_stream,
            )
    fn.launches += 1
    _build.check(lib, status, name)
    return out.reshape(*lead, N)


def _route(unpack, exact, fn):
    """True for an A8 name, False for an exact one; any other name raises."""
    if unpack in A8_MODES:
        return True
    if unpack in exact:
        return False
    if unpack == "int8dot_diag_noand":
        raise ValueError(f"{fn}: unpack 'int8dot_diag_noand' is the JAX kernel's "
                         "\"DIAGNOSTIC ONLY (wrong math)\" mode (every plane read as the "
                         "raw byte), which the port does not compute")
    if unpack == "bf16_groupdeq":
        raise ValueError(f"{fn}: unpack 'bf16_groupdeq' is int2-only, as the JAX kernel "
                         "asserts")
    raise ValueError(f"{fn}: unknown unpack {unpack!r}: one of {exact + A8_MODES}")


def quant_matmul_int2(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    unpack: str | None = None,
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (Kp/4, N) uint8, scales/zeros (G, N) f32)`` in
    ``x.dtype``. CPU tensors run `quant_matmul_int2_ref`; CUDA tensors launch the
    kernel (bf16 x, contiguous f32 scales and zeros on x's device) or raise. ``unpack``:
    see the module docstring."""
    if _route(unpack, (None, "bf16", "bf16_groupdeq"), "quant_matmul_int2"):
        return quant_matmul_int2_a8(x, qweight, scales, zeros)
    K, Kp, N, G = _check(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int2_ref(x, qweight, scales, zeros)
    return _launch("quant_matmul_int2", quant_matmul_int2, 2, x, qweight, None, scales, zeros,
                   K, Kp, N, G)


quant_matmul_int2.launches = 0


def quant_matmul_int3(
    x: torch.Tensor, qweight: torch.Tensor, qweight_hi: torch.Tensor, scales: torch.Tensor,
    zeros: torch.Tensor, unpack: str | None = None,
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (Kp/4, N), qweight_hi (Kp/8, N), scales/zeros
    (G, N))`` in ``x.dtype``, levels ``q2 + 4·hi``. CPU tensors run
    `quant_matmul_int3_ref`; CUDA tensors launch the kernel or raise. ``unpack``: see the
    module docstring."""
    if _route(unpack, (None, "bf16"), "quant_matmul_int3"):
        return quant_matmul_int3_a8(x, qweight, qweight_hi, scales, zeros)
    K, Kp, N, G = _check(x, qweight, scales, zeros, qweight_hi)
    if not x.is_cuda:
        return quant_matmul_int3_ref(x, qweight, qweight_hi, scales, zeros)
    return _launch("quant_matmul_int3", quant_matmul_int3, 3, x, qweight, qweight_hi, scales,
                   zeros, K, Kp, N, G)


quant_matmul_int3.launches = 0


@functools.lru_cache(maxsize=256)
def sub4_a8_plan(K: int, Kp: int, G: int, M: int, bits: int) -> A8Plan:
    """`A8Plan` of the W2A8/W3A8 modes over a pack of Kp stored rows (K of them real)
    with G scale rows and M rows of x, as the JAX kernel's `_common_tiling` lays it out:
    `plan_tiles` over the int2 packed rows (Kp/4; ``block_k`` 256 at M <= 64, 512 above)
    or the int3 bit-plane rows (Kp/8; 128, 256); one k-tile of every row where a tile is
    neither a multiple of 128 rows nor the whole pack (the kernel's lane alignment
    rule); group slices of ``bk2 // gpt`` int2 rows (``bk2`` the tile's int2 rows), so
    4 ``bk2 // gpt`` K elements a group, and rows past the slices unread; the scale
    repeat ``n_k // G``. Raises where the JAX kernel leaves a K-row under K unread, where
    an int3 slice's bit-plane rows would cover other K-rows than its int2 rows (an odd
    slice), and where it would read scale rows past G."""
    rows = Kp // 4 if bits == 2 else Kp // 8
    bk, gpt = plan_tiles(rows, G, jax_block_k(INT2_BLOCK_K if bits == 2 else INT3_BLOCK_K, M))
    if bk % 128 and bk != rows:
        bk, gpt = rows, G
    n_k = rows // bk
    bk2 = bk if bits == 2 else 2 * bk
    sub2 = bk2 // gpt
    n_act = n_k * gpt
    rep = 1 if n_act == G else n_k // G
    if (sub2 == 0 or (bits == 3 and sub2 % 2) or (n_k > 1 and gpt * sub2 != bk2)
            or 4 * sub2 * n_act < K or G * rep != n_act):
        raise ValueError(f"the W{bits}A8 plan of {Kp} stored rows ({K} real) in {G} scale "
                         f"groups does not cover them (tiles of {bk} rows, {gpt} groups "
                         f"of {4 * sub2} K-rows a tile)")
    return A8Plan(4 * sub2, n_act, rep)


def _a8_ref(x, qweight, qweight_hi, scales, zeros, out_dtype):
    from lit_llama_ja_tpu_torch.quant.linear import unpack_levels

    K, Kp, N, G = _check(x, qweight, scales, zeros, qweight_hi)
    bits = 2 if qweight_hi is None else 3
    plan = sub4_a8_plan(K, Kp, G, x.numel() // K, bits)
    levels = unpack_levels({"qweight": qweight, "qweight_hi": qweight_hi}, K, bits)
    return a8_fold_ref(x, levels[:plan.k_read], scales, zeros, plan, 0.0, out_dtype)


def quant_matmul_int2_a8_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of K4's W2A8 modes, step by step as the JAX kernel's ``int8dot*``
    epilogues: x zero-padded to Kp and rounded to int8 per (row, group) over the group's
    K elements (`a8_quantize_ref`), the exact integer sum ``D = Σ x̂ q``, then per group
    ``(D - sx_tot z) * (s / rsx)`` in f32 (`a8_fold_ref`), summed over the groups."""
    return _a8_ref(x, qweight, None, scales, zeros, out_dtype)


def quant_matmul_int3_a8_ref(
    x: torch.Tensor, qweight: torch.Tensor, qweight_hi: torch.Tensor, scales: torch.Tensor,
    zeros: torch.Tensor, out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of K5's W3A8 modes: `quant_matmul_int2_a8_ref`'s steps with the
    levels ``q2 + 4·hi``."""
    return _a8_ref(x, qweight, qweight_hi, scales, zeros, out_dtype)


def _a8(fn, x, qweight, qweight_hi, scales, zeros, out_dtype):
    K, Kp, N, G = _check(x, qweight, scales, zeros, qweight_hi)
    bits = 2 if qweight_hi is None else 3
    plan = sub4_a8_plan(K, Kp, G, x.numel() // K, bits)
    if not x.is_cuda:
        return _a8_ref(x, qweight, qweight_hi, scales, zeros, out_dtype)
    weights = dict(qweight=qweight, scales=scales, zeros=zeros)
    if qweight_hi is not None:
        weights["qweight_hi"] = qweight_hi
    x2, out, lead = a8_prepare(f"int{bits} W{bits}A8", x, N, out_dtype, **weights)
    if x2.shape[0] == 0:
        return out.reshape(*lead, N)
    sub4_a8_launch(x2, qweight, qweight_hi, scales, zeros, out, plan)
    fn.launches += 1
    return out.reshape(*lead, N)


def sub4_a8_launch(x2: torch.Tensor, qweight: torch.Tensor, qweight_hi, scales: torch.Tensor,
                   zeros: torch.Tensor, out: torch.Tensor, plan: A8Plan, levels: bool = False):
    """`a8_launch` of the W2A8 (``qweight_hi`` None) or W3A8 kernel; returns its
    rounding (see there)."""
    lib = _build.load("quant_matmul_sub4_a8", _bind_a8)
    M, K = x2.shape
    return a8_launch(lib, "lljt_qmm_sub4_a8", x2, (qweight, qweight_hi), scales, zeros, out,
                     plan, (M, K, 4 * qweight.shape[0], out.shape[-1]),
                     (2 if qweight_hi is None else 3,), levels)


def quant_matmul_int2_a8(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K4's W2A8 modes: the product of `quant_matmul_int2_a8_ref`, returned in
    ``out_dtype`` (bf16 or f32 on CUDA; default ``x.dtype``). CPU tensors run the plain
    version; CUDA tensors launch the kernel of ``csrc/quant_matmul_sub4_a8.cu`` or raise; it
    never falls back to the exact kernel. Plans the JAX kernel cannot run raise."""
    return _a8(quant_matmul_int2_a8, x, qweight, None, scales, zeros, out_dtype)


quant_matmul_int2_a8.launches = 0


def quant_matmul_int3_a8(
    x: torch.Tensor, qweight: torch.Tensor, qweight_hi: torch.Tensor, scales: torch.Tensor,
    zeros: torch.Tensor, out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K5's W3A8 modes: `quant_matmul_int2_a8` over the levels ``q2 + 4·hi``."""
    return _a8(quant_matmul_int3_a8, x, qweight, qweight_hi, scales, zeros, out_dtype)


quant_matmul_int3_a8.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm_sub4_gemv", 6, [i] * 12)
    _build.bind(lib, "lljt_qmm_sub4_gemm", 6, [i] * 10)


def _bind_a8(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm_sub4_a8", 10, [i] * 12)
    _build.bind(lib, "lljt_qmm_sub4_a8_gemv", 7, [i] * 12)
