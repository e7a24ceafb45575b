"""Int2 and int3 dequant-matmuls: the wrappers of ``csrc/quant_matmul_sub4.cu`` (K4, K5)
and their plain PyTorch versions.

* `quant_matmul_int2` replaces the Pallas kernel
  `lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447 quant_matmul_int2`.
* `quant_matmul_int3` replaces `quant_matmul_int3` (`:323`); both TPU kernels share
  the body `_qmm_sub4_kernel` (`:81`), and both CUDA ones the library.

Each computes exactly ``x @ dequantize_with_k(params, K)`` over a pack whose stored
rows Kp (``sub4_pad_rows``) may exceed x's K: the kernels read x as zero past K and
never multiply the pad rows. A split-K GEMV serves M <= 16 rows, a tensor-core GEMM
larger M.
"""
from __future__ import annotations

import ctypes

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    GEMV_MAX_M,
    _dequant_matmul,
    check_groups,
    gemv_split,
    prepare_launch,
)

_MAX_PAD = 2048  # stored rows beyond K that a sub-4-bit pack may carry (sub4_pad_rows)
_GEMV_MIN_ROWS = 64  # K-rows per GEMV split


def quant_matmul_int2_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version of K4."""
    return _dequant_matmul(x, {"qweight": qweight, "scales": scales, "zeros": zeros})


def quant_matmul_int3_ref(
    x: torch.Tensor, qweight: torch.Tensor, qweight_hi: torch.Tensor, scales: torch.Tensor,
    zeros: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K5."""
    return _dequant_matmul(x, {"qweight": qweight, "qweight_hi": qweight_hi,
                               "scales": scales, "zeros": zeros})


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
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            unit = 4 if bits == 2 else 8  # K-rows per GEMV unit
            ksplit, units, ws = gemv_split(dev, M, N, -(-K // unit), _GEMV_MIN_ROWS // unit)
            status = lib.lljt_qmm_sub4_gemv(
                x2.data_ptr(), qweight.data_ptr(), hi, scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), (out if ws is None else ws).data_ptr(),
                M, K, Kp, N, G, bits, ksplit, units, stream,
            )
        else:
            status = lib.lljt_qmm_sub4_gemm(
                x2.data_ptr(), qweight.data_ptr(), hi, scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, Kp, N, G, bits, stream,
            )
    fn.launches += 1
    _build.check(lib, status, name)
    return out.reshape(*lead, N)


def quant_matmul_int2(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (Kp/4, N) uint8, scales/zeros (G, N) f32)`` in
    ``x.dtype``. CPU tensors run `quant_matmul_int2_ref`; CUDA tensors launch the
    kernel (bf16 x, contiguous f32 scales and zeros on x's device) or raise."""
    K, Kp, N, G = _check(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int2_ref(x, qweight, scales, zeros)
    return _launch("quant_matmul_int2", quant_matmul_int2, 2, x, qweight, None, scales, zeros,
                   K, Kp, N, G)


quant_matmul_int2.launches = 0


def quant_matmul_int3(
    x: torch.Tensor, qweight: torch.Tensor, qweight_hi: torch.Tensor, scales: torch.Tensor,
    zeros: torch.Tensor,
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (Kp/4, N), qweight_hi (Kp/8, N), scales/zeros
    (G, N))`` in ``x.dtype``, levels ``q2 + 4·hi``. CPU tensors run
    `quant_matmul_int3_ref`; CUDA tensors launch the kernel or raise."""
    K, Kp, N, G = _check(x, qweight, scales, zeros, qweight_hi)
    if not x.is_cuda:
        return quant_matmul_int3_ref(x, qweight, qweight_hi, scales, zeros)
    return _launch("quant_matmul_int3", quant_matmul_int3, 3, x, qweight, qweight_hi, scales,
                   zeros, K, Kp, N, G)


quant_matmul_int3.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm_sub4_gemv", 7, [i] * 8)
    _build.bind(lib, "lljt_qmm_sub4_gemm", 6, [i] * 6)
