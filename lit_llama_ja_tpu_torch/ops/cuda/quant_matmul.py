"""Int4 dequant-matmul: the wrapper of ``csrc/quant_matmul_int4.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel `lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325
quant_matmul_int4`. It computes exactly ``x @ dequantize_with_k(params, K)``: the
weight is dequantized in f32 as ``(q - zero) * scale`` and the product accumulates in
f32. Two regimes sit behind the one wrapper: a split-K GEMV for M <= 16 rows (decode)
and a tensor-core GEMM for larger M (prefill).
"""
from __future__ import annotations

import ctypes

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build

GEMV_MAX_M = 16
_GEMV_COLS = 128  # output columns per GEMV block (4 per thread, 32 lanes)
_GEMV_MIN_ROWS = 64  # packed rows per GEMV split, at least 16 per warp


def quant_matmul_int4_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version: dequantize the whole weight in f32, cast to ``x.dtype``, matmul."""
    from lit_llama_ja_tpu_torch.quant.linear import dequantize_with_k

    params = {"qweight": qweight, "scales": scales, "zeros": zeros}
    return x @ dequantize_with_k(params, x.shape[-1], dtype=x.dtype)


def _check(x, qweight, scales, zeros):
    K = x.shape[-1]
    if qweight.dim() != 2 or qweight.dtype != torch.uint8:
        raise ValueError(f"qweight must be a 2-D uint8 (K/2, N) pack, got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    Kh, N = qweight.shape
    if 2 * Kh != K:
        raise ValueError(f"x has K={K} but qweight packs {2 * Kh} rows")
    G = scales.shape[0]
    if scales.shape != (G, N) or zeros.shape != (G, N) or not 1 <= G <= K:
        raise ValueError(f"scales/zeros must be (G, {N}) with 1 <= G <= {K}, got "
                         f"{tuple(scales.shape)} and {tuple(zeros.shape)}")
    return K, N, G


def quant_matmul_int4(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (K/2, N) uint8, scales/zeros (G, N) f32)``,
    returned in ``x.dtype``.

    CPU tensors run `quant_matmul_int4_ref`. CUDA tensors launch the kernel, which
    takes bf16 ``x`` and contiguous f32 ``scales``/``zeros`` on the same device;
    anything else raises.
    """
    K, N, G = _check(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int4_ref(x, qweight, scales, zeros)
    dev = x.device
    for name, t in (("qweight", qweight), ("scales", scales), ("zeros", zeros)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the int4 kernel takes bf16 activations, got {x.dtype}")
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise TypeError("the int4 kernel takes f32 scales and zeros")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    lib = _build.load("quant_matmul_int4", _bind)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            Kh = K // 2
            n_col_blocks = -(-N // _GEMV_COLS)
            target = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
            ksplit = max(1, min(-(-target // n_col_blocks), Kh // _GEMV_MIN_ROWS))
            rows = -(-Kh // ksplit)
            ksplit = -(-Kh // rows)
            ws = (torch.empty((ksplit, M, N), dtype=torch.float32, device=dev)
                  if ksplit > 1 else out)
            status = lib.lljt_qmm4_gemv(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), ws.data_ptr(),
                M, K, N, G, ksplit, rows, stream,
            )
        else:
            status = lib.lljt_qmm4_gemm(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), M, K, N, G, stream,
            )
    quant_matmul_int4.launches += 1
    _build.check(lib, status, "quant_matmul_int4")
    return out.reshape(*lead, N)


quant_matmul_int4.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm4_gemv", 6, [i, i, i, i, i, i])
    _build.bind(lib, "lljt_qmm4_gemm", 5, [i, i, i, i])
