"""Int4 and int8 dequant-matmuls: the wrappers of ``csrc/quant_matmul_int4.cu`` (K1) and
``csrc/quant_matmul_int8.cu`` (K3) and their plain PyTorch versions.

* `quant_matmul_int4` replaces the Pallas kernel
  `lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325 quant_matmul_int4`.
* `quant_matmul_int8` replaces `quant_matmul_int8` (`:451`), for int8 (symmetric
  absmax, zeros 0) and uint8 (asymmetric levels) packs.

Each computes exactly ``x @ dequantize_with_k(params, K)``: the weight is
dequantized in f32 as ``(q - zero) * scale`` and the product accumulates in f32. Two
regimes sit behind each wrapper: a split-K GEMV for M <= 16 rows (decode) and a
tensor-core GEMM for larger M (prefill), one GEMM for every format
(``csrc/qmm_generic.cuh``) planned by `gemm_plan`. The helpers here are shared with
the sub-4-bit wrappers (`quant_matmul_sub4.py`).
"""
from __future__ import annotations

import ctypes

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build

GEMV_MAX_M = 16
_GEMV_COLS = 128  # output columns per GEMV block (4 per thread, 32 lanes)
_GEMV_MIN_ROWS = 64  # K-rows per GEMV split, at least 16 per warp (K1 counts packed rows)
GEMM_BM = 128  # rows of x per block of the K1 and K3-K5 GEMM (csrc/qmm_generic.cuh)


def _dequant_matmul(x: torch.Tensor, params) -> torch.Tensor:
    """Plain version of every dequant-matmul: dequantize the whole weight in f32,
    cast to ``x.dtype``, matmul."""
    from lit_llama_ja_tpu_torch.quant.linear import dequantize_with_k

    return x @ dequantize_with_k(params, x.shape[-1], dtype=x.dtype)


def quant_matmul_int4_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version of K1."""
    return _dequant_matmul(x, {"qweight": qweight, "scales": scales, "zeros": zeros})


def quant_matmul_int8_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3."""
    return _dequant_matmul(x, {"qweight": qweight, "scales": scales, "zeros": zeros})


def check_groups(scales: torch.Tensor, zeros: torch.Tensor, N: int, rows: int) -> int:
    """``scales``/``zeros`` must be ``(G, N)`` with ``1 <= G <= rows``; returns G."""
    G = scales.shape[0]
    if scales.shape != (G, N) or zeros.shape != (G, N) or not 1 <= G <= rows:
        raise ValueError(f"scales/zeros must be (G, {N}) with 1 <= G <= {rows}, got "
                         f"{tuple(scales.shape)} and {tuple(zeros.shape)}")
    return G


def weight_alignment(t: torch.Tensor, N: int) -> int:
    """The widest load, in bytes, that the kernels issue on a weight buffer with N
    columns: 16 on f32 scales and zeros when N % 4 == 0; 8 on packed rows when
    N % 8 == 0 (the GEMM), else 4 when N % 4 == 0 (the GEMV). So one layer's view of
    a stacked (L, ...) tree whose base is 16-byte aligned always qualifies."""
    if t.dtype == torch.float32:
        return 16 if N % 4 == 0 else 4
    return 8 if N % 8 == 0 else 4 if N % 4 == 0 else 1


def prepare_launch(name: str, x: torch.Tensor, N: int, **weights: torch.Tensor):
    """The checks every kernel makes on CUDA inputs, then ``(x2, out, lead)``: x as
    a contiguous 16-byte aligned ``(M, K)`` bf16 matrix and the ``(M, N)`` output."""
    dev = x.device
    for wname, t in weights.items():
        if t.device != dev:
            raise ValueError(f"{wname} is on {t.device}, x on {dev}")
        align = weight_alignment(t, N)
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{wname} must be contiguous and {align}-byte aligned")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes bf16 activations, got {x.dtype}")
    if weights["scales"].dtype != torch.float32 or weights["zeros"].dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes f32 scales and zeros")
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=dev)
    return x2, out, x.shape[:-1]


def gemm_plan(M: int, K: int, N: int, n_sm: int, x_ptr: int, packed_ptrs, scale_ptrs):
    """Tile width and copy widths of the K1 and K3-K5 prefill GEMM (``qmm_generic.cuh``):
    ``(bn, xw, ww, sw)``.

    * ``bn``: 128 output columns a block, or 64 where 128-wide tiles would launch
      fewer blocks than half the card's SMs (N = 4096 at M = 128: 64 blocks, not 32).
      Measured on an H100 (``gemm_probe``): 128 is faster wherever 128-wide tiles give
      86 blocks or more (N = 4096 at M = 512: 128 blocks), 64 where they give 32.
    * ``xw``: bytes per copy of x, whose rows lie 2K bytes apart: 16, 8 or 4 as 2K and
      the base allow, or 2 for an odd K (plain loads in the kernel).
    * ``ww``: bytes per copy of the packed rows, N bytes apart: 16, 8 or 4 as N and
      every packed base allow, or 1 when N % 4 != 0 (byte loads).
    * ``sw``: 16 on f32 scales and zeros when N % 4 == 0 and both bases are 16-byte
      aligned, else 4.

    Every width falls back to a narrower one, so no view that `prepare_launch`
    accepts is refused."""
    tiles_128 = -(-N // 128) * -(-M // GEMM_BM)
    bn = 128 if 2 * tiles_128 >= n_sm else 64
    xw = next((w for w in (16, 8, 4) if (2 * K) % w == 0 and x_ptr % w == 0), 2)
    ww = next((w for w in (16, 8, 4)
               if N % w == 0 and all(p % w == 0 for p in packed_ptrs)), 1)
    sw = 16 if N % 4 == 0 and all(p % 16 == 0 for p in scale_ptrs) else 4
    return bn, xw, ww, sw


def launch_gemm_plan(dev: torch.device, x2: torch.Tensor, N: int, packed, scales, zeros):
    """`gemm_plan` for CUDA tensors on ``dev``."""
    M, K = x2.shape
    return gemm_plan(M, K, N, torch.cuda.get_device_properties(dev).multi_processor_count,
                     x2.data_ptr(), [t.data_ptr() for t in packed],
                     [scales.data_ptr(), zeros.data_ptr()])


def gemv_split(dev: torch.device, M: int, N: int, n_units: int, min_units: int):
    """Split-K plan of a GEMV over ``n_units`` row units: about four blocks per SM,
    at least ``min_units`` units per split. Returns ``(ksplit, units_per_split,
    workspace)``; the workspace is None when ``ksplit`` is 1."""
    n_col_blocks = -(-N // _GEMV_COLS)
    target = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    ksplit = max(1, min(-(-target // n_col_blocks), n_units // min_units))
    units = -(-n_units // ksplit)
    ksplit = -(-n_units // units)
    ws = torch.empty((ksplit, M, N), dtype=torch.float32, device=dev) if ksplit > 1 else None
    return ksplit, units, ws


def _check4(x, qweight, scales, zeros):
    K = x.shape[-1]
    if qweight.dim() != 2 or qweight.dtype != torch.uint8:
        raise ValueError(f"qweight must be a 2-D uint8 (K/2, N) pack, got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    Kh, N = qweight.shape
    if 2 * Kh != K:
        raise ValueError(f"x has K={K} but qweight packs {2 * Kh} rows")
    return K, N, check_groups(scales, zeros, N, K)


def quant_matmul_int4(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (K/2, N) uint8, scales/zeros (G, N) f32)``,
    returned in ``x.dtype``.

    CPU tensors run `quant_matmul_int4_ref`. CUDA tensors launch the kernel, which
    takes bf16 ``x`` and contiguous f32 ``scales``/``zeros`` on the same device;
    anything else raises.
    """
    K, N, G = _check4(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int4_ref(x, qweight, scales, zeros)
    x2, out, lead = prepare_launch("int4", x, N, qweight=qweight, scales=scales, zeros=zeros)
    M = x2.shape[0]
    if M == 0:
        return out.reshape(*lead, N)
    dev = x.device
    lib = _build.load("quant_matmul_int4", _bind4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            ksplit, rows, ws = gemv_split(dev, M, N, K // 2, _GEMV_MIN_ROWS)
            status = lib.lljt_qmm4_gemv(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), (out if ws is None else ws).data_ptr(),
                M, K, N, G, ksplit, rows, stream,
            )
        else:
            plan = launch_gemm_plan(dev, x2, N, [qweight], scales, zeros)
            status = lib.lljt_qmm4_gemm(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), M, K, N, G, *plan, stream,
            )
    quant_matmul_int4.launches += 1
    _build.check(lib, status, "quant_matmul_int4")
    return out.reshape(*lead, N)


quant_matmul_int4.launches = 0


def _check8(x, qweight, scales, zeros):
    K = x.shape[-1]
    if qweight.dim() != 2 or qweight.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"qweight must be a 2-D int8 or uint8 (K, N) matrix, got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    Kw, N = qweight.shape
    if Kw != K:
        raise ValueError(f"x has K={K} but qweight has {Kw} rows")
    return K, N, check_groups(scales, zeros, N, K)


def quant_matmul_int8(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (K, N) int8 or uint8, scales/zeros (G, N) f32)``,
    returned in ``x.dtype``; the levels are signed when ``qweight`` is int8.

    CPU tensors run `quant_matmul_int8_ref`. CUDA tensors launch the kernel (bf16 x,
    contiguous f32 scales and zeros on x's device) or raise.
    """
    K, N, G = _check8(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int8_ref(x, qweight, scales, zeros)
    x2, out, lead = prepare_launch("int8", x, N, qweight=qweight, scales=scales, zeros=zeros)
    M = x2.shape[0]
    if M == 0:
        return out.reshape(*lead, N)
    dev = x.device
    signed = int(qweight.dtype == torch.int8)
    lib = _build.load("quant_matmul_int8", _bind8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            ksplit, units, ws = gemv_split(dev, M, N, -(-K // 4), _GEMV_MIN_ROWS // 4)
            status = lib.lljt_qmm8_gemv(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), (out if ws is None else ws).data_ptr(),
                M, K, N, G, signed, ksplit, units, stream,
            )
        else:
            plan = launch_gemm_plan(dev, x2, N, [qweight], scales, zeros)
            status = lib.lljt_qmm8_gemm(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, N, G, signed, *plan, stream,
            )
    quant_matmul_int8.launches += 1
    _build.check(lib, status, "quant_matmul_int8")
    return out.reshape(*lead, N)


quant_matmul_int8.launches = 0


def _bind4(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm4_gemv", 6, [i, i, i, i, i, i])
    _build.bind(lib, "lljt_qmm4_gemm", 5, [i] * 8)


def _bind8(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm8_gemv", 6, [i] * 7)
    _build.bind(lib, "lljt_qmm8_gemm", 5, [i] * 9)
