"""Quantized linear parameterization, int4 part (counterpart of
`lit_llama_ja_tpu/quant/linear.py`).

Layout is the JAX package's (in, out) = (K, N) convention, byte for byte, so a
quantized tree moves between the packages without repacking:
  * INT4: ``qweight`` uint8 ``(K // 2, N)`` — byte ``r`` packs K-rows ``2r`` (low
    nibble, stored plain) and ``2r+1`` (high nibble, stored ``(q - 8) & 0xF``).
  * ``scales`` / ``zeros``: ``(n_tiles, N)`` float; dequant ``w = (q - zero) * scale``
    with tile row ``k // ceil(K / n_tiles)`` for K-row ``k``.

On CUDA tensors `quant_matmul` launches the hand-written int4 kernel
(`ops/cuda/quant_matmul.quant_matmul_int4`); on CPU tensors it runs the exact
dequant-and-matmul. The int8, int2/int3, outlier and activation-dynamic formats
are not ported yet (ROADMAP.md, queue 1 slice 4 and queue 2 K3-K5) and raise.
"""
from __future__ import annotations

from typing import Dict

import torch

from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import quant_matmul_int4

Params = Dict[str, torch.Tensor]

_NOT_PORTED = (
    "is not ported to the PyTorch package yet; see ROADMAP.md "
    "(queue 1 slice 4, queue 2 K3-K5)"
)


def _is_sub4_rows(rows: int, in_features: int) -> bool:
    """rows·4 covers a plausibly-padded K: [default pad, +one group quantum)."""
    quantum = 1024 if in_features >= 2048 else 8
    padded = (in_features + quantum - 1) // quantum * quantum
    return padded <= rows * 4 < in_features + 2048


def infer_bits(qweight: torch.Tensor, in_features: int) -> int:
    # exact matches first — the sub-4-bit row range is checked last so a
    # small-K int4 pack can never be mistaken for a padded int2 one
    if qweight.shape[0] == in_features:
        return 8
    if qweight.shape[0] * 2 == in_features:
        return 4
    if _is_sub4_rows(qweight.shape[0], in_features):
        return 2
    raise ValueError(
        f"qweight rows {qweight.shape[0]} incompatible with in_features {in_features}"
    )


def infer_bits_params(params: Params, in_features: int) -> int:
    """Bit width of a quantized-linear leaf dict. int3 shares the int2 packed
    shape for its low bits and is distinguished by the ``qweight_hi`` plane."""
    if "qweight_hi" in params:
        if not _is_sub4_rows(params["qweight"].shape[-2], in_features):
            raise ValueError("qweight_hi present but qweight rows are not a sub-4-bit pack")
        return 3
    return infer_bits(params["qweight"], in_features)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

# Byte-layout tag of the int4 pack, the same as the JAX package's.
INT4_PACK_VERSION = "hi-biased-v2"


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack unsigned 4-bit levels ``(K, N)`` -> uint8 ``(K//2, N)``: the low nibble
    stores the even row plain, the high nibble the odd row as ``(q - 8) & 0xF``."""
    q = q.to(torch.uint8)
    lo = q[0::2]
    hi = (q[1::2] - 8) & 0xF
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., K//2, N)`` -> unsigned levels ``(..., K, N)`` uint8 (inverse of
    `pack_int4`; leading batch dims, e.g. a stacked layer axis, pass through)."""
    lo = packed & 0xF
    hi = ((packed >> 4) + 8) & 0xF
    K2, N = packed.shape[-2:]
    lead = packed.shape[:-2]
    return torch.stack([lo, hi], dim=-2).reshape(*lead, K2 * 2, N)


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------

def find_qparams(w: torch.Tensor, bits: int, sym: bool = False):
    """Per-output-channel (axis=-1 of (K, N)) scale/zero over the K axis: min
    clipped to <=0, max to >=0; all-zero channels get [-1, 1]; the asymmetric zero
    is ``round(-xmin / scale)``. Returns (scale, zero) of shape ``(1, N)``."""
    maxq = 2**bits - 1
    xmin = torch.clamp(w.amin(dim=0), max=0.0)
    xmax = torch.clamp(w.amax(dim=0), min=0.0)
    if sym:
        xmax = torch.maximum(torch.abs(xmin), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = (xmax - xmin) / maxq
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return scale[None, :].float(), zero[None, :].float()


def quantize_colblock(
    w: torch.Tensor, bits: int, tile_cols: int = -1, sym: bool = False
) -> Params:
    """Round-to-nearest col-block quantization of ``(K, N)`` weights (4 bits only)."""
    if bits != 4:
        raise NotImplementedError(f"{bits}-bit col-block quantization {_NOT_PORTED}")
    K, N = w.shape
    tile = K if tile_cols == -1 else tile_cols
    n_tiles = (K + tile - 1) // tile
    scales, zeros, qs = [], [], []
    for t in range(n_tiles):
        chunk = w[t * tile : (t + 1) * tile]
        s, z = find_qparams(chunk, bits, sym)
        q = torch.clamp(torch.round(chunk / s + z), 0, 2**bits - 1)
        scales.append(s)
        zeros.append(z)
        qs.append(q)
    return pack_prequantized(
        torch.cat(qs, dim=0), torch.cat(scales, dim=0), torch.cat(zeros, dim=0), bits
    )


def pack_prequantized(
    q_levels: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int
) -> Params:
    """Pack already-chosen levels (e.g. from the GPTQ solver); q_levels: (K, N)."""
    if bits != 4:
        raise NotImplementedError(f"{bits}-bit packing {_NOT_PORTED}")
    return {"scales": scales, "zeros": zeros, "qweight": pack_int4(q_levels)}


def _expand_tiles(t: torch.Tensor, K: int) -> torch.Tensor:
    """Expand (n_tiles, N) per-tile values to (K, N) by repeating each tile row."""
    n_tiles = t.shape[-2]
    tile = -(-K // n_tiles)
    reps = torch.repeat_interleave(t, tile, dim=-2)
    return reps[..., :K, :]


def dequantize_with_k(
    params: Params, in_features: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Reconstruct ``(K, N)`` float weights; ``in_features`` disambiguates packing."""
    bits = infer_bits_params(params, in_features)
    if bits != 4 or "outlier_w" in params:
        raise NotImplementedError(f"dequantizing a {bits}-bit pack {_NOT_PORTED}")
    levels = unpack_int4(params["qweight"]).float()
    K = levels.shape[-2]
    w = (levels - _expand_tiles(params["zeros"], K)) * _expand_tiles(params["scales"], K)
    return w[..., :in_features, :].to(dtype)


# ---------------------------------------------------------------------------
# Matmul
# ---------------------------------------------------------------------------

def quant_matmul(x: torch.Tensor, params: Params) -> torch.Tensor:
    """``x @ dequant(params)`` for an int4 pack.

    CUDA tensors go through the hand-written int4 dequant-matmul kernel; CPU
    tensors through its plain version (exact dequant, then matmul).
    """
    K = x.shape[-1]
    if "dyn_threshold" in params or "outlier_w" in params:
        raise NotImplementedError(f"LLM.int8 outlier handling {_NOT_PORTED}")
    bits = infer_bits_params(params, K)
    if bits != 4:
        raise NotImplementedError(f"{bits}-bit quant_matmul {_NOT_PORTED}")
    return quant_matmul_int4(x, params["qweight"], params["scales"], params["zeros"])
