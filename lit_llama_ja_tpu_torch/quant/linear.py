"""Quantized linear parameterization (counterpart of `lit_llama_ja_tpu/quant/linear.py`).

Layout is the JAX package's (in, out) = (K, N) convention, byte for byte, so a
quantized tree moves between the packages without repacking:
  * INT8: ``qweight`` int8 (symmetric absmax, zeros 0) or uint8 (asymmetric levels)
    ``(K, N)``.
  * INT4: ``qweight`` uint8 ``(K // 2, N)`` — byte ``r`` packs K-rows ``2r`` (low
    nibble, stored plain) and ``2r+1`` (high nibble, stored ``(q - 8) & 0xF``).
  * INT2: ``qweight`` uint8 ``(Kp // 4, N)``, ``Kp = sub4_pad_rows(K, groupsize)`` —
    byte ``r`` holds K-rows ``4r+j`` at bits ``2j``; field 3 is stored
    ``(q - 2) & 0x3``. Rows K..Kp-1 hold level 0.
  * INT3: the low two bits as an INT2 ``qweight`` plus ``qweight_hi`` uint8
    ``(Kp // 8, N)``, bit ``i`` of byte ``r`` the high bit of K-row ``8r+i``.
  * ``scales`` / ``zeros``: ``(n_tiles, N)`` float; dequant ``w = (q - zero) * scale``
    with tile row ``k // ceil(Kp / n_tiles)`` for K-row ``k``, Kp the stored row count
    (`_expand_tiles`). Where K is not a multiple of the quantization group, int4 and
    int8 packs therefore read some rows with the next group's scale, as the JAX
    package does (ROADMAP.md, queue 3).
  * LLM.int8 leaves add ``outlier_idx`` / ``outlier_w`` (static bf16 outlier rows)
    or ``dyn_threshold`` / ``dyn_budget`` (per-forward activation outliers).

On CUDA tensors `quant_matmul` launches the hand-written dequant-matmul kernel of the
pack's width (`ops/cuda/quant_matmul.py`: int4 K1, int8 K3;
`ops/cuda/quant_matmul_sub4.py`: int2 K4, int3 K5) or raises; the outlier terms are
plain PyTorch around the kernel, as the JAX package leaves them to XLA. On CPU
tensors each wrapper runs its plain version, the exact dequant-and-matmul.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import torch

from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import quant_matmul_int4, quant_matmul_int8
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul_sub4 import quant_matmul_int2, quant_matmul_int3

Params = Dict[str, torch.Tensor]

_MIX_RE = re.compile(r"^(gptq|rtn)\.mix-a([2348])m([2348])h([2348])$")


# ---------------------------------------------------------------------------
# Mode grammar
# ---------------------------------------------------------------------------

def parse_quant_mode(mode: str):
    """Parse a CLI quantization mode into ``(scheme, bits, groupsize)``.

    ``{gptq|rtn}.int{2,3,4,8}[-g<N>]``; ``llm.int8``, ``llm.int8-rtn`` and
    ``llm.int8-dyn``; and the mixed grammar ``{gptq|rtn}.mix[-a<B>m<B>h<B>][-g<N>]``,
    whose bits are a dict over "attn", "mlp" and "head" (bare ``.mix`` is
    ``a4m2h4-g64``). A mix whose three widths are equal collapses to the uniform int.
    """
    if mode in ("llm.int8", "llm.int8-rtn", "llm.int8-dyn"):
        return mode, 8, -1
    groupsize = -1
    body = mode
    if "-g" in mode:
        body, g = mode.rsplit("-g", 1)
        groupsize = int(g)
    if body.endswith(".mix"):
        body += "-a4m2h4"
        if groupsize == -1:
            groupsize = 64
    m = _MIX_RE.match(body)
    if m:
        scheme = m.group(1)
        bits = {"attn": int(m.group(2)), "mlp": int(m.group(3)), "head": int(m.group(4))}
        if all(b == next(iter(bits.values())) for b in bits.values()):
            bits = next(iter(bits.values()))  # degenerate mix == uniform
        return scheme, bits, groupsize
    try:
        scheme, ib = body.split(".")
        bits = int(ib.removeprefix("int"))
        assert scheme in ("gptq", "rtn") and bits in (2, 3, 4, 8)
    except (ValueError, AssertionError):
        raise ValueError(
            f"unknown quantization mode {mode!r} (expected "
            "{gptq|rtn}.int{2,3,4,8}[-g<N>], {gptq|rtn}.mix[-a<B>m<B>h<B>][-g<N>], "
            "llm.int8, llm.int8-rtn, or llm.int8-dyn)"
        ) from None
    return scheme, bits, groupsize


def resolve_bits(bits, name: str) -> int:
    """Bit width of one projection: ``bits`` is an int or the mixed-mode dict;
    ``name`` is a pipeline submodule ("attn.c_attn", "mlp.c_fc1", ...) or "lm_head"."""
    if isinstance(bits, int):
        return bits
    key = "head" if name == "lm_head" else name.split(".", 1)[0]
    return bits[key]


def resolve_groupsize(bits, name: str, groupsize: int) -> int:
    """Mixed mode: the groupsize applies to the sub-4-bit projections only. A mix of
    equal widths has collapsed to a uniform int in `parse_quant_mode` and so groups
    every projection (``gptq.mix-a4m4h4-g64``): the JAX package's quirk, kept for
    parity (ROADMAP.md, queue 3)."""
    if isinstance(bits, int):
        return groupsize
    return groupsize if resolve_bits(bits, name) < 4 else -1


def mixed_mode_tag(bits) -> str:
    """Filesystem tag of a bits spec: 4 -> "4bit", a mix dict -> "mix-a4m2h4"."""
    if isinstance(bits, int):
        return f"{bits}bit"
    return f"mix-a{bits['attn']}m{bits['mlp']}h{bits['head']}"


# ---------------------------------------------------------------------------
# Bit-width inference
# ---------------------------------------------------------------------------

def sub4_pad_rows(K: int, groupsize: int = -1) -> int:
    """Stored K of the sub-4-bit packs: a multiple of 8 (1024 for K >= 2048), and
    with groups a multiple of the groupsize too, so groups tile the stored rows."""
    quantum = 1024 if K >= 2048 else 8
    if groupsize and groupsize > 0:
        quantum = math.lcm(quantum, groupsize)
    return (K + quantum - 1) // quantum * quantum


def _is_sub4_rows(rows: int, in_features: int) -> bool:
    """rows·4 covers a plausibly-padded K: [default pad, +one group quantum)."""
    return sub4_pad_rows(in_features) <= rows * 4 < in_features + 2048


def infer_bits(qweight: torch.Tensor, in_features: int) -> int:
    # exact matches first — the sub-4-bit row range is checked last so a
    # small-K int4 pack can never be mistaken for a padded int2 one
    if qweight.shape[-2] == in_features:
        return 8
    if qweight.shape[-2] * 2 == in_features:
        return 4
    if _is_sub4_rows(qweight.shape[-2], in_features):
        return 2
    raise ValueError(
        f"qweight rows {qweight.shape[-2]} incompatible with in_features {in_features}"
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


def _pad_rows_to(q: torch.Tensor, rows: int) -> torch.Tensor:
    if q.shape[0] == rows:
        return q
    return torch.cat([q, q.new_zeros((rows - q.shape[0], *q.shape[1:]))])


def pack_int2(q: torch.Tensor) -> torch.Tensor:
    """Pack unsigned 2-bit levels ``(K, N)`` -> uint8 ``(sub4_pad_rows(K)//4, N)``:
    byte ``r`` holds K-rows ``4r+j`` at bits ``2j``, field 3 stored ``(q - 2) & 0x3``."""
    q = _pad_rows_to(q.to(torch.uint8), sub4_pad_rows(q.shape[0]))
    f3 = (q[3::4] - 2) & 0x3
    return q[0::4] | (q[1::4] << 2) | (q[2::4] << 4) | (f3 << 6)


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., K//4, N)`` -> unsigned levels ``(..., K, N)`` uint8."""
    f0 = packed & 0x3
    f1 = (packed >> 2) & 0x3
    f2 = (packed >> 4) & 0x3
    f3 = ((packed >> 6) + 2) & 0x3
    K4, N = packed.shape[-2:]
    lead = packed.shape[:-2]
    return torch.stack([f0, f1, f2, f3], dim=-2).reshape(*lead, K4 * 4, N)


def pack_int3(q: torch.Tensor) -> Params:
    """Pack unsigned 3-bit levels ``(K, N)`` as ``q = q2 + 4·hi``: ``qweight`` the
    low two bits int2-packed, ``qweight_hi`` the high bit as a bit plane
    ``(Kp//8, N)`` (bit ``i`` of byte ``r`` is K-row ``8r+i``)."""
    q = _pad_rows_to(q.to(torch.uint8), sub4_pad_rows(q.shape[0]))
    hi = q >> 2
    hi_packed = hi[0::8].clone()
    for i in range(1, 8):
        hi_packed |= hi[i::8] << i
    return {"qweight": pack_int2(q & 0x3), "qweight_hi": hi_packed}


def unpack_int3(packed: torch.Tensor, packed_hi: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int3` -> unsigned levels ``(..., K, N)`` uint8."""
    q2 = unpack_int2(packed)
    K8, N = packed_hi.shape[-2:]
    lead = packed_hi.shape[:-2]
    bits = torch.stack([(packed_hi >> i) & 1 for i in range(8)], dim=-2)
    return q2 + (bits.reshape(*lead, K8 * 8, N) << 2)


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------

def quantize_int8_absmax(w: torch.Tensor) -> Params:
    """Symmetric per-output-channel absmax INT8 over the K axis (``-2``; a leading
    layer axis passes through): {qweight int8, scales (.., 1, N), zeros 0}."""
    absmax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, absmax / 127.0).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"qweight": q, "scales": scale, "zeros": torch.zeros_like(scale)}


def _top_k_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of the 1-D ``v``, ties to the lower index (the
    order of ``jax.lax.top_k``)."""
    return torch.sort(v, descending=True, stable=True).indices[:k]


def quantize_int8_outlier(w: torch.Tensor, outlier_frac: float = 0.005) -> Params:
    """LLM.int8 with a static, weight-derived outlier set: the ~0.5% input rows that
    come closest to setting some output channel's absmax stay in bf16 (``outlier_w``
    at ``outlier_idx``) and are zeroed in the int8 bulk, which then quantizes
    against smaller scales. ``w``: ``(K, N)``."""
    K = w.shape[0]
    n_out = max(1, int(round(outlier_frac * K)))
    absw = torch.abs(w)
    col_absmax = torch.clamp(absw.amax(dim=0, keepdim=True), min=1e-12)
    score = (absw / col_absmax).amax(dim=1)
    idx = _top_k_indices(score, n_out).to(torch.int32)
    outlier_w = w[idx.long()].to(torch.bfloat16)
    bulk = w.clone()
    bulk[idx.long()] = 0.0
    out = quantize_int8_absmax(bulk)
    out["outlier_idx"] = idx
    out["outlier_w"] = outlier_w
    return out


def quantize_int8_dynamic(
    w: torch.Tensor, threshold: float = 6.0, max_outlier_frac: float = 0.01
) -> Params:
    """Plain absmax int8 weights plus the bitsandbytes ``Linear8bitLt`` activation-
    outlier metadata: per forward, up to ``max_outlier_frac·K`` input columns whose
    peak |x| exceeds ``threshold`` run in 16 bits against dequantized weight rows.
    ``dyn_budget`` carries the budget in its length."""
    out = quantize_int8_absmax(w)
    out["dyn_threshold"] = torch.tensor(threshold, dtype=torch.float32, device=w.device)
    out["dyn_budget"] = torch.zeros(
        (max(1, int(round(max_outlier_frac * w.shape[-2]))),), dtype=torch.int8,
        device=w.device,
    )
    return out


def _dynamic_outlier_split(x2: torch.Tensor, threshold, k_out: int):
    """Per-forward bnb-style split of ``x2 (M, K)``: (x with the live outlier
    columns zeroed, the ``k_out`` candidate column ids, their live gate)."""
    peak = torch.amax(torch.abs(x2.float()), dim=0)
    idx = _top_k_indices(peak, k_out)
    live = (peak[idx] > threshold).to(x2.dtype)
    keep = torch.ones((x2.shape[-1],), dtype=x2.dtype, device=x2.device)
    keep[idx] = 1.0 - live
    return x2 * keep[None, :], idx, live


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
    """Round-to-nearest col-block quantization of ``(K, N)`` weights at 2, 3, 4 or 8
    bits, scales per ``tile_cols`` K-rows (-1: one tile). The sub-4-bit formats pad
    K first, so their tiles cover the stored rows."""
    K = w.shape[0]
    if bits in (2, 3):
        w = _pad_rows_to(w, sub4_pad_rows(K, tile_cols))
        K = w.shape[0]
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
    q_levels: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int,
    groupsize: int = -1,
) -> Params:
    """Pack already-chosen levels ``(K, N)`` (e.g. from the GPTQ solver). Grouped
    sub-4-bit packs pad K to whole groups and append scale rows of 1 and zero rows
    of 0 for the added groups."""
    if bits in (2, 3):
        Kp = sub4_pad_rows(q_levels.shape[0], groupsize)
        q_levels = _pad_rows_to(q_levels, Kp)
        if groupsize and groupsize > 0:
            extra = Kp // groupsize - scales.shape[0]
            if extra < 0:
                raise ValueError(f"{scales.shape[0]} scale rows exceed {Kp // groupsize} "
                                 f"groups of {groupsize} over {Kp} rows")
            if extra:
                scales = torch.cat([scales, scales.new_ones((extra, scales.shape[1]))])
                zeros = torch.cat([zeros, zeros.new_zeros((extra, zeros.shape[1]))])
    out = {"scales": scales, "zeros": zeros}
    if bits == 4:
        out["qweight"] = pack_int4(q_levels)
    elif bits == 3:
        out.update(pack_int3(q_levels))
    elif bits == 2:
        out["qweight"] = pack_int2(q_levels)
    else:
        out["qweight"] = q_levels.to(torch.uint8)
    return out


def _expand_tiles(t: torch.Tensor, K: int) -> torch.Tensor:
    """Expand (n_tiles, N) per-tile values to (K, N) by repeating each tile row."""
    n_tiles = t.shape[-2]
    tile = -(-K // n_tiles)
    reps = torch.repeat_interleave(t, tile, dim=-2)
    return reps[..., :K, :]


def unpack_levels(params: Params, in_features: int) -> torch.Tensor:
    """The stored levels of any pack as f32 ``(..., Kp, N)`` (Kp: stored rows)."""
    bits = infer_bits_params(params, in_features)
    qweight = params["qweight"]
    if bits == 4:
        return unpack_int4(qweight).float()
    if bits == 3:
        return unpack_int3(qweight, params["qweight_hi"]).float()
    if bits == 2:
        return unpack_int2(qweight).float()
    return qweight.float()


def dequantize_with_k(
    params: Params, in_features: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Reconstruct ``(K, N)`` float weights; ``in_features`` disambiguates packing.
    Static outlier rows (``outlier_w``, one layer's leaves) replace their rows."""
    levels = unpack_levels(params, in_features)
    Kp = levels.shape[-2]  # the padded K for the sub-4-bit formats
    w = (levels - _expand_tiles(params["zeros"], Kp)) * _expand_tiles(params["scales"], Kp)
    w = w[..., :in_features, :]
    if "outlier_w" in params:
        w[params["outlier_idx"].long()] = params["outlier_w"].to(w.dtype)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Matmul
# ---------------------------------------------------------------------------

def _kernel_matmul(x: torch.Tensor, params: Params, bits: int) -> torch.Tensor:
    qw, s, z = params["qweight"], params["scales"], params["zeros"]
    if bits == 4:
        return quant_matmul_int4(x, qw, s, z)
    if bits == 3:
        return quant_matmul_int3(x, qw, params["qweight_hi"], s, z)
    if bits == 2:
        return quant_matmul_int2(x, qw, s, z)
    return quant_matmul_int8(x, qw, s, z)


def quant_matmul(x: torch.Tensor, params: Params) -> torch.Tensor:
    """``x @ dequant(params)`` for every pack format.

    The bulk product goes to the kernel wrapper of the pack's width: on CUDA tensors
    the hand-written kernel, on CPU tensors its plain version. LLM.int8's static
    outlier rows add ``x[..., idx] @ outlier_w`` (their bulk rows are zero); the
    activation-dynamic mode zeroes the live outlier columns of x before the kernel
    and adds them back against dequantized weight rows.
    """
    K = x.shape[-1]
    if "dyn_threshold" in params:
        x2 = x.reshape(-1, K)
        bulk, idx, live = _dynamic_outlier_split(
            x2, params["dyn_threshold"], params["dyn_budget"].shape[0]
        )
        y = quant_matmul_int8(bulk, params["qweight"], params["scales"], params["zeros"])
        w_rows = params["qweight"][idx].to(x.dtype) * params["scales"][0][None, :].to(x.dtype)
        y = y + (x2[:, idx] * live[None, :]) @ w_rows
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = _kernel_matmul(x, params, infer_bits_params(params, K))
    if "outlier_w" in params:
        y = y + x[..., params["outlier_idx"].long()] @ params["outlier_w"].to(x.dtype)
    return y
