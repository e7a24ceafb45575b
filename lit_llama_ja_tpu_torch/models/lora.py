"""LoRA as a parameter-tree transform (counterpart of `lit_llama_ja_tpu/models/lora.py`;
reference `lit_llama/lora.py`).

LoRA is data, not a class: `add_lora` puts ``lora_A`` / ``lora_B`` / ``lora_alpha``
leaves into the fused qkv linear's leaf dict, and `models/llama.apply_linear` adds the
low-rank branch wherever it finds them. `merge_lora` folds the update into the base
weight and returns a new tree.

``enable_lora=(True, False, True)`` (q and v only, reference `lora.py:434`) maps to the
JAX package's grouped layout, so a LoRA ``.npz`` moves between the two packages as it
is: ``lora_A (L, D, g*r)``, ``lora_B (L, g, r, D)``, ``lora_alpha (L,)``, with the g
group outputs scattered into the q and v sections of the fused (3D)-wide output.

Shape glossary: L layers, D = n_embd, r rank, g = sum(enable_lora).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device

ENABLE_LORA_DEFAULT = (True, False, True)  # q, k, v (reference lora.py:434)
LORA_KEYS = ("lora_A", "lora_B", "lora_alpha")


def init_lora_params(
    generator: torch.Generator,
    config: LLaMAConfig,
    r: int,
    alpha: float = 1.0,
    enable_lora: Sequence[bool] = ENABLE_LORA_DEFAULT,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """LoRA leaves for the fused qkv projection of every layer: A uniform in
    ``±1/sqrt(D)`` (kaiming_uniform(a=sqrt(5)), reference `lora.py:199-201`) from
    ``generator``, B zero so that training starts at the pretrained function, alpha
    stacked per layer."""
    dev = resolve_device(device)
    L, D = config.n_layer, config.n_embd
    g = sum(enable_lora)
    bound = 1.0 / math.sqrt(D)
    u = torch.rand((L, D, g * r), generator=generator, device=generator.device)
    return {
        "lora_A": ((u * 2 - 1) * bound).to(device=dev, dtype=dtype),
        "lora_B": torch.zeros((L, g, r, D), dtype=dtype, device=dev),
        "lora_alpha": torch.full((L,), float(alpha), dtype=torch.float32, device=dev),
    }


def _scatter_groups(per_group: torch.Tensor, enable_lora: Sequence[bool]) -> torch.Tensor:
    """``(..., g, out)`` -> ``(..., len(enable_lora) * out)``: each enabled section takes
    the next group, the others zeros (the reference's ``zero_pad``)."""
    sections, gi = [], 0
    for enabled in enable_lora:
        if enabled:
            sections.append(per_group[..., gi, :])
            gi += 1
        else:
            sections.append(torch.zeros_like(per_group[..., 0, :]))
    return torch.cat(sections, dim=-1)


# The dropout mask is a function of a seed and of each element's index, so that a step
# captured in a CUDA graph draws a new mask at every replay from a seed staged into a
# device buffer (`train/step.py`), and a recomputed block (``remat``) draws it again bit
# for bit. `mix32` is a 32-bit integer hash (two xorshift-multiply rounds; multipliers
# below 2**31, so that a product of a 32-bit value stays inside int64 on every device).
_M32 = 0xFFFFFFFF
_MIX = ((16, 0x21F0AAAD), (15, 0x735A2D97))


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective hash of int64 values in [0, 2**32), into [0, 2**32)."""
    for shift, mult in _MIX:
        x = ((x ^ (x >> shift)) * mult) & _M32
    return x ^ (x >> 15)


def dropout_keep(seed: torch.Tensor, shape, rate: float,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The keep mask of dropout at ``rate`` over ``shape``, drawn from ``seed`` (an int64
    tensor, 0-d, on the device the mask is made on): element ``i`` (row-major) is kept
    when ``mix32((i ^ k2) + k1) < (1 - rate) * 2**32``, with ``k1`` and ``k2`` mixed from
    the seed's two halves. ``rows``: ``(start, total)``, the mask of rows ``[start, start
    + shape[0])`` of a ``total``-row batch, equal to that part of the whole batch's."""
    inner = 1
    for n in shape[1:]:
        inner *= n
    start = 0 if rows is None else rows[0] * inner
    idx = torch.arange(start, start + shape[0] * inner, device=seed.device).view(shape)
    k1 = mix32(seed & _M32)
    k2 = mix32(((seed >> 32) ^ k1) & _M32)
    h = mix32(((idx ^ k2) + k1) & _M32)
    return h < round((1.0 - rate) * 2**32)


def lora_branch(
    leaf: Dict[str, torch.Tensor],
    x: torch.Tensor,
    enable_lora: Sequence[bool] = ENABLE_LORA_DEFAULT,
    dropout_seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Low-rank update ``zero_pad(grouped(dropout(x) @ A) @ B) * alpha / r``
    (reference `lora.py:280-324`), in the dtype of ``x``.

    The dropout's mask comes from ``dropout_seed`` (`dropout_keep`, on ``x``'s device);
    no dropout without one. ``rows``: ``(start, total)`` when ``x`` is rows ``[start, start + len(x))`` of a
    batch of ``total`` rows split over ranks (`parallel/sharded.py`): the mask is that
    part of the whole batch's, so it is the mask one device draws."""
    A, B = leaf["lora_A"], leaf["lora_B"]
    g, r, _ = B.shape
    scaling = leaf["lora_alpha"] / r
    xin = x
    if dropout_seed is not None and dropout_rate > 0.0:
        keep = dropout_keep(dropout_seed.to(x.device), x.shape, dropout_rate, rows)
        xin = torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))
    after_a = xin @ A.to(x.dtype)  # (..., g*r)
    after_a = after_a.reshape(*after_a.shape[:-1], g, r)
    after_b = torch.einsum("...gr,gro->...go", after_a, B.to(x.dtype))
    return _scatter_groups(after_b, enable_lora) * scaling.to(x.dtype)


def draw_seeds(generator: torch.Generator, shape) -> torch.Tensor:
    """Dropout seeds of ``shape``, int64 in [0, 2**62), drawn from ``generator`` on its
    device: the counterpart of ``jax.random.split``."""
    return torch.randint(0, 2**62, shape, generator=generator, device=generator.device)


def _with_c_attn(params: Dict[str, Any], c_attn: Dict[str, Any]) -> Dict[str, Any]:
    """A shallow copy of ``params`` whose ``blocks/attn/c_attn`` is ``c_attn``; the
    leaves are shared, not copied."""
    return {**params, "blocks": {**params["blocks"],
                                 "attn": {**params["blocks"]["attn"], "c_attn": c_attn}}}


def add_lora(params: Dict[str, Any], lora_params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A new tree with the LoRA leaves inside ``blocks/attn/c_attn``."""
    return _with_c_attn(params, {**params["blocks"]["attn"]["c_attn"], **lora_params})


def extract_lora(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The LoRA-only state (reference `lora_state_dict`, `lora.py:362-393`)."""
    c_attn = params["blocks"]["attn"]["c_attn"]
    return {k: c_attn[k] for k in LORA_KEYS}


def strip_lora(params: Dict[str, Any]) -> Dict[str, Any]:
    c_attn = params["blocks"]["attn"]["c_attn"]
    return _with_c_attn(params, {k: v for k, v in c_attn.items() if not k.startswith("lora_")})


def _delta_w(lora_params, enable_lora):
    """The stacked update ``(L, D, 3D)`` of the fused qkv weight."""
    A, B = lora_params["lora_A"], lora_params["lora_B"]
    g, r, _ = B.shape[-3:]
    scaling = (lora_params["lora_alpha"] / r).reshape(-1, 1, 1, 1)
    a_g = A.reshape(*A.shape[:-1], g, r)  # (L, D, g, r)
    delta = torch.einsum("ldgr,lgro->ldgo", a_g, B) * scaling
    return _scatter_groups(delta, enable_lora)  # (L, D, 3D)


def merge_lora(
    params: Dict[str, Any], enable_lora: Sequence[bool] = ENABLE_LORA_DEFAULT
) -> Dict[str, Any]:
    """Fold the LoRA update into the base qkv weight and drop the LoRA leaves (the
    eval-mode merge, reference `lora.py:268-278`; the basis of
    `cli/convert_cli.convert_lora_weights`).

    Raises ``KeyError`` on a quantized ``c_attn``: it has no plain ``weight`` to fold
    into, as in the JAX package (ROADMAP.md, queue 3)."""
    c_attn = params["blocks"]["attn"]["c_attn"]
    if "weight" not in c_attn:
        raise KeyError(
            "'weight': merge_lora folds the LoRA update into the plain weight of "
            f"blocks/attn/c_attn, and this c_attn has none (leaves {sorted(c_attn)}; a "
            "quantized base cannot be merged)"
        )
    w = c_attn["weight"]
    delta = _delta_w(extract_lora(params), enable_lora).to(w.dtype)
    merged = strip_lora(params)
    return _with_c_attn(merged, {**merged["blocks"]["attn"]["c_attn"], "weight": w + delta})


def lora_trainable(path: str) -> bool:
    """Trainability predicate (reference `mark_only_lora_as_trainable`,
    `lora.py:327-359`, bias='none': the model has no biases)."""
    return "lora_A" in path or "lora_B" in path
