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


def lora_branch(
    leaf: Dict[str, torch.Tensor],
    x: torch.Tensor,
    enable_lora: Sequence[bool] = ENABLE_LORA_DEFAULT,
    dropout_generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Low-rank update ``zero_pad(grouped(dropout(x) @ A) @ B) * alpha / r``
    (reference `lora.py:280-324`), in the dtype of ``x``.

    ``rows``: ``(start, total)`` when ``x`` is rows ``[start, start + len(x))`` of a
    batch of ``total`` rows split over ranks (`parallel/sharded.py`): the dropout mask
    is drawn for the whole batch and cut, so it is the mask one device draws."""
    A, B = leaf["lora_A"], leaf["lora_B"]
    g, r, _ = B.shape
    scaling = leaf["lora_alpha"] / r
    xin = x
    if dropout_generator is not None and dropout_rate > 0.0:
        shape = x.shape if rows is None else (rows[1], *x.shape[1:])
        u = torch.rand(shape, generator=dropout_generator, device=dropout_generator.device)
        if rows is not None:
            u = u.narrow(0, rows[0], x.shape[0])
        keep = (u < 1.0 - dropout_rate).to(x.device)
        xin = torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))
    after_a = xin @ A.to(x.dtype)  # (..., g*r)
    after_a = after_a.reshape(*after_a.shape[:-1], g, r)
    after_b = torch.einsum("...gr,gro->...go", after_a, B.to(x.dtype))
    return _scatter_groups(after_b, enable_lora) * scaling.to(x.dtype)


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
