"""Functional LLaMA decoder (counterpart of `lit_llama_ja_tpu/models/llama.py`).

The parameter tree is the JAX package's, leaf for leaf, so one numpy tree feeds both
(`io/from_jax.params_from_numpy`). Blocks are stacked on a leading layer axis and
weights are ``(in_features, out_features)``:

    {"wte":     {"weight": (V, D)},
     "lm_head": {"weight": (D, V)},
     "ln_f":    {"scale": (D,)},
     "blocks": {
        "rms_1": {"scale": (L, D)},
        "attn":  {"c_attn": {"weight": (L, D, 3D)}, "c_proj": {"weight": (L, D, D)}},
        "rms_2": {"scale": (L, D)},
        "mlp":   {"c_fc1": {"weight": (L, D, H)}, "c_fc2": {"weight": (L, D, H)},
                  "c_proj": {"weight": (L, H, D)}}}}

A quantized linear replaces ``{"weight"}`` by ``{"qweight", "scales", "zeros"}``.

Where the JAX package scans over the layer axis, the port loops over layers in
Python; where it branches with ``lax.cond`` on the position (roll-left eviction),
the port branches on the host. The KV cache is updated IN PLACE: the tensors of the
cache passed to `forward_with_cache` are written and the same dict is returned.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.ops.attention import (
    causal_attention,
    decode_attention,
    decode_attention_quant,
    decode_attention_quant4,
    quantize_kv,
    quantize_kv4,
)
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.ops.rope import apply_rope, build_rope_cache
from lit_llama_ja_tpu_torch.quant.linear import quant_matmul

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]  # {"k": (L, B, nh, S, hd), "v": ...}


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(
    generator: torch.Generator,
    config: LLaMAConfig,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Params:
    """Initialize a parameter tree with the JAX package's shapes and std:
    N(0, 0.02 / sqrt(2 * n_layer)) for linears and the embedding, ones for the
    RMSNorm scales. The numbers come from ``generator`` and differ from JAX's."""
    dev = resolve_device(device)
    L, D, H, V = config.n_layer, config.n_embd, config.n_hidden, config.padded_vocab_size
    std = 0.02 / (2 * config.n_layer) ** 0.5

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * std).to(device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "wte": {"weight": normal(V, D)},
        "lm_head": {"weight": normal(D, V)},
        "ln_f": {"scale": ones(D)},
        "blocks": {
            "rms_1": {"scale": ones(L, D)},
            "attn": {
                "c_attn": {"weight": normal(L, D, 3 * D)},
                "c_proj": {"weight": normal(L, D, D)},
            },
            "rms_2": {"scale": ones(L, D)},
            "mlp": {
                "c_fc1": {"weight": normal(L, D, H)},
                "c_fc2": {"weight": normal(L, D, H)},
                "c_proj": {"weight": normal(L, H, D)},
            },
        },
    }


def normalize_kv_mode(value):
    """Normalize a user-facing KV-cache mode string to ``init_kv_cache``'s
    ``quantized`` argument: False | "int8" | "int4". Raises on anything else."""
    if value is None or value is False:
        return False
    if value is True:
        return "int8"
    v = str(value).lower()
    if v in ("none", "false", "fp", "bf16", ""):
        return False
    if v in ("int8", "int4"):
        return v
    raise ValueError(
        f"unknown KV-cache mode {value!r}; expected one of none|int8|int4"
    )


def init_kv_cache(
    config: LLaMAConfig,
    batch_size: int,
    max_seq_length: int,
    dtype: torch.dtype = torch.float32,
    quantized=False,
    device="cuda",
) -> KVCache:
    """KV cache: ``(L, B, n_head, max_seq_length, head_dim)`` zeros.

    ``quantized``: False | True/"int8" | "int4". INT8 stores per-slot absmax
    scales; INT4 packs adjacent head pairs into one byte plane per pair,
    ``(L, B, n_head/2, S, head_dim)`` uint8, the JAX package's layout.
    """
    dev = resolve_device(device)
    quantized = normalize_kv_mode(quantized)
    shape = (config.n_layer, batch_size, config.n_head, max_seq_length, config.head_dim)
    sshape = shape[:-1] + (1,)
    if quantized == "int4":
        pshape = (
            config.n_layer, batch_size, config.n_head // 2,
            max_seq_length, config.head_dim,
        )
        return {
            "k": torch.zeros(pshape, dtype=torch.uint8, device=dev),
            "v": torch.zeros(pshape, dtype=torch.uint8, device=dev),
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
        }
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def unstack_layers(tree: Any, n_layer: int) -> List[Any]:
    """Per-layer views ``[tree[0], ..., tree[L-1]]`` of a tree of stacked tensors.
    Views share storage, so writes to a layer's cache land in the stacked cache."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n_layer) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n_layer)]
    return [tree[i] for i in range(n_layer)]


# ---------------------------------------------------------------------------
# Linear application
# ---------------------------------------------------------------------------

def apply_linear(layer_params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` for a plain ({"weight"}) or quantized ({"qweight", "scales", "zeros"}
    plus the format's extra leaves: int8, int4, int3, int2, LLM.int8 outliers) linear;
    the width is read per leaf from its shapes (`quant/linear.py::quant_matmul`).
    LoRA and adapter-v2 leaves are not ported yet and raise."""
    if "lora_A" in layer_params or "adapter_bias" in layer_params:
        raise NotImplementedError(
            "LoRA / adapter linears are not ported to the PyTorch package yet; "
            "see ROADMAP.md (queue 1 slice 5)"
        )
    if "qweight" in layer_params:
        return quant_matmul(x, layer_params)
    return x @ layer_params["weight"].to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qkv(attn_params, x, n_head, rope):
    """Project to q, k, v heads and apply RoPE. Returns (B, nh, T, hd) views."""
    B, T, C = x.shape
    hd = C // n_head
    qkv = apply_linear(attn_params["c_attn"], x)
    q, k, v = qkv.split(C, dim=-1)
    q = apply_rope(q.reshape(B, T, n_head, hd), rope)
    k = apply_rope(k.reshape(B, T, n_head, hd), rope)
    v = v.reshape(B, T, n_head, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_block(
    attn_params: Params,
    x: torch.Tensor,
    rope: torch.Tensor,
    config: LLaMAConfig,
    kv_cache: Optional[KVCache] = None,
    input_pos: Optional[torch.Tensor] = None,
    prefill_attn: bool = False,
    span: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Causal self-attention.

    Without a cache: full-sequence causal attention. With a cache (this layer's
    tensors, updated in place): if the last position is past the cache, every cache
    tensor rolls one slot left and the write lands on the last slot (roll-left
    eviction); the T new k/v entries are written as one contiguous span; then the
    queries attend to the whole cache, or, with ``prefill_attn`` (a promise that
    this is a prefill from position 0 into an empty cache), causally to the
    in-flight k/v. ``span`` is ``(first, last)`` of ``input_pos`` as host ints;
    without it they are read from ``input_pos``.
    """
    B, T, C = x.shape
    q, k, v = _qkv(attn_params, x, config.n_head, rope)

    if kv_cache is None:
        y = causal_attention(q, k, v)
    else:
        cache = kv_cache
        quantized = "k_scale" in cache
        int4 = quantized and cache["k"].dtype == torch.uint8
        S = cache["k"].shape[2]
        first, last = span if span is not None else (int(input_pos[0]), int(input_pos[-1]))
        write_pos = input_pos
        if last >= S:
            for c in cache.values():
                c.copy_(torch.roll(c, -1, dims=2))
            write_pos = torch.full_like(input_pos, S - 1)
            first = S - 1

        if int4:
            kq, ks, vq, vs = quantize_kv4(k, v, head_axis=1)
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        elif quantized:
            kq, ks, vq, vs = quantize_kv(k, v)
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            writes = {"k": k, "v": v}

        # contiguous T-token write; the start clamps so the span fits, as
        # lax.dynamic_update_slice does
        start = min(max(first, 0), S - T)
        for key, val in writes.items():
            cache[key][:, :, start : start + T] = val

        if prefill_attn:
            y = causal_attention(q, k, v)
        elif int4:
            y = decode_attention_quant4(
                q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], write_pos
            )
        elif quantized:
            y = decode_attention_quant(
                q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], write_pos
            )
        else:
            y = decode_attention(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), write_pos
            )

    y = y.transpose(1, 2).reshape(B, T, C)
    return apply_linear(attn_params["c_proj"], y), kv_cache


def mlp_block(mlp_params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    h = F.silu(apply_linear(mlp_params["c_fc1"], x)) * apply_linear(mlp_params["c_fc2"], x)
    return apply_linear(mlp_params["c_proj"], h)


def transformer_block(
    block_params: Params,
    x: torch.Tensor,
    rope: torch.Tensor,
    config: LLaMAConfig,
    kv_cache=None,
    input_pos=None,
    prefill_attn=False,
    span=None,
):
    """Pre-norm residual block."""
    h, new_cache = attention_block(
        block_params["attn"],
        rmsnorm(x, block_params["rms_1"]["scale"], config.norm_eps),
        rope,
        config,
        kv_cache,
        input_pos,
        prefill_attn=prefill_attn,
        span=span,
    )
    x = x + h
    x = x + mlp_block(
        block_params["mlp"], rmsnorm(x, block_params["rms_2"]["scale"], config.norm_eps)
    )
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rope_table(block_size: int, head_dim: int, base: int, device: torch.device):
    return build_rope_cache(block_size, head_dim, base, device=device)


def _rope_for_positions(config: LLaMAConfig, input_pos: Optional[torch.Tensor], T: int,
                        device: torch.device):
    cache = _rope_table(config.block_size, config.head_dim, config.rope_base, device)
    if input_pos is None:
        return cache[:T]
    # positions past the table read its last row, as JAX's clamped gather does
    return cache[input_pos.clamp(max=config.block_size - 1)]


def _check_params_device(params: Params, dev: torch.device) -> None:
    wte = params["wte"]["weight"]
    if wte.device.type != dev.type:
        raise ValueError(f"params are on {wte.device}, the call asks for {dev}")


def forward(params: Params, idx: torch.Tensor, config: LLaMAConfig, device="cuda",
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward without a cache (the training and perplexity path):
    ``(B, T)`` token ids -> logits ``(B, T, padded_vocab_size)``.

    It runs under the caller's grad mode, so it is differentiable with respect to any
    leaf of ``params`` that requires grad. ``remat=True`` checkpoints each block
    (`torch.utils.checkpoint`, non-reentrant): the backward recomputes the block's
    forward instead of keeping its activations, the counterpart of the JAX package's
    ``jax.checkpoint`` on the scanned block. It trades about a third more compute,
    and a second launch of the attention forward per block, for O(1) blocks of
    live activations.
    """
    dev = resolve_device(device)
    _check_params_device(params, dev)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, None, idx.shape[1], dev)
    x = params["wte"]["weight"][idx]
    for block_params in unstack_layers(params["blocks"], config.n_layer):
        if remat:
            x = checkpoint(lambda x, p=block_params: transformer_block(p, x, rope, config)[0],
                           x, use_reentrant=False)
        else:
            x, _ = transformer_block(block_params, x, rope, config)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return apply_linear(params["lm_head"], x)


@torch.no_grad()
def forward_with_cache(
    params: Params,
    idx: torch.Tensor,
    input_pos: torch.Tensor,
    kv_cache: KVCache,
    config: LLaMAConfig,
    prefill_attn: bool = False,
    device="cuda",
) -> Tuple[torch.Tensor, KVCache]:
    """Incremental forward with a KV cache.

    Args:
      idx: ``(B, T)`` token ids occupying absolute positions ``input_pos`` (``(T,)``,
        contiguous). Prefill passes ``arange(T)``; decode passes ``[t]``. Positions
        given on the CPU cost no device synchronization; on the device they are
        read back once per call.
      kv_cache: from `init_kv_cache`; updated in place and returned.
      prefill_attn: promise that this call is a prefill from an EMPTY cache
        (``input_pos`` starts at 0): attention runs causally over the in-flight
        k/v instead of reading the whole cache.
    Returns:
      (logits ``(B, T, V)``, the updated kv_cache).
    """
    dev = resolve_device(device)
    _check_params_device(params, dev)
    pos_host = input_pos.cpu()
    span = (int(pos_host[0]), int(pos_host[-1]))
    input_pos = input_pos.to(dev, non_blocking=True)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, input_pos, idx.shape[1], dev)
    x = params["wte"]["weight"][idx]
    layers = unstack_layers(params["blocks"], config.n_layer)
    caches = unstack_layers(kv_cache, config.n_layer)
    for block_params, cache_l in zip(layers, caches):
        x, _ = transformer_block(
            block_params, x, rope, config, kv_cache=cache_l, input_pos=input_pos,
            prefill_attn=prefill_attn, span=span,
        )
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return apply_linear(params["lm_head"], x), kv_cache


def cast_params(params: Params, dtype: Optional[torch.dtype]) -> Params:
    """``params`` with every floating leaf cast to ``dtype``, except the leaves of
    quantized linears (their scales and zeros stay f32, as the kernels take them);
    unchanged when ``dtype`` is None. Inference runs in the dtype of the embedding,
    so on the card this is how an f32 checkpoint reaches the bf16 kernels."""
    if dtype is None:
        return params
    if isinstance(params, dict):
        if "qweight" in params:
            return params
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def param_count(params: Any) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
