"""LLaMA-Adapter v1 and v2 as parameter-tree transforms (counterpart of
`lit_llama_ja_tpu/models/adapter.py`; reference `lit_llama/adapter.py`,
`lit_llama/adapter_v2.py`).

  * v1 adds ``adapter_wte (L, aT, D)`` and ``gating_factor (L, n_head)`` leaves under
    ``blocks/adapter``. Every layer runs the prefix cross-attention; the layers below
    ``adapter_start_layer`` multiply it by 0 (zero-init gating means they would add
    nothing at init either way, as in the reference). The prefix k and v come from
    ``c_attn`` without RoPE and are recomputed at every step, not cached.
  * v2 adds ``adapter_scale`` / ``adapter_bias`` leaves to every linear, ``lm_head``
    included; `models/llama.apply_linear` applies ``scale * (x @ W + bias)``.

The forwards run on the kernels of `models/llama.py`: the self-attention through
`ops/attention.causal_attention` (K2, and K6 under autograd, on the card) and every
linear, the prefix projection included, through `apply_linear` (K1-K5 on a quantized
base). The prefix attention is plain PyTorch, as it is plain XLA in the JAX package.
`adapter_forward` also runs on a ``(dp, fsdp, tp)`` mesh, on this rank's heads
(`parallel/sharded.py` holds the v2 leaves of the sharded linears).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_configs
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
from lit_llama_ja_tpu_torch.models.llama import (
    KVCache,
    _check_params_device,
    _qkv,
    _rope_for_positions,
    apply_linear,
    block_config,
    cached_attention,
    embed,
    host_roll,
    index_layer,
    layer_params,
    lm_head,
    mlp_block,
    unstack_layers,
)
from lit_llama_ja_tpu_torch.ops.attention import causal_attention, prefix_attention
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm


@dataclass(frozen=True)
class AdapterConfig(LLaMAConfig):
    """Reference `lit_llama/adapter.py:53-57`."""

    adapter_prompt_length: int = 10
    adapter_start_layer: int = 2

    @classmethod
    def from_name(cls, name: str, **overrides) -> "AdapterConfig":
        return cls(**{**llama_configs[name], **overrides})


def init_adapter_params(
    generator: torch.Generator, config: AdapterConfig, dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """``adapter_wte`` N(0, 1) from ``generator`` (the nn.Embedding default), gating
    zero (reference `adapter.py:74-77`)."""
    dev = resolve_device(device)
    L, aT, D = config.n_layer, config.adapter_prompt_length, config.n_embd
    wte = torch.randn((L, aT, D), generator=generator, device=generator.device)
    return {
        "adapter_wte": wte.to(device=dev, dtype=dtype),
        "gating_factor": torch.zeros((L, config.n_head), dtype=dtype, device=dev),
    }


def add_adapter(params: Dict[str, Any], adapter_params: Dict[str, torch.Tensor]):
    """A new tree with the v1 leaves under ``blocks/adapter``; the leaves are shared."""
    return {**params, "blocks": {**params["blocks"], "adapter": dict(adapter_params)}}


def extract_adapter_state(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Adapter-only checkpoint content (reference `adapter_state_from_state_dict`):
    ``{"adapter/adapter_wte": ..., "adapter/gating_factor": ...}``."""
    return {f"adapter/{k}": v for k, v in params["blocks"].get("adapter", {}).items()}


def adapter_trainable(path: str) -> bool:
    """Reference `mark_only_adapter_as_trainable` (`adapter.py:305-308`)."""
    return "adapter_wte" in path or "gating_factor" in path


V2_SUBSTRINGS = ("adapter_wte", "gating_factor", "adapter_scale", "adapter_bias",
                 "rms_1", "rms_2", "ln_f")


def adapter_v2_trainable(path: str) -> bool:
    """Reference `get_adapter_substrings` (`adapter_v2.py:9-13`)."""
    return any(s in path for s in V2_SUBSTRINGS)


# ---------------------------------------------------------------------------
# Adapter v2 linear patching
# ---------------------------------------------------------------------------

V2_LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc1"), ("mlp", "c_fc2"),
              ("mlp", "c_proj"))


def _v2_leaves(leaf: Dict[str, torch.Tensor], stacked: bool, dtype,
               widen: int = 1) -> Dict[str, torch.Tensor]:
    """``leaf`` with a zero bias and a unit scale, ``(L, 1, out)`` for a stacked linear
    and ``(out,)`` for ``lm_head``. Sized from the plain ``weight`` (whose output dim is
    ``out / widen``: a rank's shard of it): a quantized linear has none and raises
    ``KeyError``, as in the JAX package (ROADMAP.md, queue 3)."""
    if "weight" not in leaf:
        raise KeyError(
            "'weight': add_adapter_v2 sizes its scale and bias from a linear's plain "
            f"weight, and this linear has none (leaves {sorted(leaf)}; Adapter v2 on a "
            "quantized base is not supported)"
        )
    w = leaf["weight"]
    out = w.shape[-1] * widen
    shape = (w.shape[0], 1, out) if stacked else (out,)
    return {**leaf, "adapter_bias": torch.zeros(shape, dtype=dtype, device=w.device),
            "adapter_scale": torch.ones(shape, dtype=dtype, device=w.device)}


def add_adapter_v2(params: Dict[str, Any], dtype: torch.dtype = torch.float32,
                   mesh=None) -> Dict[str, Any]:
    """Add zero-bias / unit-scale leaves to every linear (reference
    `add_adapter_v2_parameters_to_linear_layers`, `adapter_v2.py:34-45`), ``lm_head``
    included. A new tree; the leaves it does not add are shared. On a mesh
    ``params`` is this rank's `parallel/specs.shard_params` slice, and the leaves are
    added whole (they are replicated)."""
    def widen(path):
        if mesh is None:
            return 1
        from lit_llama_ja_tpu_torch.parallel.specs import axes_of, spec_of

        return mesh.size(axes_of(spec_of(path + "/weight")[-1]))

    blocks = dict(params["blocks"])
    for mod, name in V2_LINEARS:
        blocks[mod] = {**blocks[mod], name: _v2_leaves(blocks[mod][name], True, dtype,
                                                       widen(f"blocks/{mod}/{name}"))}
    return {**params, "blocks": blocks,
            "lm_head": _v2_leaves(params["lm_head"], False, dtype, widen("lm_head"))}


def extract_adapter_v2_state(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """v2 checkpoint content (reference `adapter_v2_state_from_state_dict`): every leaf
    whose path (``"blocks/attn/c_attn/adapter_bias"``) `adapter_v2_trainable` selects —
    the v1 leaves under ``blocks/adapter``, the linears' scales and biases, and the
    norms."""
    return {path: leaf for path, leaf in flatten_tree(params).items()
            if adapter_v2_trainable(path)}


# ---------------------------------------------------------------------------
# Forward with prefix cross-attention
# ---------------------------------------------------------------------------

def _adapter_attention(attn_params, adapter_wte_l, gating_l, active: bool, x, rope,
                       config: AdapterConfig, kv_cache=None, input_pos=None,
                       prefill_attn=False, roll=False, mesh=None):
    """Self-attention plus the gated prefix cross-attention (reference
    `adapter.py:86-172`). ``prefill_attn`` is `models/llama.cached_attention`'s promise
    of a prefill from an empty cache; the prefix branch does not depend on it. On a
    tensor-parallel mesh ``config`` holds this rank's heads: the prefix projection
    gives their k and v through the column-parallel ``c_attn``, and the gate is cut
    to them after `copy_to` (so its gradient sums the ranks')."""
    B, T, _ = x.shape
    nh, hd = config.n_head, config.head_dim
    q, k, v = _qkv(attn_params, x, nh, rope)
    if kv_cache is None:
        y = causal_attention(q, k, v)
    else:
        y = cached_attention(q, k, v, kv_cache, input_pos, prefill_attn, roll)

    # the prefix's k and v: c_attn without RoPE (reference adapter.py:153-157)
    aT = adapter_wte_l.shape[0]
    aqkv = apply_linear(attn_params["c_attn"], adapter_wte_l[None].to(x.dtype))
    _, ak, av = aqkv.split(nh * hd, dim=-1)
    ak = ak.reshape(1, aT, nh, hd).expand(B, aT, nh, hd).transpose(1, 2)
    av = av.reshape(1, aT, nh, hd).expand(B, aT, nh, hd).transpose(1, 2)
    ay = prefix_attention(q, ak, av)
    if mesh is not None and mesh.shape["tp"] > 1:
        from lit_llama_ja_tpu_torch.parallel.mesh import copy_to

        gating_l = copy_to(gating_l, mesh, "tp").narrow(-1, mesh.index("tp") * nh, nh)
    gate = gating_l.reshape(1, nh, 1, 1).to(y.dtype)
    y = y + float(active) * gate * ay

    y = y.transpose(1, 2).reshape(B, T, nh * hd)
    return apply_linear(attn_params["c_proj"], y)


def _adapter_block(block_params, adapter_l, layer_idx: int, x, rope, config: AdapterConfig,
                   kv_cache=None, input_pos=None, prefill_attn=False, roll=False, mesh=None):
    x = x + _adapter_attention(
        block_params["attn"], adapter_l["adapter_wte"], adapter_l["gating_factor"],
        layer_idx >= config.adapter_start_layer,
        rmsnorm(x, block_params["rms_1"]["scale"], config.norm_eps), rope, config,
        kv_cache, input_pos, prefill_attn=prefill_attn, roll=roll, mesh=mesh,
    )
    return x + mlp_block(
        block_params["mlp"], rmsnorm(x, block_params["rms_2"]["scale"], config.norm_eps)
    )


def _layers(params, config):
    """Per-layer (block params, adapter leaves) pairs."""
    blocks = {k: v for k, v in params["blocks"].items() if k != "adapter"}
    return zip(unstack_layers(blocks, config.n_layer),
               unstack_layers(params["blocks"]["adapter"], config.n_layer))


def adapter_forward(params, idx: torch.Tensor, config: AdapterConfig, device="cuda",
                    mesh=None) -> torch.Tensor:
    """Full-sequence forward with the adapter prefix attention: ``(B, T)`` token ids
    -> logits ``(B, T, padded_vocab_size)``, under the caller's grad mode.

    ``mesh``: ``params`` is this rank's `parallel/specs.shard_params` slice (the
    adapter leaves replicated beside it) and the forward runs sharded, as
    `models/llama.forward` does; the logits come back whole on every rank."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, None, idx.shape[1], dev)
    x = embed(params, idx, mesh)
    blocks = {k: v for k, v in params["blocks"].items() if k != "adapter"}
    bconfig = block_config(config, mesh)
    for l in range(config.n_layer):
        x = _adapter_block(layer_params(blocks, l, mesh),
                           index_layer(params["blocks"]["adapter"], l), l, x, rope, bconfig,
                           mesh=mesh)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh)


@torch.no_grad()
def adapter_forward_with_cache(
    params, idx: torch.Tensor, input_pos: torch.Tensor, kv_cache: KVCache,
    config: AdapterConfig, prefill_attn: bool = False, device="cuda",
) -> Tuple[torch.Tensor, KVCache]:
    """Incremental forward with a KV cache (`models/llama.forward_with_cache`'s
    contract: the cache is updated in place and returned, and rolls left past its
    end). The ``aT``-row prefix k and v are recomputed at every step, not cached."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    roll = host_roll(input_pos, kv_cache["k"].shape[3])
    input_pos = input_pos.to(dev, non_blocking=True)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, input_pos, idx.shape[1], dev)
    x = params["wte"]["weight"][idx]
    caches = unstack_layers(kv_cache, config.n_layer)
    for i, ((block_params, adapter_l), cache_l) in enumerate(zip(_layers(params, config),
                                                                 caches)):
        x = _adapter_block(block_params, adapter_l, i, x, rope, config, kv_cache=cache_l,
                           input_pos=input_pos, prefill_attn=prefill_attn, roll=roll)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return apply_linear(params["lm_head"], x), kv_cache
