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

A quantized linear replaces ``{"weight"}`` by ``{"qweight", "scales", "zeros"}``. LoRA
adds ``{"lora_A", "lora_B", "lora_alpha"}`` to ``c_attn`` (`models/lora.py`), Adapter v2
adds ``{"adapter_scale", "adapter_bias"}`` to every linear (`models/adapter.py`);
`apply_linear` applies whichever leaves it finds, over a plain or a quantized linear.

Where the JAX package scans over the layer axis, the port loops over layers in
Python; where it branches with ``lax.cond`` on the position (roll-left eviction),
the port takes the branch the caller names (``roll``), or reads it from positions
given on the host. The KV cache is updated IN PLACE: the tensors of the cache passed
to `forward_with_cache` are written and the same dict is returned.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.models.lora import draw_seeds, lora_branch
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


def reset_kv_cache(cache: KVCache) -> None:
    """``cache`` back to what `init_kv_cache` made, in place and on the device: zero
    k/v, unit scales."""
    for name, t in cache.items():
        t.fill_(1 if name.endswith("_scale") else 0)


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

def apply_linear(
    layer_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    dropout_seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """``x @ W`` with dispatch on the leaves present.

    A plain linear has {"weight"}; a quantized one {"qweight", "scales", "zeros"} plus
    its format's extra leaves (int8, int4, int3, int2, LLM.int8 outliers; the width is
    read per leaf from its shapes, `quant/linear.py::quant_matmul`). LoRA leaves add
    the low-rank branch, whose input alone takes the dropout, its mask drawn from
    ``dropout_seed`` (`models/lora.py`);
    adapter-v2 leaves give ``adapter_scale * (y + adapter_bias)``.
    """
    parallel_apply = getattr(layer_params, "parallel_apply", None)
    if parallel_apply is not None:  # a tensor-parallel linear (`parallel/sharded.py`)
        return parallel_apply(x, apply_linear, dropout_seed=dropout_seed,
                              dropout_rate=dropout_rate)
    if "qweight" in layer_params:
        y = quant_matmul(x, layer_params)
    else:
        y = x @ layer_params["weight"].to(x.dtype)
    if "lora_A" in layer_params:
        y = y + lora_branch(layer_params, x, dropout_seed=dropout_seed,
                            dropout_rate=dropout_rate)
    if "adapter_bias" in layer_params:
        y = layer_params["adapter_scale"].to(y.dtype) * (
            y + layer_params["adapter_bias"].to(y.dtype))
    return y


def layer_seeds(generator: Optional[torch.Generator], n_layer: int,
                device) -> Optional[torch.Tensor]:
    """One dropout seed a layer, ``(n_layer,)`` int64 on ``device``, drawn from
    ``generator`` (None without one). A seed, not a generator, goes to each layer, so
    that a recomputed block (``remat``) draws its dropout mask again bit for bit."""
    if generator is None:
        return None
    return draw_seeds(generator, (n_layer,)).to(device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qkv(attn_params, x, n_head, rope, dropout_seed=None, dropout_rate=0.0):
    """Project to q, k, v heads and apply RoPE. Returns (B, nh, T, hd) views.
    ``n_head`` counts the heads of ``c_attn``'s output: a tensor-parallel rank's own
    (`parallel/sharded.py`)."""
    B, T, _ = x.shape
    qkv = apply_linear(attn_params["c_attn"], x, dropout_seed=dropout_seed,
                       dropout_rate=dropout_rate)
    q, k, v = qkv.chunk(3, dim=-1)
    hd = q.shape[-1] // n_head
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
    roll: bool = False,
    *,
    dropout_seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Causal self-attention: full-sequence without a cache, else `cached_attention`.
    The dropout reaches only a LoRA branch of ``c_attn``."""
    B, T, _ = x.shape
    q, k, v = _qkv(attn_params, x, config.n_head, rope, dropout_seed, dropout_rate)
    if kv_cache is None:
        y = causal_attention(q, k, v)
    else:
        y = cached_attention(q, k, v, kv_cache, input_pos, prefill_attn, roll)
    y = y.transpose(1, 2).reshape(B, T, -1)
    return apply_linear(attn_params["c_proj"], y), kv_cache


def cached_attention(q, k, v, cache: KVCache, input_pos: torch.Tensor,
                     prefill_attn: bool = False, roll: bool = False) -> torch.Tensor:
    """Write the new k/v into one layer's cache (updated in place) and attend.

    With ``roll`` every cache tensor rolls one slot left and the T new entries land on
    the last T slots (roll-left eviction, the JAX package's ``lax.cond`` branch for a
    last position past the cache); without it they land at ``input_pos``. The write is
    an ``index_copy_`` at device slots, so nothing is read back to the host. Then the
    queries attend to the whole cache, or, with ``prefill_attn`` (a promise that this
    is a prefill from position 0 into an empty cache), causally to the in-flight k/v.
    """
    T = q.shape[2]
    quantized = "k_scale" in cache
    int4 = quantized and cache["k"].dtype == torch.uint8
    S = cache["k"].shape[2]
    write_pos = input_pos
    if roll:
        for c in cache.values():
            c.copy_(torch.roll(c, -1, dims=2))
        write_pos = torch.full_like(input_pos, S - 1)

    if int4:
        kq, ks, vq, vs = quantize_kv4(k, v, head_axis=1)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    elif quantized:
        kq, ks, vq, vs = quantize_kv(k, v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k, "v": v}

    slots = torch.arange(S - T, S, device=input_pos.device) if roll else input_pos.long()
    for key, val in writes.items():
        cache[key].index_copy_(2, slots, val.to(cache[key].dtype))

    if prefill_attn:
        return causal_attention(q, k, v)
    if int4:
        return decode_attention_quant4(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], write_pos
        )
    if quantized:
        return decode_attention_quant(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], write_pos
        )
    return decode_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), write_pos)


def host_roll(input_pos: torch.Tensor, S: int) -> bool:
    """Whether positions given on the CPU run past a cache of ``S`` slots (the
    roll-left branch). Positions on the device are not read back: their caller names
    the branch (``roll``) instead."""
    if input_pos.device.type != "cpu":
        raise ValueError("positions on the device need an explicit roll=: the cached "
                         "forward does not read them back to the host")
    return int(input_pos[-1]) >= S


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
    roll: bool = False,
    *,
    dropout_seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
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
        roll=roll,
        dropout_seed=dropout_seed,
        dropout_rate=dropout_rate,
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


def index_layer(tree: Any, l: int) -> Any:
    """Layer ``l``'s views of a tree of stacked tensors (`unstack_layers`, one layer)."""
    if isinstance(tree, dict):
        return {k: index_layer(v, l) for k, v in tree.items()}
    return tree[l]


def embed(params: Params, idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """The token embedding; on a mesh, `parallel/sharded.embed` (vocab-parallel)."""
    if mesh is None:
        return params["wte"]["weight"][idx]
    from lit_llama_ja_tpu_torch.parallel import sharded

    return sharded.embed(params, idx, mesh)


def layer_params(blocks: Params, l: int, mesh=None) -> Params:
    """Layer ``l`` of the stacked blocks; on a mesh, this rank's view of it
    (`parallel/sharded.layer_view`: fsdp dims gathered, tensor-parallel linears)."""
    if mesh is None:
        return index_layer(blocks, l)
    from lit_llama_ja_tpu_torch.parallel import sharded

    return sharded.layer_view(blocks, l, mesh)


def lm_head(params: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The output projection; on a mesh, `parallel/sharded.lm_head` (logits gathered)."""
    if mesh is None:
        return apply_linear(params["lm_head"], x)
    from lit_llama_ja_tpu_torch.parallel import sharded

    return sharded.lm_head(params, x, mesh, apply_linear)


def block_config(config: LLaMAConfig, mesh=None) -> LLaMAConfig:
    """The config the blocks run with: on a tensor-parallel mesh, this rank's heads
    (`parallel/sharded.local_config`)."""
    if mesh is None:
        return config
    from lit_llama_ja_tpu_torch.parallel import sharded

    return sharded.local_config(config, mesh)


def _check_params_device(params: Params, dev: torch.device) -> None:
    wte = params["wte"]["weight"]
    if wte.device.type != dev.type:
        raise ValueError(f"params are on {wte.device}, the call asks for {dev}")


def forward(params: Params, idx: torch.Tensor, config: LLaMAConfig, device="cuda",
            remat: bool = False, dropout_generator: Optional[torch.Generator] = None,
            dropout_rate: float = 0.0, mesh=None,
            dropout_seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward without a cache (the training and perplexity path):
    ``(B, T)`` token ids -> logits ``(B, T, padded_vocab_size)``.

    It runs under the caller's grad mode, so it is differentiable with respect to any
    leaf of ``params`` that requires grad. ``remat=True`` checkpoints each block
    (`torch.utils.checkpoint`, non-reentrant): the backward recomputes the block's
    forward instead of keeping its activations, the counterpart of the JAX package's
    ``jax.checkpoint`` on the scanned block. It trades about a third more compute,
    and a second launch of the attention forward per block, for O(1) blocks of
    live activations. No RNG state is preserved for the recomputation: the only
    randomness, the dropout, is a function of its seeds.

    ``dropout_seeds``/``dropout_rate``: dropout on the input of the LoRA branch
    (reference `lora.py:82-84`), used only when the tree carries LoRA leaves and seeds
    are given: ``(n_layer,)`` int64 on the device, layer ``l``'s mask drawn from seed
    ``l`` (`models/lora.dropout_keep`), as the JAX package splits its key per layer.
    ``dropout_generator`` draws those seeds (`layer_seeds`) when none are given.

    ``mesh`` (`parallel/mesh.Mesh`): ``params`` is this rank's `parallel/specs.
    shard_params` slice and the forward runs sharded (`parallel/sharded.py`); the
    logits come back whole on every rank.
    """
    dev = resolve_device(device)
    _check_params_device(params, dev)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, None, idx.shape[1], dev)
    x = embed(params, idx, mesh)
    if dropout_seeds is None:
        dropout_seeds = layer_seeds(dropout_generator, config.n_layer, dev)
    bconfig = block_config(config, mesh)

    def block(x, l):
        seed = None if dropout_seeds is None else dropout_seeds[l]
        return transformer_block(layer_params(params["blocks"], l, mesh), x, rope, bconfig,
                                 dropout_seed=seed, dropout_rate=dropout_rate)[0]

    for l in range(config.n_layer):
        if remat:
            x = checkpoint(block, x, l, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, l)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh)


@torch.no_grad()
def forward_with_cache(
    params: Params,
    idx: torch.Tensor,
    input_pos: torch.Tensor,
    kv_cache: KVCache,
    config: LLaMAConfig,
    prefill_attn: bool = False,
    device="cuda",
    mesh=None,
    *,
    roll: Optional[bool] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Incremental forward with a KV cache.

    Args:
      idx: ``(B, T)`` token ids occupying absolute positions ``input_pos`` (``(T,)``,
        contiguous). Prefill passes ``arange(T)``; decode passes ``[t]``.
      kv_cache: from `init_kv_cache`; updated in place and returned.
      prefill_attn: promise that this call is a prefill from an EMPTY cache
        (``input_pos`` starts at 0): attention runs causally over the in-flight
        k/v instead of reading the whole cache.
      mesh: run sharded (`forward`); the cache is then this rank's heads,
        `init_kv_cache` of `block_config(config, mesh)`.
      roll: `cached_attention`'s roll-left branch. Positions given on the CPU need
        none (it is read there, at no device synchronization); positions on the
        device need it, and the call then reads nothing back to the host, so that a
        decode step can be captured in a CUDA graph.
    Returns:
      (logits ``(B, T, V)``, the updated kv_cache).
    """
    dev = resolve_device(device)
    _check_params_device(params, dev)
    if roll is None:
        roll = host_roll(input_pos, kv_cache["k"].shape[3])
    input_pos = input_pos.to(dev, non_blocking=True)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, input_pos, idx.shape[1], dev)
    x = embed(params, idx, mesh)
    bconfig = block_config(config, mesh)
    for l, cache_l in enumerate(unstack_layers(kv_cache, config.n_layer)):
        x, _ = transformer_block(
            layer_params(params["blocks"], l, mesh), x, rope, bconfig, kv_cache=cache_l,
            input_pos=input_pos, prefill_attn=prefill_attn, roll=roll,
        )
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh), kv_cache


def cast_params(params: Params, dtype: Optional[torch.dtype]) -> Params:
    """``params`` with every floating leaf cast to ``dtype``, except the leaves of
    quantized linears (their scales and zeros stay f32, as the kernels take them) and
    an MoE router (it routes in f32, `models/moe.py`); unchanged when ``dtype`` is
    None. Inference runs in the dtype of the embedding, so on the card this is how an
    f32 checkpoint reaches the bf16 kernels."""
    if dtype is None:
        return params
    if isinstance(params, dict):
        if "qweight" in params:
            return params
        return {k: v if k == "router" else cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def param_count(params: Any) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
