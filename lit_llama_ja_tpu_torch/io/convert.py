"""Checkpoint converters: lit-llama ``.pth`` / Meta / HF -> the port's param trees
(counterpart of `lit_llama_ja_tpu/io/convert.py`).

Covers the reference's converter surface:
  * `scripts/convert_checkpoint.py` — Meta consolidated.*.pth shards: rename keys,
    concatenate model-parallel shards along the documented dims, fuse q/k/v.
  * `scripts/convert_hf_checkpoint.py` — HF LLaMA: un-permute q/k, fuse qkv; and the
    export back (`native_to_hf_state_dict`).
  * lit-llama ``.pth`` (the reference's own format) <-> native trees, both ways.

Where the JAX package returns numpy arrays, the port returns torch tensors on the
CPU; the caller moves the tree to its device. ``torch.load(mmap=True)`` gives the
constant-memory streaming read that the reference builds with ``lazy_load``.
`lora_checkpoint_to_native` takes the reference's LoRA state dict to the grouped
leaves of `models/lora.py`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_model_lookup

StateDict = Dict[str, torch.Tensor]


def _t(a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A torch tensor or numpy array -> a CPU tensor (in ``dtype`` when given)."""
    t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    t = t.cpu()
    return t if dtype is None else t.to(dtype)


def _linear_quantizer(quantize: str):
    """``(w (K, N), name) -> leaf dict`` for a load-time quantization mode."""
    from lit_llama_ja_tpu_torch.quant.linear import (
        parse_quant_mode,
        quantize_colblock,
        quantize_int8_absmax,
        quantize_int8_dynamic,
        quantize_int8_outlier,
        resolve_bits,
        resolve_groupsize,
    )

    int8 = {"llm.int8": quantize_int8_outlier, "llm.int8-rtn": quantize_int8_absmax,
            "llm.int8-dyn": quantize_int8_dynamic}
    if quantize in int8:
        fn = int8[quantize]
        return lambda w, name: fn(w)
    _, bits, groupsize = parse_quant_mode(quantize)
    return lambda w, name: quantize_colblock(
        w, bits=resolve_bits(bits, name), tile_cols=resolve_groupsize(bits, name, groupsize)
    )


# ---------------------------------------------------------------------------
# lit-llama .pth <-> native
# ---------------------------------------------------------------------------

def lit_state_dict_to_native(
    sd: Dict, config: Optional[LLaMAConfig] = None, dtype: torch.dtype = torch.float32,
    quantize: Optional[str] = None,
):
    """Flat lit-llama state dict -> the stacked param tree (and its config).

    torch Linears store (out, in), the tree (in, out): every weight is transposed.
    ``transformer.h.{i}.*`` tensors stack on a leading layer axis, each converted to
    ``dtype`` as it is read. ``quantize`` (``llm.int8``, ``llm.int8-rtn``,
    ``llm.int8-dyn`` or a ``{gptq|rtn}.*`` mode, which quantizes round-to-nearest)
    quantizes each linear per layer while streaming out of the (mmap'd) state dict,
    so the full-precision model never exists in host memory at once."""
    if config is None:
        config = LLaMAConfig.from_name(llama_model_lookup(sd["transformer.wte.weight"].shape[1]))
    L = config.n_layer
    qlin = None if quantize is None else _linear_quantizer(quantize)

    def pad_vocab(w: torch.Tensor) -> torch.Tensor:
        # zero-pad rows up to padded_vocab_size (HF checkpoints ship unpadded)
        V = config.padded_vocab_size
        if w.shape[0] < V:
            w = torch.cat([w, w.new_zeros((V - w.shape[0], w.shape[1]))])
        return w

    def layer(i, key):
        return _t(sd[f"transformer.h.{i}.{key}"], dtype)

    def stack_w(key):  # transposed linear weights (quantized per layer if asked)
        if qlin is None:
            return {"weight": torch.stack([layer(i, key).T for i in range(L)])}
        name = key.removesuffix(".weight")  # "attn.c_attn" etc.
        per_layer = [qlin(layer(i, key).T.contiguous(), name) for i in range(L)]
        return {k: torch.stack([q[k] for q in per_layer]) for k in per_layer[0]}

    def stack_v(key):  # 1-D scales
        return torch.stack([layer(i, key) for i in range(L)])

    head_w = pad_vocab(_t(sd["lm_head.weight"], dtype)).T
    return {
        "wte": {"weight": pad_vocab(_t(sd["transformer.wte.weight"], dtype))},
        "lm_head": ({"weight": head_w} if qlin is None
                    else qlin(head_w.contiguous(), "lm_head")),
        "ln_f": {"scale": _t(sd["transformer.ln_f.scale"], dtype)},
        "blocks": {
            "rms_1": {"scale": stack_v("rms_1.scale")},
            "attn": {
                "c_attn": stack_w("attn.c_attn.weight"),
                "c_proj": stack_w("attn.c_proj.weight"),
            },
            "rms_2": {"scale": stack_v("rms_2.scale")},
            "mlp": {
                "c_fc1": stack_w("mlp.c_fc1.weight"),
                "c_fc2": stack_w("mlp.c_fc2.weight"),
                "c_proj": stack_w("mlp.c_proj.weight"),
            },
        },
    }, config


_LIT_LINEARS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc1", "mlp.c_fc2", "mlp.c_proj")


def native_to_lit_state_dict(params) -> StateDict:
    """Reverse conversion, so reference users can consume the port's checkpoints."""
    blocks = params["blocks"]
    L = blocks["rms_1"]["scale"].shape[0]
    sd = {
        "transformer.wte.weight": _t(params["wte"]["weight"]),
        "lm_head.weight": _t(params["lm_head"]["weight"]).T,
        "transformer.ln_f.scale": _t(params["ln_f"]["scale"]),
    }
    for i in range(L):
        sd[f"transformer.h.{i}.rms_1.scale"] = _t(blocks["rms_1"]["scale"][i])
        sd[f"transformer.h.{i}.rms_2.scale"] = _t(blocks["rms_2"]["scale"][i])
        for name in _LIT_LINEARS:
            mod, lin = name.split(".")
            sd[f"transformer.h.{i}.{name}.weight"] = _t(blocks[mod][lin]["weight"][i]).T
    return sd


def load_lit_checkpoint(
    path, config: Optional[LLaMAConfig] = None, dtype: torch.dtype = torch.float32,
    quantize: Optional[str] = None,
):
    """Load a reference lit-llama ``.pth`` (mmap'd: constant host memory, the
    ``lazy_load`` of `lit_llama/utils.py:200-376`), converting each tensor to ``dtype``
    and, with ``quantize``, each linear to its pack as it streams
    (`lit_state_dict_to_native`). Returns (params on the CPU, config)."""
    sd = torch.load(str(path), map_location="cpu", mmap=True, weights_only=True)
    return lit_state_dict_to_native(sd, config, dtype=dtype, quantize=quantize)


# ---------------------------------------------------------------------------
# Meta (consolidated.*.pth) -> lit
# ---------------------------------------------------------------------------

# dim along which each Meta tensor was model-parallel sharded
# (reference `scripts/convert_checkpoint.py:55-63`)
_META_SHARD_DIMS = {
    "output.weight": 0,
    "tok_embeddings.weight": 1,
    "attention.wq.weight": 0,
    "attention.wk.weight": 0,
    "attention.wv.weight": 0,
    "attention.wo.weight": 1,
    "feed_forward.w1.weight": 0,
    "feed_forward.w2.weight": 1,
    "feed_forward.w3.weight": 0,
}


def meta_checkpoints_to_lit(state_dicts) -> StateDict:
    """Merge Meta model-parallel shards into one flat lit-style state dict (reference
    `scripts/convert_checkpoint.py:20-52, 95-111`): wq/wk/wv are merged per matrix,
    then concatenated into the fused c_attn."""
    merged: StateDict = {}
    for key in state_dicts[0].keys():
        if "rope.freqs" in key or "inner_attention" in key:
            continue
        parts = [_t(sd[key], torch.float32) for sd in state_dicts]
        dim = next(
            (d for suffix, d in _META_SHARD_DIMS.items() if key.endswith(suffix)), None
        )
        merged[key] = parts[0] if dim is None else torch.cat(parts, dim=dim)

    out: StateDict = {
        "transformer.wte.weight": merged["tok_embeddings.weight"],
        "lm_head.weight": merged["output.weight"],
        "transformer.ln_f.scale": merged["norm.weight"],
    }
    layer_ids = sorted({int(k.split(".")[1]) for k in merged if k.startswith("layers.")})
    for i in layer_ids:
        p, o = f"layers.{i}.", f"transformer.h.{i}."
        out[o + "attn.c_attn.weight"] = torch.cat(
            [merged[p + "attention.wq.weight"], merged[p + "attention.wk.weight"],
             merged[p + "attention.wv.weight"]]
        )
        out[o + "attn.c_proj.weight"] = merged[p + "attention.wo.weight"]
        out[o + "mlp.c_fc1.weight"] = merged[p + "feed_forward.w1.weight"]
        out[o + "mlp.c_proj.weight"] = merged[p + "feed_forward.w2.weight"]
        out[o + "mlp.c_fc2.weight"] = merged[p + "feed_forward.w3.weight"]
        out[o + "rms_1.scale"] = merged[p + "attention_norm.weight"]
        out[o + "rms_2.scale"] = merged[p + "ffn_norm.weight"]
    return out


# ---------------------------------------------------------------------------
# torch LoRA state -> native grouped layout
# ---------------------------------------------------------------------------

def lora_checkpoint_to_native(sd: Dict, config: LLaMAConfig, alpha: float):
    """Reference LoRA state dict (``transformer.h.{i}.attn.c_attn.lora_{A,B}``,
    A: (g*r, D), B: (g*D, r)) -> grouped leaves {lora_A (L, D, g*r),
    lora_B (L, g, r, D), lora_alpha (L,)}, f32 tensors on the CPU."""
    L, D = config.n_layer, config.n_embd
    As, Bs = [], []
    for i in range(L):
        A = _t(sd[f"transformer.h.{i}.attn.c_attn.lora_A"], torch.float32)  # (g*r, D)
        B = _t(sd[f"transformer.h.{i}.attn.c_attn.lora_B"], torch.float32)  # (g*D, r)
        g = B.shape[0] // D
        As.append(A.T)  # (D, g*r)
        Bs.append(B.reshape(g, D, -1).transpose(1, 2))  # (g, r, D)
    return {
        "lora_A": torch.stack(As).contiguous(),
        "lora_B": torch.stack(Bs).contiguous(),
        "lora_alpha": torch.full((L,), float(alpha), dtype=torch.float32),
    }


# ---------------------------------------------------------------------------
# HuggingFace <-> lit / native
# ---------------------------------------------------------------------------

def _unpermute_hf(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Reverse HF's q/k rotary permutation (reference
    `scripts/convert_hf_checkpoint.py:61-68`)."""
    dim = w.shape[1]
    return w.reshape(n_head, 2, dim // n_head // 2, dim).transpose(1, 2).reshape(dim, dim)


def _permute_hf(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Apply HF's q/k rotary permutation (inverse of `_unpermute_hf`)."""
    dim = w.shape[1]
    return w.reshape(n_head, dim // n_head // 2, 2, dim).transpose(1, 2).reshape(dim, dim)


def hf_state_dict_to_lit(sd: Dict, config: LLaMAConfig) -> StateDict:
    """HF LLaMA state dict -> flat lit-style state dict
    (reference `scripts/convert_hf_checkpoint.py:70-134`)."""
    f32 = torch.float32
    out: StateDict = {
        "transformer.wte.weight": _t(sd["model.embed_tokens.weight"], f32),
        "lm_head.weight": _t(sd["lm_head.weight"], f32),
        "transformer.ln_f.scale": _t(sd["model.norm.weight"], f32),
    }
    for i in range(config.n_layer):
        p, o = f"model.layers.{i}.", f"transformer.h.{i}."
        q = _unpermute_hf(_t(sd[p + "self_attn.q_proj.weight"], f32), config.n_head)
        k = _unpermute_hf(_t(sd[p + "self_attn.k_proj.weight"], f32), config.n_head)
        v = _t(sd[p + "self_attn.v_proj.weight"], f32)
        out[o + "attn.c_attn.weight"] = torch.cat([q, k, v])
        out[o + "attn.c_proj.weight"] = _t(sd[p + "self_attn.o_proj.weight"], f32)
        out[o + "mlp.c_fc1.weight"] = _t(sd[p + "mlp.gate_proj.weight"], f32)
        out[o + "mlp.c_fc2.weight"] = _t(sd[p + "mlp.up_proj.weight"], f32)
        out[o + "mlp.c_proj.weight"] = _t(sd[p + "mlp.down_proj.weight"], f32)
        out[o + "rms_1.scale"] = _t(sd[p + "input_layernorm.weight"], f32)
        out[o + "rms_2.scale"] = _t(sd[p + "post_attention_layernorm.weight"], f32)
    return out


def native_to_hf_state_dict(params, config: LLaMAConfig) -> StateDict:
    """Export a param tree as a HF ``LlamaForCausalLM`` state dict: the inverse of
    `hf_state_dict_to_lit` then `lit_state_dict_to_native` (weights back to (out, in),
    the fused qkv split with HF's rotary permutation on q and k, the vocab padding
    trimmed to ``config.vocab_size``)."""
    blocks = params["blocks"]
    V, D = config.vocab_size, config.n_embd
    out: StateDict = {
        "model.embed_tokens.weight": _t(params["wte"]["weight"])[:V],
        "lm_head.weight": _t(params["lm_head"]["weight"]).T[:V],
        "model.norm.weight": _t(params["ln_f"]["scale"]),
    }
    for i in range(config.n_layer):
        p = f"model.layers.{i}."
        c_attn = _t(blocks["attn"]["c_attn"]["weight"][i]).T  # (3D, D)
        out[p + "self_attn.q_proj.weight"] = _permute_hf(c_attn[:D], config.n_head)
        out[p + "self_attn.k_proj.weight"] = _permute_hf(c_attn[D : 2 * D], config.n_head)
        out[p + "self_attn.v_proj.weight"] = c_attn[2 * D :]
        out[p + "self_attn.o_proj.weight"] = _t(blocks["attn"]["c_proj"]["weight"][i]).T
        out[p + "mlp.gate_proj.weight"] = _t(blocks["mlp"]["c_fc1"]["weight"][i]).T
        out[p + "mlp.up_proj.weight"] = _t(blocks["mlp"]["c_fc2"]["weight"][i]).T
        out[p + "mlp.down_proj.weight"] = _t(blocks["mlp"]["c_proj"]["weight"][i]).T
        out[p + "input_layernorm.weight"] = _t(blocks["rms_1"]["scale"][i])
        out[p + "post_attention_layernorm.weight"] = _t(blocks["rms_2"]["scale"][i])
    return out
