"""Generation from finetuned checkpoints (counterpart of
`lit_llama_ja_tpu/cli/generate_finetuned.py`; reference
`generate/{full,lora,adapter,adapter_v2}.py`): load the base and the finetuned or PEFT
state, format the Alpaca prompt, generate.

    python -m lit_llama_ja_tpu_torch.cli.generate_finetuned --prompt "..." \\
        --lora-path out/lora/alpaca/iter-037500.npz --checkpoint-path <base> \\
        --tokenizer-path tokenizer.json

(`main_lora` is the command-line entry.) Each main prints the response and returns the
token ids, prompt included. On the card the model runs in bf16 activations and
``quantize`` routes every linear through the dequant-matmul kernels (K1-K5); a LoRA
merge and Adapter v2 need a plain base and raise on a quantized one, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device


def _prompt_ids(tokenizer, prompt: str) -> np.ndarray:
    from lit_llama_ja_tpu_torch.data.sft import generate_prompt

    return tokenizer.encode(generate_prompt({"instruction": prompt, "input": ""}),
                            bos=True, eos=False)


def _print_response(tokenizer, ids, n_prompt: int, seconds: float) -> None:
    print(tokenizer.decode(np.asarray(ids)).split("### Response:")[-1].strip())
    print(f"\nTime for inference: {seconds:.02f} sec total, "
          f"{(len(ids) - n_prompt) / seconds:.02f} tokens/sec", file=sys.stderr)


def _sampler(dev) -> torch.Generator:
    """The sampling generator: seed 0, as the JAX package's ``PRNGKey(0)``."""
    return torch.Generator(device=dev).manual_seed(0)


def _generate_with(params, config, prompt, tokenizer_path, max_new_tokens, top_k,
                   temperature, dev):
    from lit_llama_ja_tpu_torch.cli.generate_cli import compute_dtype, load_tokenizer
    from lit_llama_ja_tpu_torch.infer.generate import generate
    from lit_llama_ja_tpu_torch.models.llama import cast_params

    tokenizer = load_tokenizer(tokenizer_path)
    encoded = _prompt_ids(tokenizer, prompt)
    t0 = time.perf_counter()
    y = generate(
        cast_params(params, compute_dtype(dev)), config, encoded, max_new_tokens,
        temperature=temperature, top_k=top_k, eos_id=tokenizer.eos_id,
        generator=_sampler(dev),
        cache_dtype=torch.bfloat16, device=dev,
    )
    _print_response(tokenizer, y, len(encoded), time.perf_counter() - t0)
    return y


def main_full(
    prompt: str = "Hello, my name is",
    checkpoint_path: str = "out/full/alpaca/final",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    max_new_tokens: int = 100,
    top_k: int = 200,
    temperature: float = 0.8,
    quantize: Optional[str] = None,
    device: str = "cuda",
):
    """Generate from a fully-finetuned checkpoint (reference `generate/full.py`)."""
    from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any

    dev = resolve_device(device)
    params, config = load_model_any(Path(checkpoint_path), quantize, device=dev)
    return _generate_with(params, config, prompt, tokenizer_path, max_new_tokens, top_k,
                          temperature, dev)


def load_lora(checkpoint_path, lora_path, quantize, dev):
    """Base + LoRA state, merged (the reference's two-pass load, `generate/lora.py`).
    A quantized base has no plain qkv weight to merge into and raises ``KeyError``."""
    from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any
    from lit_llama_ja_tpu_torch.io.checkpoint import load_state_npz
    from lit_llama_ja_tpu_torch.models.lora import add_lora, merge_lora

    params, config = load_model_any(Path(checkpoint_path), quantize, device=dev)
    return merge_lora(add_lora(params, load_state_npz(lora_path, device=dev))), config


def main_lora(
    prompt: str = "Hello, my name is",
    lora_path: str = "out/lora/alpaca/final.npz",
    checkpoint_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    max_new_tokens: int = 100,
    top_k: int = 200,
    temperature: float = 0.8,
    quantize: Optional[str] = None,
    device: str = "cuda",
):
    """Generate from base + LoRA weights (reference `generate/lora.py`)."""
    dev = resolve_device(device)
    params, config = load_lora(checkpoint_path, lora_path, quantize, dev)
    return _generate_with(params, config, prompt, tokenizer_path, max_new_tokens, top_k,
                          temperature, dev)


def _overlay(dst, src) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _overlay(dst[k], v)
        else:
            dst[k] = v


def load_adapter(checkpoint_path, adapter_path, quantize, v2: bool, dev):
    """Base + adapter state (reference `generate/adapter.py`, `evaluate/adapter_v2.py`).

    The v1 leaves are read from ``adapter/`` (the layout of `extract_adapter_state`)
    or ``blocks/adapter/`` (`extract_adapter_v2_state`'s). With ``v2`` the linears get
    their scale and bias leaves (raising ``KeyError`` on a quantized base, as in the
    JAX package), and every other leaf of the state (scales, biases, norms) is laid
    over the tree. Returns (params, AdapterConfig)."""
    from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any
    from lit_llama_ja_tpu_torch.io.checkpoint import load_state_npz
    from lit_llama_ja_tpu_torch.models import adapter as adapter_mod

    params, config = load_model_any(Path(checkpoint_path), quantize, device=dev)
    acfg = adapter_mod.AdapterConfig(
        **{f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    )
    state = load_state_npz(adapter_path, device=dev)
    v1 = state["adapter"] if "adapter" in state else state["blocks"]["adapter"]
    params = adapter_mod.add_adapter(
        params, {k: v1[k] for k in ("adapter_wte", "gating_factor")})
    if v2:
        params = adapter_mod.add_adapter_v2(params)
        _overlay(params, {k: v for k, v in state.items() if k != "adapter"})
    return params, acfg


def main_adapter(
    prompt: str = "Hello, my name is",
    adapter_path: str = "out/adapter/alpaca/final.npz",
    checkpoint_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    max_new_tokens: int = 100,
    top_k: int = 200,
    temperature: float = 0.8,
    quantize: Optional[str] = None,
    v2: bool = False,
    device: str = "cuda",
):
    """Generate from base + adapter weights (reference `generate/adapter.py`,
    `generate/adapter_v2.py`): a prefill with ``prefill_attn`` into a bf16 cache of
    ``min(T + max_new_tokens, block_size)`` slots, then one cached step a token,
    sampled from a generator of seed 0."""
    from lit_llama_ja_tpu_torch.cli.generate_cli import compute_dtype, load_tokenizer
    from lit_llama_ja_tpu_torch.models import adapter as adapter_mod
    from lit_llama_ja_tpu_torch.models.llama import cast_params, init_kv_cache
    from lit_llama_ja_tpu_torch.ops.sampling import sample_token

    dev = resolve_device(device)
    params, acfg = load_adapter(checkpoint_path, adapter_path, quantize, v2, dev)
    params = cast_params(params, compute_dtype(dev))
    tokenizer = load_tokenizer(tokenizer_path)
    encoded = _prompt_ids(tokenizer, prompt)
    T = len(encoded)
    S = min(T + max_new_tokens, acfg.block_size)
    cache = init_kv_cache(acfg, 1, S, torch.bfloat16, device=dev)
    generator = _sampler(dev)
    t0 = time.perf_counter()
    logits, cache = adapter_mod.adapter_forward_with_cache(
        params, torch.as_tensor(encoded, device=dev).long()[None], torch.arange(T), cache,
        acfg, prefill_attn=True, device=dev,  # empty cache: causal over in-flight k/v
    )
    ids = list(encoded)
    for i in range(max_new_tokens):
        tok = int(sample_token(logits[0, -1], temperature, top_k, generator=generator))
        ids.append(tok)
        if tok == tokenizer.eos_id:
            break
        logits, cache = adapter_mod.adapter_forward_with_cache(
            params, torch.tensor([[tok]], device=dev), torch.tensor([T + i]), cache, acfg,
            device=dev,
        )
    ids = np.asarray(ids, dtype=np.int32)
    _print_response(tokenizer, ids, T, time.perf_counter() - t0)
    return ids


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main_lora)
