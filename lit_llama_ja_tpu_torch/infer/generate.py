"""Autoregressive generation (counterpart of `lit_llama_ja_tpu/infer/generate.py`).

The semantics are those of the JAX package's `_generate_jit`: the prompt is padded
to a power-of-two bucket and prefilled in one pass with ``prefill_attn=True``, the
cache holds ``max(min(T + max_new_tokens, block_size), P)`` slots and rolls left
past its end, exactly ``max_new_tokens`` tokens are decoded, and the result is cut
after the first EOS (inclusive). The JAX package compiles the loop into one program.
Here the prefill runs eagerly and every decode step is one device program
(`infer/decode_graph.GenerateStep`): on a CUDA device the step is captured in a CUDA
graph and replayed once a token, fed by device buffers (the token, the position, a step
counter, the output tokens), and the host reads the tokens back once, at the end. On
the CPU the same step body runs in a host loop. An `models/moe.MoEConfig` decodes
through the sparse-MLP forward (`_cached_forward`). With ``mesh`` the forwards run
sharded (`parallel/sharded.py`) on this rank's slices of the params and a cache of
this rank's heads; every rank of the mesh calls `generate` alike and gets the same
tokens. A mesh's collectives stage through the host over gloo, so its steps run the
body eagerly, uncaptured.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import GenerateStep
from lit_llama_ja_tpu_torch.models.llama import block_config, forward_with_cache, init_kv_cache
from lit_llama_ja_tpu_torch.models.moe import MoEConfig, forward_moe_with_cache
from lit_llama_ja_tpu_torch.ops.sampling import sample_token


def bucket_length(n: int, minimum: int = 16) -> int:
    """Round up to the next power of two (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _cached_forward(params, idx, input_pos, cache, config, prefill_attn=False, device="cuda",
                    mesh=None, roll=None):
    """The incremental forward of ``config``'s family: MoE checkpoints (config.json
    with the expert fields) through `forward_moe_with_cache`, dense ones through
    `forward_with_cache`."""
    fwd = forward_moe_with_cache if isinstance(config, MoEConfig) else forward_with_cache
    return fwd(params, idx, input_pos, cache, config, prefill_attn=prefill_attn, device=device,
               mesh=mesh, roll=roll)


def decode_step(params, config: LLaMAConfig, cache, first: torch.Tensor, start_pos: int,
                max_new_tokens: int, *, temperature: float = 1.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None, generator: Optional[torch.Generator] = None,
                device="cuda", mesh=None, cuda_graph: bool = True) -> GenerateStep:
    """`generate`'s decode step after its prefill: ``first`` is the sampled first token,
    ``start_pos`` its position, ``cache`` the prefilled cache; each `GenerateStep.run`
    decodes one more token into ``.out``. Captured in a CUDA graph on a CUDA device
    with ``mesh=None`` and ``cuda_graph``; otherwise the body runs eagerly."""
    dev = resolve_device(device)

    def forward(tok, pos, roll):
        return _cached_forward(params, tok, pos, cache, config, device=dev, mesh=mesh,
                               roll=roll)[0]

    def sample(logits):
        return sample_token(logits, temperature, top_k, top_p, generator)

    capture = dev.type == "cuda" and mesh is None and cuda_graph
    return GenerateStep(forward, sample, first, start_pos, max_new_tokens,
                        cache["k"].shape[3], dev, capture=capture,
                        generator=generator if temperature > 0 else None)


@torch.no_grad()
def generate(
    params,
    config: LLaMAConfig,
    prompt,
    max_new_tokens: int,
    *,
    max_seq_length: Optional[int] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: torch.dtype = torch.float32,
    quantize_kv=False,
    device="cuda",
    mesh=None,
    cuda_graph: bool = True,
) -> np.ndarray:
    """Generate a continuation of ``prompt`` (1-D int token ids).

    Returns a numpy array ``prompt + generated`` (truncated after ``eos_id``).
    ``generator`` drives sampling when ``temperature > 0``; it must live on
    ``device``. On a CUDA device the decode steps replay one captured step (its roll
    variant past the cache), the first run of each being the capture's eager
    warm-up; ``cuda_graph=False`` runs every step's body eagerly, which only a
    comparison of the two needs.
    """
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
    T = int(prompt.shape[0])
    if T > config.block_size:
        raise ValueError(
            f"Cannot forward sequence of length {T}, block size is only "
            f"{config.block_size}"
        )
    if max_seq_length is None:
        max_seq_length = min(T + max_new_tokens, config.block_size)
    P = min(bucket_length(T), config.block_size)
    # the cache must hold at least the padded prefill span
    S = max(max_seq_length, P)
    padded = torch.zeros((1, P), dtype=torch.long)
    padded[0, :T] = prompt

    cache = init_kv_cache(block_config(config, mesh), 1, S, cache_dtype, quantized=quantize_kv,
                          device=dev)
    logits, cache = _cached_forward(
        params, padded.to(dev), torch.arange(P), cache, config,
        prefill_attn=True, device=dev, mesh=mesh,
    )
    first = sample_token(logits[0, T - 1], temperature, top_k, top_p, generator)
    step = decode_step(params, config, cache, first, T, max(max_new_tokens, 1),
                       temperature=temperature, top_k=top_k, top_p=top_p, generator=generator,
                       device=dev, mesh=mesh, cuda_graph=cuda_graph)
    for _ in range(max_new_tokens - 1):
        step.run()
    out = step.out.cpu().numpy().astype(np.int32)
    if eos_id is not None:
        hits = np.nonzero(out == eos_id)[0]
        if hits.size:
            out = out[: hits[0] + 1]  # include the EOS token
    return np.concatenate([prompt.numpy().astype(np.int32), out])
