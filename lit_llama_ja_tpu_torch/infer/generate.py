"""Autoregressive generation (counterpart of `lit_llama_ja_tpu/infer/generate.py`).

The semantics are those of the JAX package's `_generate_jit`: the prompt is padded
to a power-of-two bucket and prefilled in one pass with ``prefill_attn=True``, the
cache holds ``max(min(T + max_new_tokens, block_size), P)`` slots and rolls left
past its end, exactly ``max_new_tokens`` tokens are decoded, and the result is cut
after the first EOS (inclusive). The JAX package compiles the prefill and the loop into
one program and its jit cache keeps it across calls. Here a call runs a
`GenerateProgram`, held across calls in ``PROGRAMS`` (`infer/decode_graph.HeldPrograms`)
under the jit's static arguments (config, bucket P, cache slots S, max_new_tokens,
temperature, top-k, top-p, cache dtype, KV mode), the generator and the param leaves.
The program owns the staging buffers (the padded prompt and its length T), the KV
cache, the decode carry (the token, the position, a step counter, the output tokens)
and two kinds of device program in one pool: the prefill span (the cache reset, the
prefill, the first draw, the carry set, all on the device) and the decode step
(`infer/decode_graph.GenerateStep`). On a CUDA device each is captured in a CUDA graph
at the key's first call and replayed after that, and the host reads the tokens back
once, at the end; on the CPU the same bodies run in host calls over the same buffers.
``cuda_graph=False`` runs a fresh program eagerly and holds nothing. An
`models/moe.MoEConfig` decodes through the sparse-MLP forward (`_cached_forward`).
With ``mesh`` the forwards run sharded (`parallel/sharded.py`) on this rank's slices of
the params and a cache of this rank's heads; every rank of the mesh calls `generate`
alike and gets the same tokens. A mesh's collectives stage through the host over gloo,
so its programs run their bodies eagerly, fresh every call.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import (
    Bound,
    GenerateStep,
    HeldPrograms,
    SpanStep,
)
from lit_llama_ja_tpu_torch.models.llama import (
    block_config,
    forward_with_cache,
    init_kv_cache,
    normalize_kv_mode,
    reset_kv_cache,
)
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
    """`generate`'s decode step after a prefill of one's own: ``first`` is the sampled
    first token, ``start_pos`` its position, ``cache`` the prefilled cache; each
    `GenerateStep.run` decodes one more token into ``.out``. Captured in a CUDA graph on
    a CUDA device with ``mesh=None`` and ``cuda_graph``; otherwise the body runs
    eagerly."""
    dev = resolve_device(device)
    capture = dev.type == "cuda" and mesh is None and cuda_graph
    step = _step(params, config, cache, max_new_tokens, temperature, top_k, top_p, generator,
                 dev, mesh, capture)
    step.start(start_pos, first)
    return step


def _step(params, config, cache, n_new, temperature, top_k, top_p, generator, dev, mesh,
          capture, pool=None) -> GenerateStep:
    def forward(tok, pos, roll):
        return _cached_forward(params, tok, pos, cache, config, device=dev, mesh=mesh,
                               roll=roll)[0]

    def sample(logits):
        return sample_token(logits, temperature, top_k, top_p, generator)

    return GenerateStep(forward, sample, n_new, cache["k"].shape[3], dev, capture=capture,
                        generator=generator if temperature > 0 else None, pool=pool)


def prefill_body(params, config, cache, positions, sample, dev, mesh, tok, pos, step, *,
                 out, prompt, T) -> None:
    """`generate`'s prefill span over device buffers: the cache reset (JAX's
    `init_kv_cache` on every call), the prefill of ``prompt`` ``(1, P)`` at
    ``positions``, the first token drawn from the logits at the device index ``T - 1``
    (``T`` ``(1,)``), then the decode carry set: ``tok`` and ``out[0]`` the token,
    ``pos`` ``T``, ``step`` 1. It reads nothing back to the host."""
    reset_kv_cache(cache)
    logits = _cached_forward(params, prompt, positions, cache, config, prefill_attn=True,
                             device=dev, mesh=mesh, roll=False)[0]
    first = sample(logits[0].index_select(0, T - 1)[0])
    tok.copy_(first.view(1, 1))
    out[:1] = tok[0]
    pos.copy_(T)
    step.fill_(1)


class GenerateProgram:
    """One key's program of `generate` (see the module docstring): ``cache`` (the KV
    cache of S slots), ``span`` (the prefill, a `SpanStep` whose output is the decode
    carry's ``out``) and ``step`` (the decode step, a `GenerateStep`), their graphs in
    one pool. `run` decodes one prompt into ``step.out``."""

    def __init__(self, params, config, P, S, n_new, temperature, top_k, top_p, generator,
                 cache_dtype, quantize_kv, dev, mesh, capture: bool):
        self.cache = init_kv_cache(block_config(config, mesh), 1, S, cache_dtype,
                                   quantized=quantize_kv, device=dev)
        pool = torch.cuda.graph_pool_handle() if capture else None
        self.step = _step(params, config, self.cache, n_new, temperature, top_k, top_p,
                          generator, dev, mesh, capture, pool)
        step = self.step

        def sample(logits):
            return sample_token(logits, temperature, top_k, top_p, generator)

        body = functools.partial(prefill_body, params, config, self.cache,
                                 torch.arange(P, device=dev), sample, dev, mesh, step.tok,
                                 step.pos, step.step)
        self.span = SpanStep(dev, body, None, None, capture=capture, pool=pool,
                             generator=generator if temperature > 0 else None, out=step.out)

    def run(self, padded: np.ndarray, T: int, n_steps: int) -> None:
        """Prefill ``padded`` ``(1, P)`` (T real tokens), then ``n_steps`` decode
        steps."""
        self.span.run((), prompt=padded, T=np.array([T], np.int64))
        self.step.start(T)
        for _ in range(n_steps):
            self.step.run()


PROGRAMS = HeldPrograms()  # `generate`'s programs, held across calls


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
    ``device``. The call runs the held program of its key (``PROGRAMS``; built at the
    key's first call, which on a CUDA device captures the prefill span and the decode
    step, each graph's first run being its eager warm-up; a later call replays them);
    ``cuda_graph=False`` and ``mesh`` run a fresh program eagerly, which holds nothing.
    `infer/decode_graph.release_programs` frees the held programs.
    """
    dev = resolve_device(device)
    prompt = np.asarray(prompt).astype(np.int64)
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
    padded = np.zeros((1, P), dtype=np.int64)
    padded[0, :T] = prompt
    n_new, kv = max(max_new_tokens, 1), normalize_kv_mode(quantize_kv)
    args = (params, config, P, S, n_new, temperature, top_k, top_p, generator, cache_dtype, kv,
            dev, mesh)
    if mesh is not None or not cuda_graph:
        program = GenerateProgram(*args, capture=False)
    else:
        key = (config, P, S, n_new, temperature, top_k, top_p, cache_dtype, kv, dev,
               generator if temperature > 0 else None)  # a greedy program draws nothing
        program = PROGRAMS.get(Bound(params), key,
                               lambda: GenerateProgram(*args, capture=dev.type == "cuda"))
    program.run(padded, T, max_new_tokens - 1)
    out = program.step.out.cpu().numpy().astype(np.int32)
    if eos_id is not None:
        hits = np.nonzero(out == eos_id)[0]
        if hits.size:
            out = out[: hits[0] + 1]  # include the EOS token
    return np.concatenate([prompt.astype(np.int32), out])
