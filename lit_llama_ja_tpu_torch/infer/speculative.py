"""Speculative decoding with a draft model and exact target-distribution verification
(counterpart of `lit_llama_ja_tpu/infer/speculative.py`; the Leviathan et al. rejection
scheme).

A small draft model proposes K tokens, the target verifies all K + 1 positions in one
forward, and the modified rejection sampler keeps the output distribution exactly the
target's: with temperature 0 the emitted sequence is the target's greedy sequence
whatever the draft proposes.

Cache bookkeeping, as in the JAX package: the target writes k/v for (last, drafts) at
``pos .. pos + K`` in its verify forward, and the rejected suffix stays in the cache
past the accepted point, masked until overwritten; the draft consumes the pair
(prev, last) before drafting, which fills the one-position hole a fully accepted round
leaves in its cache. The JAX package compiles the whole loop into one program
(`_spec_generate_jit`, the prefills, the first draw and a ``lax.while_loop`` over
rounds), which its jit cache keeps across calls. Here a call runs a `SpecProgram`, held
across calls in ``PROGRAMS`` (`infer/decode_graph.HeldPrograms`) under the jit's static
arguments (both configs, K, max_new_tokens, S, temperature, top-k, top-p, eos_id), the
target cache's dtype and KV mode, the prompt's bucket, the generator and both models'
param leaves. It owns the staging buffers, both caches, the loop's carry on the device
and two device programs in one pool: the prefill span (`spec_prefill_body`: both caches
reset and prefilled, the first draw, the carry reset) and the round
(`spec_generate_round`). On a CUDA device each is captured in a CUDA graph at the key's
first call and replayed after that; the host reads two numbers back a round, the count
of tokens and the eos flag, to test the loop's condition, and the tokens once, at the
end.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import Bound, DecodeGraph, HeldPrograms, SpanStep
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.models.llama import (
    block_config,
    forward_with_cache,
    init_kv_cache,
    normalize_kv_mode,
    reset_kv_cache,
)
from lit_llama_ja_tpu_torch.ops.sampling import categorical, top_p_filter


def _dist(logits: torch.Tensor, temperature: float, top_k: Optional[int],
          top_p: Optional[float] = None) -> torch.Tensor:
    """The sampling distribution as an explicit probability vector over the last axis,
    with `ops/sampling.sample_token`'s filter order (temperature, top-k, top-p);
    temperature 0 is a point mass on the argmax."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.nn.functional.one_hot(torch.argmax(logits, -1), logits.shape[-1]).float()
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    return torch.softmax(logits, dim=-1)


def _draw(probs: torch.Tensor, generator) -> torch.Tensor:
    """One token from each row of ``probs`` (a point mass gives its token exactly):
    `ops/sampling.categorical`, multinomial's draw without its host check."""
    flat = probs.reshape(-1, probs.shape[-1])
    return categorical(flat, generator).reshape(probs.shape[:-1])


def _residual(p_t_at, p_d_at):
    """The rejection point's distribution ``norm(max(p_t - p_d, 0))``, or ``p_t`` where
    nothing is left."""
    resid = torch.clamp(p_t_at - p_d_at, min=0.0)
    rs = resid.sum(-1, keepdim=True)
    return torch.where(rs > 1e-30, resid / torch.clamp(rs, min=1e-30), p_t_at)


def _spec_round(tparams, dparams, prev_tok, last_tok, tcache, dcache, pos, generator,
                tcfg: LLaMAConfig, dcfg: LLaMAConfig, K: int, temperature: float,
                top_k: Optional[int], top_p: Optional[float], device, mesh=None):
    """One draft-verify round over device state: ``prev_tok``, ``last_tok`` and ``pos``
    (the position of ``last_tok``) are ``(1,)`` int64 tensors on the device. Returns
    ``(tokens (K+1,), n_out (1,))`` on the device: ``tokens[:n_out]`` are the newly
    emitted tokens (the accepted drafts and one token the target sampled). Both caches
    are written in place; nothing is read back to the host."""
    dev = device

    def fwd(params, toks, positions, cache, cfg):
        return forward_with_cache(params, toks.view(1, -1), positions, cache, cfg, device=dev,
                                  mesh=mesh, roll=False)[0][0]

    # draft: the pair (prev, last), then K - 1 single steps
    pair_pos = pos - 1 + torch.arange(2, device=pos.device)
    logits = fwd(dparams, torch.cat([prev_tok, last_tok]), pair_pos, dcache, dcfg)
    p_d = [_dist(logits[-1], temperature, top_k, top_p)]
    drafts = [_draw(p_d[0], generator).view(1)]
    for i in range(1, K):
        logits = fwd(dparams, drafts[-1], pos + i, dcache, dcfg)
        p_d.append(_dist(logits[-1], temperature, top_k, top_p))
        drafts.append(_draw(p_d[-1], generator).view(1))
    draft_toks = torch.cat(drafts)  # (K,)
    p_d = torch.stack(p_d)  # (K, V); drafts[i] ~ p_d[i]

    # target: verify all K + 1 positions in one forward
    tin = torch.cat([last_tok, draft_toks])
    tpos = pos + torch.arange(K + 1, device=pos.device)
    p_t = _dist(fwd(tparams, tin, tpos, tcache, tcfg), temperature, top_k, top_p)  # (K+1, V)

    # acceptance: the vectorized rejection chain, n_acc on the device
    u = torch.rand(K, generator=generator, device=dev)
    pt_x = p_t[:K].gather(1, draft_toks[:, None])[:, 0]
    pd_x = p_d.gather(1, draft_toks[:, None])[:, 0]
    accept = u < torch.clamp(pt_x / torch.clamp(pd_x, min=1e-30), max=1.0)
    n_acc = torch.cumprod(accept.long(), 0).sum().view(1)
    p_t_at = p_t.index_select(0, n_acc)[0]
    p_d_at = torch.where(n_acc == K, torch.zeros_like(p_t_at),
                         p_d.index_select(0, n_acc.clamp(max=K - 1))[0])
    final = _draw(_residual(p_t_at, p_d_at), generator).view(1)
    tokens = torch.cat([draft_toks, final])
    return tokens.index_copy(0, n_acc, final), n_acc + 1


def spec_generate_round(tparams, dparams, tcache, dcache, generator, tcfg: LLaMAConfig,
                        dcfg: LLaMAConfig, K: int, temperature: float, top_k: Optional[int],
                        top_p: Optional[float], eos_id: Optional[int], device, mesh,
                        out, count, pos, prev, last, done, status) -> None:
    """The body of the JAX package's ``lax.while_loop`` over rounds
    (`_spec_generate_jit`'s ``body``) over device state, all ``(1,)`` int64 but ``out``
    (the emitted tokens) and ``done`` (bool): one round, its tokens written into ``out``
    at ``count``, then ``count``, ``pos``, ``prev``, ``last`` and ``done`` advanced, and
    ``(count, done)`` written into ``status`` for the host's test of the loop's
    condition. It reads nothing back to the host."""
    tokens, n_out = _spec_round(tparams, dparams, prev, last, tcache, dcache, pos, generator,
                                tcfg, dcfg, K, temperature, top_k, top_p, device, mesh)
    out.index_copy_(0, count + torch.arange(K + 1, device=out.device), tokens)
    if eos_id is not None:
        emitted = torch.arange(K + 1, device=out.device) < n_out
        done.logical_or_(((tokens == eos_id) & emitted).any().view(1))
    prev.copy_(torch.where(n_out >= 2, tokens.index_select(0, (n_out - 2).clamp(min=0)), last))
    last.copy_(tokens.index_select(0, n_out - 1))
    count.add_(n_out)
    pos.add_(n_out)
    status.copy_(torch.cat([count, done.long()]))


def spec_prefill_body(tparams, dparams, tcache, dcache, positions, generator,
                      tcfg: LLaMAConfig, dcfg: LLaMAConfig, temperature: float,
                      top_k: Optional[int], top_p: Optional[float], eos_id: Optional[int],
                      device, mesh, count, pos, prev, last, done, status, *,
                      out, prompt, T) -> None:
    """`_spec_generate_jit`'s prologue over device state: both caches reset (JAX's
    `init_kv_cache` on every call) and prefilled with ``prompt`` ``(1, P)``, the first
    token drawn from the target's logits at the device index ``T - 1`` (``T`` ``(1,)``),
    then the loop's carry reset: ``out`` zeros but the token at 0, ``count`` 1, ``pos``
    ``T``, ``prev`` the last prompt token, ``last`` the first token, ``done`` whether it
    is ``eos_id``, and ``status`` (count, done). It reads nothing back to the host."""
    for cache in (tcache, dcache):
        reset_kv_cache(cache)
    tlogits = forward_with_cache(tparams, prompt, positions, tcache, tcfg, prefill_attn=True,
                                 device=device, mesh=mesh, roll=False)[0]
    forward_with_cache(dparams, prompt, positions, dcache, dcfg, prefill_attn=True,
                       device=device, mesh=mesh, roll=False)
    first = _draw(_dist(tlogits[0].index_select(0, T - 1)[0], temperature, top_k, top_p),
                  generator).view(1)
    out.zero_()
    out[:1] = first
    count.fill_(1)
    pos.copy_(T)
    prev.copy_(prompt[0].index_select(0, (T - 1).clamp(min=0)))
    last.copy_(first)
    if eos_id is None:
        done.fill_(False)
    else:
        done.copy_(first == eos_id)
    status.copy_(torch.cat([count, done.long()]))


class SpecProgram:
    """One key's program of `speculative_generate` (see the module docstring): the
    target cache ``tcache`` (quantized as asked) and the draft's ``dcache``
    (``cache_dtype``), both of S slots; ``span`` (the prologue, a `SpanStep` whose
    output is the carry's ``out``) and ``round`` (a `DecodeGraph` of
    `spec_generate_round`), their graphs in one pool. Without a ``generator`` it draws
    from one of its own, seeded 0 at every call, as the JAX package draws from
    ``PRNGKey(0)``. `run` prefills a prompt; the caller runs the rounds."""

    def __init__(self, tparams, dparams, tcfg, dcfg, P, S, K, max_new_tokens, temperature,
                 top_k, top_p, eos_id, generator, cache_dtype, quantize_kv, dev, mesh,
                 capture: bool):
        self.seeded = generator is None
        self.generator = torch.Generator(device=dev) if generator is None else generator
        self.tcache = init_kv_cache(block_config(tcfg, mesh), 1, S, cache_dtype,
                                    quantized=quantize_kv, device=dev)
        self.dcache = init_kv_cache(block_config(dcfg, mesh), 1, S, cache_dtype, device=dev)

        # the JAX loop's carry on the device; the host reads (count, done) a round
        def state(dtype=torch.long):
            return torch.zeros((1,), dtype=dtype, device=dev)

        out = torch.zeros((max_new_tokens + K + 1,), dtype=torch.long, device=dev)
        carry = (state(), state(), state(), state(), state(torch.bool))
        self.status = torch.zeros((2,), dtype=torch.long, device=dev)
        models = (tparams, dparams, self.tcache, self.dcache)
        pool = torch.cuda.graph_pool_handle() if capture else None
        span = functools.partial(spec_prefill_body, *models, torch.arange(P, device=dev),
                                 self.generator, tcfg, dcfg, temperature, top_k, top_p, eos_id,
                                 dev, mesh, *carry, self.status)
        self.span = SpanStep(dev, span, None, None, capture=capture, pool=pool,
                             generator=self.generator, out=out)
        body = functools.partial(spec_generate_round, *models, self.generator, tcfg, dcfg, K,
                                 temperature, top_k, top_p, eos_id, dev, mesh, out, *carry,
                                 self.status)
        self.round = DecodeGraph(body, dev, capture=capture, pool=pool,
                                 generators=[self.generator])

    def run(self, padded: np.ndarray, T: int) -> None:
        """The prologue over ``padded`` ``(1, P)`` (T real tokens)."""
        if self.seeded:
            self.generator.manual_seed(0)
        self.span.run((), prompt=padded, T=np.array([T], np.int64))


PROGRAMS = HeldPrograms()  # `speculative_generate`'s programs, held across calls


@torch.no_grad()
def speculative_generate(
    tparams,
    tcfg: LLaMAConfig,
    dparams,
    dcfg: LLaMAConfig,
    prompt,
    max_new_tokens: int,
    *,
    K: int = 4,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: torch.dtype = torch.float32,
    quantize_kv=False,
    stats_out: Optional[dict] = None,
    device="cuda",
    mesh=None,
    cuda_graph: bool = True,
) -> np.ndarray:
    """Generate with draft-model speculation; the output distribution is the target's.

    Both models must share the tokenizer and vocabulary. Generation stops K short of
    the cache capacity (a round writes K + 1 positions and never rolls the cache).
    ``quantize_kv`` (False | "int8" | "int4") quantizes the TARGET cache; the draft
    cache stays ``cache_dtype``. ``generator`` (on ``device``) drives sampling; without
    one the draws start from seed 0 at every call. ``stats_out`` receives {"rounds",
    "tokens", "accepted", "acceptance"}. Returns ``prompt + generated`` as numpy
    (truncated after ``eos_id``). ``mesh``: both models are this rank's slices and run
    sharded (`infer/generate.generate`). The call runs the held program of its key
    (``PROGRAMS``; on a CUDA device its first call captures the prologue and the round,
    later calls replay them); ``cuda_graph=False`` and ``mesh`` run a fresh program
    eagerly, which holds nothing."""
    dev = resolve_device(device)
    prompt = np.asarray(prompt).astype(np.int32)
    T = int(prompt.shape[0])
    limit = min(tcfg.block_size, dcfg.block_size)
    P = min(bucket_length(T), limit)
    S = min(P + max_new_tokens + K + 1, limit)
    padded = np.zeros((1, P), dtype=np.int64)
    padded[0, :T] = prompt
    kv = normalize_kv_mode(quantize_kv)
    args = (tparams, dparams, tcfg, dcfg, P, S, K, max_new_tokens, temperature, top_k, top_p,
            eos_id, generator, cache_dtype, kv, dev, mesh)
    if mesh is not None or not cuda_graph:
        program = SpecProgram(*args, capture=False)
    else:
        key = (tcfg, dcfg, P, S, K, max_new_tokens, temperature, top_k, top_p, eos_id,
               cache_dtype, kv, dev, generator)
        program = PROGRAMS.get(Bound(tparams, dparams), key,
                               lambda: SpecProgram(*args, capture=dev.type == "cuda"))
    program.run(padded, T)
    (n, stop), rounds = program.status.tolist(), 0
    while n < max_new_tokens and T + n + K < S and not stop:
        program.round.run()
        rounds += 1
        n, stop = program.status.tolist()
    out = program.span.out[:min(n, max_new_tokens)].tolist()
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    if stats_out is not None:
        # acceptance from the untruncated count: every round emits its accepted
        # drafts and one more token, and the first token came from the prefill
        accepted = max(n - 1 - rounds, 0)
        stats_out.update(rounds=rounds, tokens=max(len(out) - 1, 0), accepted=accepted,
                         acceptance=(accepted / (rounds * K)) if rounds else 0.0)
    return np.concatenate([prompt, np.asarray(out, np.int32)])
