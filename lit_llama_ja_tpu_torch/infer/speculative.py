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
(`_spec_generate_jit`, a ``lax.while_loop`` over rounds); here the prefill runs eagerly
and every round is one device program over the loop's carry on the device
(`spec_generate_round`): on a CUDA device it is captured in a CUDA graph once and
replayed, and the host reads two numbers back a round, the count of tokens and the eos
flag, to test the loop's condition, and the tokens once, at the end.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import DecodeGraph
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.models.llama import block_config, forward_with_cache, init_kv_cache
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
    cache stays ``cache_dtype``. ``generator`` (on ``device``) drives sampling.
    ``stats_out`` receives {"rounds", "tokens", "accepted", "acceptance"}. Returns
    ``prompt + generated`` as numpy (truncated after ``eos_id``). ``mesh``: both models
    are this rank's slices and run sharded (`infer/generate.generate`), every round's
    body eagerly. On a CUDA device without a mesh the rounds replay one captured round;
    ``cuda_graph=False`` runs every round's body eagerly, which only a comparison of the
    two needs."""
    dev = resolve_device(device)
    prompt = np.asarray(prompt).astype(np.int32)
    T = int(prompt.shape[0])
    limit = min(tcfg.block_size, dcfg.block_size)
    P = min(bucket_length(T), limit)
    S = min(P + max_new_tokens + K + 1, limit)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tcache = init_kv_cache(block_config(tcfg, mesh), 1, S, cache_dtype, quantized=quantize_kv,
                           device=dev)
    dcache = init_kv_cache(block_config(dcfg, mesh), 1, S, cache_dtype, device=dev)
    padded = torch.zeros((1, P), dtype=torch.long)
    padded[0, :T] = torch.from_numpy(prompt.astype(np.int64))
    padded = padded.to(dev)
    tlogits, _ = forward_with_cache(tparams, padded, torch.arange(P), tcache, tcfg,
                                    prefill_attn=True, device=dev, mesh=mesh)
    forward_with_cache(dparams, padded, torch.arange(P), dcache, dcfg, prefill_attn=True,
                       device=dev, mesh=mesh)
    first = _draw(_dist(tlogits[0, T - 1], temperature, top_k, top_p), generator).view(1)

    # the JAX loop's carry on the device; the host keeps (count, done) for its condition
    def state(value, dtype=torch.long):
        return torch.full((1,), value, dtype=dtype, device=dev)

    out = torch.zeros((max_new_tokens + K + 1,), dtype=torch.long, device=dev)
    out[:1] = first
    count, pos, prev = state(1), state(T), state(int(prompt[max(T - 1, 0)]))
    last = first.clone()
    done = (first == eos_id) if eos_id is not None else state(False, torch.bool)
    status = torch.cat([count, done.long()])
    body = functools.partial(spec_generate_round, tparams, dparams, tcache, dcache, generator,
                             tcfg, dcfg, K, temperature, top_k, top_p, eos_id, dev, mesh, out,
                             count, pos, prev, last, done, status)
    graph = DecodeGraph(body, dev, capture=dev.type == "cuda" and mesh is None and cuda_graph,
                        generators=[generator])
    (n, stop), rounds = status.tolist(), 0
    while n < max_new_tokens and T + n + K < S and not stop:
        graph.run()
        rounds += 1
        n, stop = status.tolist()
    out = out[:min(n, max_new_tokens)].tolist()
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    if stats_out is not None:
        # acceptance from the untruncated count: every round emits its accepted
        # drafts and one more token, and the first token came from the prefill
        accepted = max(n - 1 - rounds, 0)
        stats_out.update(rounds=rounds, tokens=max(len(out) - 1, 0), accepted=accepted,
                         acceptance=(accepted / (rounds * K)) if rounds else 0.0)
    return np.concatenate([prompt, np.asarray(out, np.int32)])
