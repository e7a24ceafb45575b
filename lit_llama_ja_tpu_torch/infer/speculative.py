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
leaves in its cache. The JAX package compiles the whole loop into one program; here it
is a host loop with one device-to-host read per round.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.models.llama import block_config, forward_with_cache, init_kv_cache
from lit_llama_ja_tpu_torch.ops.sampling import top_p_filter


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
    """One token from each row of ``probs`` (a point mass gives its token exactly)."""
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def _residual(p_t_at, p_d_at):
    """The rejection point's distribution ``norm(max(p_t - p_d, 0))``, or ``p_t`` where
    nothing is left."""
    resid = torch.clamp(p_t_at - p_d_at, min=0.0)
    rs = resid.sum(-1, keepdim=True)
    return torch.where(rs > 1e-30, resid / torch.clamp(rs, min=1e-30), p_t_at)


def _spec_round(tparams, dparams, prev_tok: int, last_tok: int, tcache, dcache, pos: int,
                generator, tcfg: LLaMAConfig, dcfg: LLaMAConfig, K: int, temperature: float,
                top_k: Optional[int], top_p: Optional[float], device, mesh=None):
    """One draft-verify round. Returns ``(tokens (K+1,), n_out)`` on the host:
    ``tokens[:n_out]`` are the newly emitted tokens (the accepted drafts and one token
    the target sampled). Both caches are written in place."""
    dev = device

    def fwd(params, toks, first, cache, cfg):
        idx = torch.as_tensor(toks, dtype=torch.long, device=dev)[None]
        return forward_with_cache(params, idx, torch.arange(first, first + idx.shape[1]),
                                  cache, cfg, device=dev, mesh=mesh)[0][0]

    # draft: the pair (prev, last), then K - 1 single steps
    logits = fwd(dparams, [prev_tok, last_tok], pos - 1, dcache, dcfg)
    p_d = [_dist(logits[-1], temperature, top_k, top_p)]
    drafts = [_draw(p_d[0], generator)]
    for i in range(1, K):
        logits = fwd(dparams, drafts[-1].view(1), pos + i, dcache, dcfg)
        p_d.append(_dist(logits[-1], temperature, top_k, top_p))
        drafts.append(_draw(p_d[-1], generator))
    draft_toks = torch.stack(drafts)  # (K,)
    p_d = torch.stack(p_d)  # (K, V); drafts[i] ~ p_d[i]

    # target: verify all K + 1 positions in one forward
    tin = torch.cat([torch.tensor([last_tok], device=dev), draft_toks])
    p_t = _dist(fwd(tparams, tin, pos, tcache, tcfg), temperature, top_k, top_p)  # (K+1, V)

    # acceptance: the vectorized rejection chain
    u = torch.rand(K, generator=generator, device=dev)
    pt_x = p_t[:K].gather(1, draft_toks[:, None])[:, 0]
    pd_x = p_d.gather(1, draft_toks[:, None])[:, 0]
    accept = u < torch.clamp(pt_x / torch.clamp(pd_x, min=1e-30), max=1.0)
    n_acc = int(torch.cumprod(accept.int(), 0).sum())
    p_d_at = torch.zeros_like(p_t[0]) if n_acc == K else p_d[n_acc]
    final = _draw(_residual(p_t[n_acc], p_d_at), generator)
    tokens = torch.cat([draft_toks, final.view(1)]).cpu().numpy()
    tokens[n_acc] = tokens[K]
    return tokens, n_acc + 1


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
) -> np.ndarray:
    """Generate with draft-model speculation; the output distribution is the target's.

    Both models must share the tokenizer and vocabulary. Generation stops K short of
    the cache capacity (a round writes K + 1 positions and never rolls the cache).
    ``quantize_kv`` (False | "int8" | "int4") quantizes the TARGET cache; the draft
    cache stays ``cache_dtype``. ``generator`` (on ``device``) drives sampling.
    ``stats_out`` receives {"rounds", "tokens", "accepted", "acceptance"}. Returns
    ``prompt + generated`` as numpy (truncated after ``eos_id``). ``mesh``: both models
    are this rank's slices and run sharded (`infer/generate.generate`)."""
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
    first = int(_draw(_dist(tlogits[0, T - 1], temperature, top_k, top_p), generator))

    out, rounds = [first], 0
    pos, prev, last = T, int(prompt[max(T - 1, 0)]), first
    done = eos_id is not None and first == eos_id
    while len(out) < max_new_tokens and pos + K + 1 < S and not done:
        tokens, n_out = _spec_round(tparams, dparams, prev, last, tcache, dcache, pos,
                                    generator, tcfg, dcfg, K, temperature, top_k, top_p, dev,
                                    mesh)
        emitted = [int(t) for t in tokens[:n_out]]
        out.extend(emitted)
        rounds += 1
        done = eos_id is not None and eos_id in emitted
        prev = emitted[-2] if n_out >= 2 else last
        last = emitted[-1]
        pos += n_out
    count = len(out)
    out = out[:max_new_tokens]
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    if stats_out is not None:
        # acceptance from the untruncated count: every round emits its accepted
        # drafts and one more token, and the first token came from the prefill
        accepted = max(count - 1 - rounds, 0)
        stats_out.update(rounds=rounds, tokens=max(len(out) - 1, 0), accepted=accepted,
                         acceptance=(accepted / (rounds * K)) if rounds else 0.0)
    return np.concatenate([prompt, np.asarray(out, np.int32)])
