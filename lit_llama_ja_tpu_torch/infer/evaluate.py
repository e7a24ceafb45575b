"""Perplexity evaluation (counterpart of `lit_llama_ja_tpu/infer/evaluate.py`; reference
`evaluate/full.py`).

Protocol: stride the token stream in `block_size` windows, sum the token NLL and
report ``exp(sum_nll / n_tokens)`` (reference `evaluate/full.py:117-128`, the GPTQ
paper's protocol). `decode_path_perplexity` is the same quantity teacher-forced
through the cached decode path, so KV-cache quantization shows in it.

The parameters are used in their own dtype: on the card, cast them to bf16 first
(`models/llama.cast_params`), since the kernels take bf16 activations.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import DecodeGraph
from lit_llama_ja_tpu_torch.models import llama
from lit_llama_ja_tpu_torch.train.loss import token_nll_sum


def window_nll_body(params, config: LLaMAConfig, device, *, chunk, out) -> None:
    """One window's forward and `token_nll_sum` (the JAX package's `_window_nll`) over a
    static ``(1, window + 1)`` token buffer ``chunk``: the window's summed NLL and token
    count go to ``out`` ``(2,)`` f32. It reads nothing back to the host."""
    nll, cnt = token_nll_sum(llama.forward(params, chunk[:, :-1], config, device=device),
                             chunk[:, 1:])
    out.copy_(torch.stack([nll, cnt.float()]))


@torch.no_grad()
def perplexity(
    params,
    config: LLaMAConfig,
    tokens: np.ndarray,
    *,
    window: Optional[int] = None,
    forward_fn: Optional[Callable] = None,
    progress: bool = False,
    device="cuda",
    cuda_graph: bool = True,
) -> float:
    """Perplexity of a flat token stream under the model: ``(len - 1) // window``
    windows, each predicting its tokens 1..window from 0..window-1. With the default
    forward a window is one device program (`window_nll_body`) over a static token
    buffer, on a CUDA device captured once and replayed a window (``cuda_graph=False``:
    eager); a caller's ``forward_fn`` runs eagerly. One read a window: its NLL and
    count."""
    dev = resolve_device(device)
    window = window or config.block_size
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
    n = (len(tokens) - 1) // window
    graph = None
    if forward_fn is None:
        chunk = torch.zeros((1, window + 1), dtype=torch.long, device=dev)
        out = torch.zeros((2,), dtype=torch.float32, device=dev)
        graph = DecodeGraph(functools.partial(window_nll_body, params, config, dev, chunk=chunk,
                                              out=out),
                            dev, capture=dev.type == "cuda" and cuda_graph)
    total_nll, total_toks = 0.0, 0
    for i in range(n):
        span = tokens[i * window : i * window + window + 1][None]
        if graph is None:
            span = span.to(dev)
            nll, cnt = token_nll_sum(forward_fn(params, span[:, :-1], config), span[:, 1:])
        else:
            chunk.copy_(span)
            graph.run()
            nll, cnt = out.tolist()
        total_nll += float(nll)
        total_toks += int(cnt)
        if progress and i % 10 == 0:
            print(f"window {i}/{n} running ppl {np.exp(total_nll / max(total_toks, 1)):.3f}")
    return float(np.exp(total_nll / max(total_toks, 1)))


def decode_nll_body(params, config: LLaMAConfig, cache, device, *, seq, t, nll) -> None:
    """One teacher-forced step of the JAX package's ``window_nll`` scan over static
    buffers: token ``seq[t]`` at the device position ``t`` ``(1,)`` through
    `forward_with_cache`, ``-log p(seq[t + 1])`` added to ``nll`` ``(1,)`` f32, then
    ``t`` advanced. It reads nothing back to the host."""
    logits, _ = llama.forward_with_cache(params, seq.index_select(0, t).view(1, 1), t, cache,
                                         config, device=device, roll=False)
    logp = torch.log_softmax(logits[0, 0].float(), dim=-1)
    nll.sub_(logp.index_select(0, seq.index_select(0, t + 1)))
    t.add_(1)


@torch.no_grad()
def decode_path_perplexity(
    params,
    config: LLaMAConfig,
    tokens: np.ndarray,
    *,
    quantize_kv=False,
    windows: int = 12,
    window: Optional[int] = None,
    seed: int = 11,
    device="cuda",
    cuda_graph: bool = True,
) -> float:
    """Teacher-forced perplexity through the cached decode path: every logit comes
    from `forward_with_cache` reading the (possibly quantized) KV cache, one token at
    a time. ``quantize_kv``: False | "int8" | "int4". ``windows`` windows of
    ``window`` tokens are sampled from the stream with a seeded numpy generator, the
    JAX package's choice of windows. A token is one device program
    (`decode_nll_body`), on a CUDA device captured once and replayed ``window`` times a
    window (``cuda_graph=False``: eager); every window reuses one cache, reset, and the
    host reads the NLL once a window."""
    dev = resolve_device(device)
    T = window or config.block_size
    if len(tokens) < T + 1:
        raise ValueError(
            f"decode_path_perplexity needs at least window+1={T + 1} tokens, "
            f"got {len(tokens)}; pass a smaller --kv-window or a longer stream"
        )
    rng = np.random.default_rng(seed)
    n = min(windows, max(1, (len(tokens) - 1) // T))
    hi = len(tokens) - T - 1
    ix = rng.integers(0, hi, size=n) if hi > 0 else np.zeros(n, np.int64)
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
    cache = llama.init_kv_cache(config, 1, T, torch.float32, quantized=quantize_kv, device=dev)
    seq = torch.zeros((T + 1,), dtype=torch.long, device=dev)
    t = torch.zeros((1,), dtype=torch.long, device=dev)
    nll = torch.zeros((1,), dtype=torch.float32, device=dev)
    graph = DecodeGraph(functools.partial(decode_nll_body, params, config, cache, dev, seq=seq,
                                          t=t, nll=nll),
                        dev, capture=dev.type == "cuda" and cuda_graph)
    total = 0.0
    for i in ix:
        for key, buf in cache.items():  # as `init_kv_cache` made it
            buf.fill_(1 if key.endswith("_scale") else 0)
        t.zero_()
        nll.zero_()
        seq.copy_(tokens[int(i) : int(i) + T + 1])
        for _ in range(T):
            graph.run()
        total += float(nll.item())
    return float(np.exp(total / (n * T)))


def load_eval_dataset(name: str, tokenizer, split: str = "test") -> np.ndarray:
    """Load and tokenize an eval corpus (reference `evaluate/full.py:23-43`): a path to
    a text file (absolute, relative, or ending in ``.txt``) is read directly, so the
    evaluation runs offline; wikitext-2 / ptb / c4 come from HF ``datasets`` and need
    the network."""
    import os

    if name.endswith(".txt") or os.path.exists(name):
        with open(name, encoding="utf-8") as f:
            text = f.read()
        return tokenizer.encode(text, bos=True, eos=False)

    from datasets import load_dataset

    if name == "wikitext":
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        text = "\n\n".join(ds["text"])
    elif name == "ptb":
        ds = load_dataset("ptb_text_only", "penn_treebank", split="validation")
        text = " ".join(ds["sentence"])
    elif name == "c4":
        ds = load_dataset(
            "allenai/c4",
            data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
            split="validation",
        )
        text = " ".join(ds[:1100]["text"])
    else:
        raise ValueError(f"unknown dataset {name}")
    return tokenizer.encode(text, bos=True, eos=False)
