"""Blockwise GPTQ calibration and LLM.int8 quantization of a whole model
(counterpart of `lit_llama_ja_tpu/quant/pipeline.py`; reference `quantize/gptq.py`).

Sequential by construction, as in the reference: each linear's input Hessian is
collected with the block's previously quantized linears active, so later layers
calibrate against the quantized network they will run in. Activations stream through
in micro-batches and one layer's Hessian (K², f32) is live at a time. On CUDA the
activations are bf16 (the kernels take bf16) and every Hessian accumulates in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.models.llama import _qkv, apply_linear, transformer_block, unstack_layers
from lit_llama_ja_tpu_torch.ops.attention import causal_attention
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.ops.rope import build_rope_cache
from lit_llama_ja_tpu_torch.quant.gptq import (
    GPTQGraphs,
    gptq_quantize_linear,
    hessian_update,
    init_hessian,
)
from lit_llama_ja_tpu_torch.quant.linear import (
    quantize_int8_absmax,
    quantize_int8_dynamic,
    quantize_int8_outlier,
    resolve_bits,
    resolve_groupsize,
)

SUBMODULES = ("attn.c_attn", "attn.c_proj", "mlp.c_fc1", "mlp.c_fc2", "mlp.c_proj")


@torch.no_grad()
def capture_linear_input(block_params, x, rope, config: LLaMAConfig, name: str):
    """The activations feeding linear ``name`` inside one transformer block, given
    the block's *current* (possibly partially quantized) parameters."""
    h1 = rmsnorm(x, block_params["rms_1"]["scale"], config.norm_eps)
    if name == "attn.c_attn":
        return h1
    B, T, C = x.shape
    q, k, v = _qkv(block_params["attn"], h1, config.n_head, rope)
    y = causal_attention(q, k, v).transpose(1, 2).reshape(B, T, C)
    if name == "attn.c_proj":
        return y
    x2 = x + apply_linear(block_params["attn"]["c_proj"], y)
    h2 = rmsnorm(x2, block_params["rms_2"]["scale"], config.norm_eps)
    if name in ("mlp.c_fc1", "mlp.c_fc2"):
        return h2
    if name != "mlp.c_proj":
        raise ValueError(f"unknown submodule {name!r}")
    return F.silu(apply_linear(block_params["mlp"]["c_fc1"], h2)) * apply_linear(
        block_params["mlp"]["c_fc2"], h2
    )


@torch.no_grad()
def block_forward(block_params, x, rope, config: LLaMAConfig):
    return transformer_block(block_params, x, rope, config)[0]


def _get(tree, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _set(tree, dotted: str, value):
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _stack(trees):
    """Per-layer trees -> one tree of stacked tensors (the inverse of `unstack_layers`)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _copy_tree(tree):
    """New dicts down to the leaves; the leaves themselves are shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


@torch.no_grad()
def gptq_quantize_model(
    params,
    config: LLaMAConfig,
    calib_tokens,  # (n_samples, T) int
    *,
    bits=4,  # int, or the mixed-mode {"attn","mlp","head"} dict
    groupsize: int = -1,
    blocksize: int = 128,
    percdamp: float = 0.01,
    micro_batch: int = 8,
    compute_dtype: Optional[torch.dtype] = None,
    quantize_lm_head: bool = True,
    progress: bool = True,
    solve_times: Optional[list] = None,
    cuda_graph: bool = True,
):
    """Quantize every linear of the model with GPTQ; returns a new param tree where
    each ``{"weight"}`` linear becomes a packed ``{"qweight","scales","zeros"}`` leaf.

    actorder is on iff the (per-projection) groupsize is -1, as in
    `quantize/gptq.py:86`. ``bits`` is an int or a mixed-mode dict
    (`quant/linear.py::parse_quant_mode`); in mixed mode ``groupsize`` applies to the
    sub-4-bit projections only. ``compute_dtype`` of the activations defaults to
    bf16 on CUDA and f32 on the CPU. ``solve_times``, when given, receives
    ``(name, seconds)`` for each solve (on CUDA after a synchronize).

    Every solve runs its blocks' column loops in one `GPTQGraphs` set, captured on a
    CUDA device with ``cuda_graph`` (a graph a block shape, reused over the layers),
    freed before the function returns. The calibration forwards and the Hessian
    updates stay eager: a few large products a micro-batch.
    """
    import time

    dev = params["wte"]["weight"].device
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    calib_tokens = torch.as_tensor(calib_tokens, device=dev).long()
    n_samples, T = calib_tokens.shape
    rope = build_rope_cache(config.block_size, config.head_dim, config.rope_base,
                            device=dev)[:T]

    # token embedding -> first block inputs (reference quantize/gptq.py:49-52)
    inps = params["wte"]["weight"][calib_tokens].to(compute_dtype)

    capture = cuda_graph and dev.type == "cuda"
    graphs = GPTQGraphs(dev, capture=capture)

    def solve(w, H, name: str):
        gs = resolve_groupsize(bits, name, groupsize)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = gptq_quantize_linear(
            w, H, bits=resolve_bits(bits, name), blocksize=blocksize, percdamp=percdamp,
            groupsize=gs, actorder=gs == -1, graphs=graphs, cuda_graph=capture,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if solve_times is not None:
            solve_times.append((name, time.perf_counter() - t0))
        return out

    try:
        quantized_layers = []
        for layer, block in enumerate(unstack_layers(params["blocks"], config.n_layer)):
            block = _copy_tree(block)
            for name in SUBMODULES:
                w = _get(block, name)["weight"]  # (K, N)
                H, n = init_hessian(w.shape[0], device=dev)
                for s in range(0, n_samples, micro_batch):
                    acts = capture_linear_input(block, inps[s : s + micro_batch], rope, config,
                                                name)
                    H, n = hessian_update(H, n, acts.reshape(-1, acts.shape[-1]))
                qparams, err = solve(w.float(), H, name)
                _set(block, name, qparams)
                if progress:
                    print(f"layer {layer} {name}: gptq error {float(err):.3f}")

            # re-forward through the fully quantized block -> next layer's inputs
            inps = torch.cat([block_forward(block, inps[s : s + micro_batch], rope, config)
                              for s in range(0, n_samples, micro_batch)])
            quantized_layers.append(block)

        new_params = dict(params)
        new_params["blocks"] = _stack(quantized_layers)

        if quantize_lm_head:
            # final norm, then lm_head (reference quantize/gptq.py:129-148)
            h = rmsnorm(inps, params["ln_f"]["scale"], config.norm_eps)
            w = params["lm_head"]["weight"]
            H, n = init_hessian(w.shape[0], device=dev)
            for s in range(0, n_samples, micro_batch):
                H, n = hessian_update(H, n, h[s : s + micro_batch].reshape(-1, h.shape[-1]))
            qparams, err = solve(w.float(), H, "lm_head")
            if progress:
                print(f"lm_head: gptq error {float(err):.3f}")
            new_params["lm_head"] = qparams
    finally:
        graphs.close()
    return new_params


def _per_layer(qfn):
    """Apply a 2-D quantizer to a (K, N) weight, or to each layer of an (L, K, N)
    stack and restack (the JAX package's ``vmap``)."""
    def apply(w):
        if w.dim() == 3:
            return _stack([qfn(w[i]) for i in range(w.shape[0])])
        return qfn(w)
    return apply


@torch.no_grad()
def int8_quantize_model(params, quantize_lm_head: bool = True, outliers=True):
    """LLM.int8-style weight-only quantization of every linear (no calibration).

    ``outliers=True`` keeps the ~0.5% scale-setting input rows in bf16 and
    quantizes the bulk against the reduced scales (`quantize_int8_outlier`);
    ``outliers="dynamic"`` is bitsandbytes' per-forward threshold-6.0 activation
    split (`quantize_int8_dynamic`); ``outliers=False`` plain absmax per channel."""
    if outliers == "dynamic":
        qfn = _per_layer(quantize_int8_dynamic)
    elif outliers:
        qfn = _per_layer(quantize_int8_outlier)
    else:
        qfn = quantize_int8_absmax

    new = _copy_tree(params)
    for name in SUBMODULES:
        _set(new["blocks"], name, qfn(_get(new["blocks"], name)["weight"]))
    if quantize_lm_head:
        new["lm_head"] = qfn(new["lm_head"]["weight"])
    return new
