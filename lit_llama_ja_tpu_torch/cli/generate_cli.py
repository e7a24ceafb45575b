"""Base generation CLI (counterpart of `lit_llama_ja_tpu/cli/generate_cli.py`; reference
`generate.py:92-172`).

    python -m lit_llama_ja_tpu_torch.cli.generate_cli --checkpoint-path <dir or .pth> \\
        --tokenizer-path <tokenizer.json> --quantize llm.int8 --prompt "..."

``--draft-checkpoint-path`` decodes speculatively with a small draft model of the same
tokenizer (`infer/speculative.py`). ``--tp``/``--fsdp`` shard the weights (and the
draft's) over a ``(1, fsdp, tp)`` mesh of ranks, as the JAX CLI does; run it under
``torchrun`` (or inside ranks whose process group exists). Every rank loads its own
slices (`io/checkpoint.load_checkpoint`), generates the same tokens, and rank 0 prints.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device

INT8_MODES = {"llm.int8": True, "llm.int8-rtn": False, "llm.int8-dyn": "dynamic"}


def to_device(tree, device):
    """A tree of tensors on ``device`` (the same tree when already there)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _rtn_quantize(params, bits, groupsize):
    """Round-to-nearest quantization of the five block linears (per layer) and the
    lm_head, at the per-projection widths of a (possibly mixed) mode."""
    from lit_llama_ja_tpu_torch.quant.linear import quantize_colblock, resolve_bits, resolve_groupsize
    from lit_llama_ja_tpu_torch.quant.pipeline import SUBMODULES, _copy_tree, _get, _set, _stack

    params = _copy_tree(params)
    for name in SUBMODULES:
        w = _get(params["blocks"], name)["weight"]
        nb, gs = resolve_bits(bits, name), resolve_groupsize(bits, name, groupsize)
        _set(params["blocks"], name,
             _stack([quantize_colblock(w[i], bits=nb, tile_cols=gs) for i in range(w.shape[0])]))
    params["lm_head"] = quantize_colblock(
        params["lm_head"]["weight"], bits=resolve_bits(bits, "lm_head"),
        tile_cols=resolve_groupsize(bits, "lm_head", groupsize),
    )
    return params


def _is_quantized_dir(path: Path) -> bool:
    flat = torch.load(path / "params.pt", map_location="cpu", weights_only=True, mmap=True)
    return any(k.endswith("qweight") for k in flat)


def load_model_any(checkpoint_path, quantize: Optional[str] = None, device="cuda", mesh=None):
    """`load_model_full`; on a mesh, this rank's slices (`parallel/specs.shard_params`;
    on a mesh with ``pp``, its stage's layers alone). A directory that needs no
    quantization at load is read slice by slice, so host memory stays near one shard;
    any other source is loaded whole, then cut."""
    if mesh is None:
        return load_model_full(checkpoint_path, quantize, device)
    from lit_llama_ja_tpu_torch.io.checkpoint import load_checkpoint
    from lit_llama_ja_tpu_torch.parallel.specs import check_divisible, shard_params

    path = Path(checkpoint_path)
    if path.is_dir() and (quantize is None or _is_quantized_dir(path)):
        params, config = load_checkpoint(path, device=resolve_device(device), mesh=mesh)
        if config is None:
            raise ValueError(f"missing config.json in {path}")
    else:
        params, config = load_model_full(path, quantize, device)
        params = shard_params(params, mesh)
    check_divisible(config, mesh)
    if "pp" in mesh.axis_names:
        from lit_llama_ja_tpu_torch.parallel.pipeline import check_pipeline

        check_pipeline(config, mesh)
    return params, config


def load_model_full(checkpoint_path, quantize: Optional[str] = None, device="cuda"):
    """Load a model from a checkpoint directory (`io/checkpoint.save_checkpoint`) or a
    lit-llama ``.pth``, onto ``device``. Returns (params, config).

    ``quantize``: None, ``llm.int8`` (static bf16 outlier rows), ``llm.int8-rtn``
    (plain absmax), ``llm.int8-dyn`` (per-forward activation outliers) or
    ``{gptq|rtn}.int{2,3,4,8}[-g<N>]`` / ``{gptq|rtn}.mix...``. A ``.pth`` is
    quantized per layer while it streams from disk; a directory that is not quantized
    yet is quantized after loading (int8 modes as asked, ``gptq.*`` round-to-nearest
    with a warning: run `cli/quantize_cli.py` for calibrated weights). A directory
    that already holds quantized weights is returned as it is.
    """
    from lit_llama_ja_tpu_torch.io.checkpoint import load_checkpoint
    from lit_llama_ja_tpu_torch.io.convert import load_lit_checkpoint
    from lit_llama_ja_tpu_torch.quant.linear import parse_quant_mode

    dev = resolve_device(device)
    path = Path(checkpoint_path)
    if quantize is not None:
        scheme, bits, groupsize = parse_quant_mode(quantize)
    if path.is_dir():
        params, config = load_checkpoint(path, device=dev)
        if config is None:
            raise ValueError(f"missing config.json in {path}")
    else:
        if quantize is not None and scheme == "gptq":
            print("warning: quantizing round-to-nearest at load; run "
                  "cli/quantize_cli.py for calibrated weights", file=sys.stderr)
        # with a mode, the fp model never exists in host memory at once
        params, config = load_lit_checkpoint(path, quantize=quantize)
        params = to_device(params, dev)
        if quantize is not None:
            return params, config

    if quantize is None or "qweight" in params["blocks"]["attn"]["c_attn"]:
        return params, config
    if quantize in INT8_MODES:
        from lit_llama_ja_tpu_torch.quant.pipeline import int8_quantize_model

        return int8_quantize_model(params, outliers=INT8_MODES[quantize]), config
    if scheme == "gptq":
        print("warning: checkpoint is not GPTQ-calibrated; applying RTN round-to-nearest "
              "(run cli/quantize_cli.py for calibrated weights)", file=sys.stderr)
    return _rtn_quantize(params, bits, groupsize), config


def compute_dtype(dev: torch.device) -> Optional[torch.dtype]:
    """bf16 activations on the card (the kernels take bf16); the checkpoint's dtype
    on the CPU."""
    return torch.bfloat16 if dev.type == "cuda" else None


def serving_mesh(tp: int, fsdp: int, pp: int = 1):
    """The ``(1, fsdp, tp[, pp])`` mesh of the inference CLIs, built when any axis is
    larger than one (as the JAX CLIs build theirs), else None: ranks started with every
    axis at 1 each run the model whole."""
    from lit_llama_ja_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed

    if tp == 1 and fsdp == 1 and pp <= 1:
        return None
    maybe_init_distributed()
    mesh = make_mesh(dp=1, fsdp=fsdp, tp=tp, pp=max(pp, 1))
    print(f"mesh: {mesh.shape}, backend {mesh.backend}", file=sys.stderr)
    return mesh


def load_tokenizer(tokenizer_path):
    from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer, Tokenizer

    p = Path(tokenizer_path)
    return Tokenizer(p) if p.suffix == ".model" else HFTokenizer(p)


def main(
    prompt: str = "Hello, my name is",
    num_samples: int = 1,
    max_new_tokens: int = 50,
    top_k: int = 200,
    top_p: float = 1.0,
    temperature: float = 0.8,
    checkpoint_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    quantize: Optional[str] = None,
    draft_checkpoint_path: Optional[str] = None,
    draft_k: int = 4,
    tp: int = 1,
    fsdp: int = 1,
    quantize_kv: str = "none",
    seed: int = 1234,
    device: str = "cuda",
) -> None:
    """Generates text samples based on a pre-trained LLaMA model and tokenizer.

    Args:
        prompt: The prompt string to use for generating the samples.
        num_samples: The number of text samples to generate.
        max_new_tokens: The number of generation steps to take.
        top_k: The number of top most probable tokens to consider.
        top_p: nucleus sampling mass (1.0 = off).
        temperature: Sampling randomness scale.
        checkpoint_path: checkpoint directory or lit-llama .pth file.
        tokenizer_path: tokenizers-json (HF) or sentencepiece .model file.
        quantize: None | llm.int8 | llm.int8-rtn | llm.int8-dyn |
            {gptq|rtn}.int{2,3,4,8}[-g<N>] | {gptq|rtn}.mix[-a<B>m<B>h<B>][-g<N>].
        draft_checkpoint_path: a small model of the same tokenizer (a 19M or 49M ja
            model drafting for a larger one) that turns on speculative decoding: the
            target's distribution exactly, up to draft_k + 1 tokens per target forward.
        draft_k: drafted tokens per speculative round.
        tp / fsdp: weight sharding over a (1, fsdp, tp) mesh of ranks.
        quantize_kv: "none" (bf16 cache) | "int8" | "int4" (head-pair packed).
        seed: sampling seed.
        device: "cuda" (default) or "cpu".
    """
    from lit_llama_ja_tpu_torch.infer.generate import generate
    from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
    from lit_llama_ja_tpu_torch.models.llama import cast_params, normalize_kv_mode

    dev = resolve_device(device)
    mesh = serving_mesh(tp, fsdp)
    print("Loading model ...", file=sys.stderr)
    t0 = time.time()
    params, config = load_model_any(Path(checkpoint_path), quantize, device=dev, mesh=mesh)
    params = cast_params(params, compute_dtype(dev))
    draft = None
    if draft_checkpoint_path:
        dparams, dconfig = load_model_any(Path(draft_checkpoint_path), None, device=dev,
                                          mesh=mesh)
        draft = (cast_params(dparams, compute_dtype(dev)), dconfig)
    print(f"Time to load model: {time.time() - t0:.02f} seconds.", file=sys.stderr)

    tokenizer = load_tokenizer(tokenizer_path)
    encoded = tokenizer.encode(prompt, bos=True, eos=False)
    prompt_length = len(encoded)
    qkv = normalize_kv_mode(quantize_kv)
    generator = torch.Generator(device=dev).manual_seed(seed)
    for i in range(num_samples):
        t0 = time.perf_counter()
        sampling = dict(temperature=temperature, top_k=top_k,
                        top_p=top_p if top_p < 1.0 else None, eos_id=tokenizer.eos_id,
                        generator=generator, cache_dtype=torch.bfloat16, quantize_kv=qkv,
                        device=dev, mesh=mesh)
        if draft is not None:
            spec_stats: dict = {}
            y = speculative_generate(params, config, *draft, encoded, max_new_tokens,
                                     K=draft_k, stats_out=spec_stats, **sampling)
            print(f"speculative: acceptance {spec_stats['acceptance']:.3f}, "
                  f"{spec_stats['tokens'] / max(spec_stats['rounds'], 1):.2f} tokens/round "
                  f"over {spec_stats['rounds']} rounds", file=sys.stderr)
        else:
            y = generate(params, config, encoded, max_new_tokens, **sampling)
        t = time.perf_counter() - t0
        if mesh is not None and mesh.rank != 0:
            continue
        print(tokenizer.decode(y))
        print(f"Time for inference {i + 1}: {t:.02f} sec total, "
              f"{(len(y) - prompt_length) / t:.02f} tokens/sec", file=sys.stderr)


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main)
