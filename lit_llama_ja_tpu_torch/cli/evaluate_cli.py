"""Perplexity evaluation CLI (counterpart of `main` in
`lit_llama_ja_tpu/cli/evaluate_cli.py`; reference `evaluate/full.py`).

    python -m lit_llama_ja_tpu_torch.cli.evaluate_cli --datasets <text file> \\
        --checkpoint-path <dir or .pth> --tokenizer-path <tokenizer.json> \\
        --quantize gptq.int4

The LoRA and adapter evaluations (`main_lora`, `main_adapter`) wait for the
finetuning slice (ROADMAP.md, queue 1 slice 5b).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np

from lit_llama_ja_tpu_torch.core.device import resolve_device


def _evaluate(params, config, datasets, tokenizer, device, kv_cache=None, kv_windows=12):
    from lit_llama_ja_tpu_torch.infer.evaluate import (
        decode_path_perplexity,
        load_eval_dataset,
        perplexity,
    )
    from lit_llama_ja_tpu_torch.models.llama import normalize_kv_mode

    for name in datasets.split(","):
        name = name.strip()
        t0 = time.perf_counter()
        tokens = load_eval_dataset(name, tokenizer)
        if kv_cache is not None:
            ppl = decode_path_perplexity(
                params, config, np.asarray(tokens), quantize_kv=normalize_kv_mode(kv_cache),
                windows=kv_windows, device=device,
            )
            print(f"{name}: decode-path perplexity (kv={kv_cache}) {ppl:.4f} "
                  f"({time.perf_counter() - t0:.1f}s, {kv_windows} windows)")
        else:
            ppl = perplexity(params, config, tokens, device=device)
            print(f"{name}: perplexity {ppl:.4f} ({time.perf_counter() - t0:.1f}s)")


def main(
    datasets: str = "wikitext,ptb,c4",
    checkpoint_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    quantize: Optional[str] = None,
    kv_cache: Optional[str] = None,
    kv_windows: int = 12,
    device: str = "cuda",
) -> None:
    """Evaluate perplexity on wikitext/ptb/c4 or local text files (reference
    `evaluate/full.py:46-135`).

    ``--kv-cache none|int8|int4`` switches to the decode-path protocol: teacher-forced
    through `forward_with_cache`, so every logit reads the (possibly quantized) KV
    cache (``--kv-windows`` sampled windows of block_size tokens). Omit it for the
    reference protocol. On the card the model runs in bf16 activations."""
    from lit_llama_ja_tpu_torch.cli.generate_cli import compute_dtype, load_model_any, load_tokenizer
    from lit_llama_ja_tpu_torch.models.llama import cast_params

    dev = resolve_device(device)
    params, config = load_model_any(Path(checkpoint_path), quantize, device=dev)
    params = cast_params(params, compute_dtype(dev))
    _evaluate(params, config, datasets, load_tokenizer(tokenizer_path), dev,
              kv_cache=kv_cache, kv_windows=kv_windows)


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main)
