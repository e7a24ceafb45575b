"""GPTQ calibration CLI (counterpart of `lit_llama_ja_tpu/cli/quantize_cli.py`;
reference `quantize/gptq.py:151-238`).

    python -m lit_llama_ja_tpu_torch.cli.quantize_cli --checkpoint-path <dir or .pth> \\
        --tokenizer-path <tokenizer.json> --quantize gptq.int4 \\
        --calib-text-path <text file>

Without ``--calib-text-path`` the calibration text is C4, fetched with `datasets`. On a
CUDA device the solver's column loops replay captured CUDA graphs, one a block shape
(`quant/gptq.GPTQGraphs`), as the JAX package jits its solve.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from lit_llama_ja_tpu_torch.core.device import resolve_device


def get_sample_data() -> str:
    """C4 calibration text (reference `quantize/gptq.py:22-33`); needs the network."""
    from datasets import load_dataset

    traindata = load_dataset(
        "allenai/c4",
        data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
        split="train",
    )
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(traindata))[:1000]
    return "\n".join(traindata[int(i)]["text"] for i in idx)


def main(
    checkpoint_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    output_path: Optional[str] = None,
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    n_samples: int = 128,
    quantize: str = "gptq.int4",
    groupsize: int = -1,
    calib_text_path: Optional[str] = None,
    device: str = "cuda",
) -> None:
    """GPTQ-quantize all Linear layers of a checkpoint.

    Args:
        checkpoint_path: checkpoint directory or lit .pth to quantize.
        output_path: where to write the quantized checkpoint directory.
        tokenizer_path: tokenizer for the calibration text.
        n_samples: calibration sequences of block_size tokens (default 128).
        quantize: "gptq.int{2,3,4,8}[-g<N>]" or the mixed per-projection grammar
            "gptq.mix[-a<B>m<B>h<B>][-g<N>]" (bare "gptq.mix" = a4m2h4-g64).
        groupsize: column group size (-1 = per-channel whole-row); a "-g<N>" suffix of
            the mode takes precedence.
        calib_text_path: local text file instead of downloading C4.
        device: "cuda" (default) or "cpu".
    """
    from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any, load_tokenizer
    from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
    from lit_llama_ja_tpu_torch.quant.linear import mixed_mode_tag, parse_quant_mode
    from lit_llama_ja_tpu_torch.quant.pipeline import gptq_quantize_model

    dev = resolve_device(device)
    scheme, bits, mode_gs = parse_quant_mode(quantize)
    if scheme != "gptq":
        raise RuntimeError(f"unknown/unsupported quantization mode {quantize}")
    if mode_gs != -1:
        groupsize = mode_gs

    if output_path is None:
        suffix = f"llama-gptq.{mixed_mode_tag(bits)}" + (
            f"-g{groupsize}" if groupsize != -1 else ""
        )
        output_path = str(Path(checkpoint_path).parent / suffix)

    print("Loading model ...", file=sys.stderr)
    params, config = load_model_any(Path(checkpoint_path), device=dev)

    tokenizer = load_tokenizer(tokenizer_path)
    text = Path(calib_text_path).read_text() if calib_text_path else get_sample_data()
    encoded = tokenizer.encode(text, bos=True, eos=False)
    block_size = config.block_size  # 2048-token windows (reference gptq.py:215)
    n = min(n_samples, len(encoded) // block_size)
    calib = np.asarray(encoded[: n * block_size]).reshape(n, block_size)
    print(f"calibrating on {n} x {block_size} tokens", file=sys.stderr)

    t0 = time.perf_counter()
    qparams = gptq_quantize_model(params, config, calib, bits=bits, groupsize=groupsize)
    print(f"Time for quantization: {time.perf_counter() - t0:.02f} sec", file=sys.stderr)

    save_checkpoint(output_path, qparams, config)
    print(f"saved to {output_path}")


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main)
