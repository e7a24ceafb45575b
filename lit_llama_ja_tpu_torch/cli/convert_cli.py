"""Checkpoint conversion CLIs (counterpart of `lit_llama_ja_tpu/cli/convert_cli.py`;
reference `scripts/convert_checkpoint.py`, `scripts/convert_hf_checkpoint.py`).

    python -c "from lit_llama_ja_tpu_torch.cli.convert_cli import convert_meta_checkpoint; \\
               convert_meta_checkpoint('checkpoints/llama/7B', 'checkpoints/lit-llama/7B')"

The conversion runs on the host; the checkpoints it writes are the port's
(`io/checkpoint.save_checkpoint`). Merging LoRA weights (`convert_lora_weights`) waits
for the finetuning slice (ROADMAP.md, queue 1 slice 5b).
"""
from __future__ import annotations

import gc
import json
from pathlib import Path

import numpy as np
import torch


def convert_meta_checkpoint(
    checkpoint_dir: str = "checkpoints/llama/7B",
    output_dir: str = "checkpoints/lit-llama/7B",
    model_size: str = "7B",
    to_native: bool = True,
) -> None:
    """Merge Meta ``consolidated.*.pth`` model-parallel shards and convert (reference
    `scripts/convert_checkpoint.py:66-135`): a checkpoint directory ``native`` under
    ``output_dir`` (default) or a lit-compatible ``lit-llama.pth``."""
    from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
    from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
    from lit_llama_ja_tpu_torch.io.convert import lit_state_dict_to_native, meta_checkpoints_to_lit

    ckpt_dir, out = Path(checkpoint_dir), Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    checkpoint_files = sorted(ckpt_dir.glob("*.pth"))
    if not checkpoint_files:
        raise RuntimeError(f"No consolidated.*.pth found at {ckpt_dir}")
    shards = [torch.load(str(f), map_location="cpu", mmap=True, weights_only=True)
              for f in checkpoint_files]
    lit_sd = meta_checkpoints_to_lit(shards)
    del shards
    gc.collect()

    config = LLaMAConfig.from_name(model_size)
    if to_native:
        params, _ = lit_state_dict_to_native(lit_sd, config)
        save_checkpoint(out / "native", params, config)
        print(f"saved native checkpoint to {out / 'native'}")
    else:
        torch.save({k: v.contiguous() for k, v in lit_sd.items()}, out / "lit-llama.pth")
        print(f"saved lit checkpoint to {out / 'lit-llama.pth'}")


def convert_hf_checkpoint(
    checkpoint_dir: str = "checkpoints/hf-llama/7B",
    output_dir: str = "checkpoints/lit-llama/7B",
    model_size: str = "7B",
    verify: bool = False,
) -> None:
    """HF LLaMA -> checkpoint directory ``native`` under ``output_dir`` (reference
    `scripts/convert_hf_checkpoint.py`): reads the sharded ``pytorch_model*.bin``
    through the weight-map index, un-permutes q/k and fuses qkv. ``verify`` compares
    the port's logits on the CPU with `transformers` on a random sample (reference
    `:141-160`)."""
    from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
    from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
    from lit_llama_ja_tpu_torch.io.convert import hf_state_dict_to_lit, lit_state_dict_to_native

    ckpt_dir, out = Path(checkpoint_dir), Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    index_path = ckpt_dir / "pytorch_model.bin.index.json"
    if index_path.exists():
        bin_index = json.loads(index_path.read_text())
        bin_files = sorted({ckpt_dir / b for b in bin_index["weight_map"].values()})
    else:
        bin_files = sorted(ckpt_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise RuntimeError(f"no pytorch_model*.bin under {ckpt_dir}")

    sd = {}
    for bf in bin_files:
        print(f"Processing {bf}")
        sd.update(torch.load(str(bf), map_location="cpu", mmap=True, weights_only=True))

    config = LLaMAConfig.from_name(model_size)
    params, _ = lit_state_dict_to_native(hf_state_dict_to_lit(sd, config), config)
    save_checkpoint(out / "native", params, config)
    print(f"saved native checkpoint to {out / 'native'}")

    if verify:
        from transformers import LlamaForCausalLM

        from lit_llama_ja_tpu_torch.models.llama import forward

        token_sample = np.random.default_rng(0).integers(0, config.vocab_size, size=(1, 64))
        idx = torch.from_numpy(token_sample)
        with torch.no_grad():
            ours = forward(params, idx, config, device="cpu").numpy()
            theirs = LlamaForCausalLM.from_pretrained(str(ckpt_dir))(idx).logits.numpy()
        np.testing.assert_allclose(ours[..., : config.vocab_size], theirs, atol=5e-3, rtol=1e-2)
        print("verified: logits match transformers")


def download_weights(
    repo_id: str = "openlm-research/open_llama_7b",
    local_dir: str = "checkpoints/open-llama/7B",
) -> None:
    """HF-hub snapshot download (reference `scripts/download.py`); needs the network."""
    from huggingface_hub import snapshot_download

    snapshot_download(repo_id, local_dir=local_dir)
