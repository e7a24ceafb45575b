"""Instruction-tuning (SFT) data pipeline (a copy of `lit_llama_ja_tpu/data/sft.py`, whose
module cannot be imported without jax; reference `scripts/prepare_alpaca.py`,
`scripts/prepare_dolly.py`, `finetune/*.py` get_batch).

Keeps the reference's on-disk contract — `train.pt` / `test.pt` lists of dicts with
``input_ids`` and ``labels`` (prompt tokens masked to IGNORE_INDEX=-1) saved via
torch — so datasets prepared by either framework interchange.

Batching: the reference pads each batch to its longest sample
(`finetune/lora.py:186-200`); here batches pad to the fixed ``max_seq_length``, as in
the JAX package, so both packages draw the same batches from one seed.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

IGNORE_INDEX = -1

ALPACA_URL = (
    "https://raw.githubusercontent.com/tloen/alpaca-lora/main/alpaca_data_cleaned_archive.json"
)
DOLLY_URL = (
    "https://huggingface.co/datasets/databricks/databricks-dolly-15k/resolve/main/databricks-dolly-15k.jsonl"
)


def generate_prompt(example: Dict) -> str:
    """Alpaca prompt template (reference `scripts/prepare_alpaca.py:111-125`)."""
    if example.get("input"):
        return (
            "Below is an instruction that describes a task, paired with an input that "
            "provides further context. "
            "Write a response that appropriately completes the request.\n\n"
            f"### Instruction:\n{example['instruction']}\n\n"
            f"### Input:\n{example['input']}\n\n### Response:"
        )
    return (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{example['instruction']}\n\n### Response:"
    )


def prepare_sample(
    example: Dict, tokenizer, max_length: int, mask_inputs: bool = True
) -> Dict:
    """Tokenize one (instruction, input, output) sample; labels mask the prompt
    (reference `scripts/prepare_alpaca.py:76-104`)."""
    full_prompt = generate_prompt(example)
    full = full_prompt + example["output"]
    enc_prompt = tokenizer.encode(full_prompt, bos=True, eos=False, max_length=max_length)
    enc_full = tokenizer.encode(full, bos=True, eos=True, max_length=max_length)
    labels = enc_full.copy()
    if mask_inputs:
        labels[: len(enc_prompt)] = IGNORE_INDEX
    return {
        **example,
        "input_ids": enc_full.astype(np.int32),
        "input_ids_no_response": enc_prompt.astype(np.int32),
        "labels": labels.astype(np.int32),
    }


def save_sft_dataset(samples: List[Dict], path) -> None:
    """torch.save for reference interchange."""
    import torch

    torch.save(
        [
            {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in s.items()}
            for s in samples
        ],
        str(path),
    )


def load_sft_dataset(path) -> List[Dict]:
    import torch

    data = torch.load(str(path), weights_only=False)
    out = []
    for s in data:
        out.append(
            {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in s.items()}
        )
    return out


def sft_batches(
    data: List[Dict],
    micro_batch_size: int,
    max_seq_length: int,
    seed: int = 1337,
    pad_id: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless random micro-batches, padded right to the fixed max_seq_length
    (inputs pad with ``pad_id``, labels with IGNORE_INDEX — reference
    `finetune/lora.py:186-200`)."""
    rng = np.random.default_rng(seed)
    T = max_seq_length
    while True:
        ix = rng.integers(0, len(data), size=micro_batch_size)
        x = np.full((micro_batch_size, T), pad_id, np.int32)
        y = np.full((micro_batch_size, T), IGNORE_INDEX, np.int32)
        for row, i in enumerate(ix):
            ids = data[i]["input_ids"][:T]
            lab = data[i]["labels"][:T]
            x[row, : len(ids)] = ids
            y[row, : len(lab)] = lab
        yield {"input_ids": x, "labels": y}


def prepare_alpaca(
    destination_path: str = "data/alpaca",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    test_split_size: int = 2000,
    max_seq_length: int = 256,
    seed: int = 42,
    mask_inputs: bool = False,
    data_url: str = ALPACA_URL,
    data_file_name: str = "alpaca_data_cleaned_archive.json",
):
    """Download + tokenize the Alpaca dataset (reference `scripts/prepare_alpaca.py`)."""
    from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer, Tokenizer

    dest = Path(destination_path)
    dest.mkdir(parents=True, exist_ok=True)
    file_path = dest / data_file_name
    if not file_path.exists():
        import urllib.request

        print(f"Downloading {data_url}")
        urllib.request.urlretrieve(data_url, file_path)

    tok_path = Path(tokenizer_path)
    tokenizer = (
        Tokenizer(tok_path) if tok_path.suffix == ".model" else HFTokenizer(tok_path)
    )

    if file_path.suffix == ".jsonl":
        with open(file_path) as f:
            data = [json.loads(line) for line in f]
        # dolly schema -> alpaca schema (reference scripts/prepare_dolly.py)
        for d in data:
            if "context" in d:
                d["input"] = d.pop("context")
            if "response" in d:
                d["output"] = d.pop("response")
    else:
        with open(file_path) as f:
            data = json.load(f)

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data))
    test_idx = set(perm[:test_split_size].tolist())
    train_set = [data[i] for i in range(len(data)) if i not in test_idx]
    test_set = [data[i] for i in range(len(data)) if i in test_idx]
    print(f"train has {len(train_set)} samples, test has {len(test_set)} samples")

    print("Processing train split ...")
    train = [prepare_sample(s, tokenizer, max_seq_length, mask_inputs) for s in train_set]
    save_sft_dataset(train, dest / "train.pt")
    print("Processing test split ...")
    test = [prepare_sample(s, tokenizer, max_seq_length, mask_inputs) for s in test_set]
    save_sft_dataset(test, dest / "test.pt")


def prepare_dolly(
    destination_path: str = "data/dolly",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    test_split_size: int = 2000,
    max_seq_length: int = 1024,
    seed: int = 42,
    mask_inputs: bool = False,
):
    """Databricks Dolly 15k (reference `scripts/prepare_dolly.py` — same pipeline,
    jsonl schema mapped context/response -> input/output)."""
    return prepare_alpaca(
        destination_path=destination_path,
        tokenizer_path=tokenizer_path,
        test_split_size=test_split_size,
        max_seq_length=max_seq_length,
        seed=seed,
        mask_inputs=mask_inputs,
        data_url=DOLLY_URL,
        data_file_name="databricks-dolly-15k.jsonl",
    )
