"""Data preparation CLIs (counterpart of `lit_llama_ja_tpu/cli/prepare_cli.py`; reference
`scripts/prepare_{redpajama,ja,shakespeare,any_text}.py`).

    python -m lit_llama_ja_tpu_torch.cli.prepare_cli --source-path data/any \
        --tokenizer-path tokenizer.json --destination-path data/any-packed

Host-only: text in, LITPKDS chunk files out (`data/packed_dataset.py`), byte for
byte the JAX package's. `prepare_ja` reads HuggingFace datasets and
`prepare_shakespeare` fetches its text when ``input.txt`` is not in place; the
others read local files only.
"""
from __future__ import annotations

import glob
import json
import os
from pathlib import Path

import numpy as np


def _tokenizer(tokenizer_path):
    from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer, Tokenizer

    p = Path(tokenizer_path)
    return Tokenizer(p) if p.suffix == ".model" else HFTokenizer(p)


# reference `scripts/prepare_redpajama.py:18-40`
filenames_sample = [
    "arxiv_sample.jsonl",
    "book_sample.jsonl",
    "c4_sample.jsonl",
    "cc_2019-30_sample.jsonl",
    "cc_2020-05_sample.jsonl",
    "cc_2021-04_sample.jsonl",
    "cc_2022-05_sample.jsonl",
    "cc_2023-06_sample.jsonl",
    "github_sample.jsonl",
    "stackexchange_sample.jsonl",
    "wikipedia_sample.jsonl",
]

filename_sets = {
    "arxiv": "arxiv/arxiv*",
    "book": "book/book*",
    "c4": "c4/c4-train*",
    "common_crawl": "common_crawl/*",
    "github": "github/filtered*",
    "stackexchange": "stackexchange/stackexchange*",
    "wikipedia": "wikipedia/wiki*",
}


def prepare_redpajama(
    source_path: str = "data/RedPajama-Data-1T-Sample",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    destination_path: str = "data/lit-redpajama",
    chunk_size: int = 2049 * 1024,
    sample: bool = True,
    match: str = "",
) -> None:
    """jsonl(+zstd) -> LITPKDS packed chunks, one prefix per source
    (reference `scripts/prepare_redpajama.py:43-148`)."""
    from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder

    src = Path(source_path)
    dest = Path(destination_path)
    dest.mkdir(parents=True, exist_ok=True)
    tokenizer = _tokenizer(tokenizer_path)

    if sample:
        jobs = [(os.path.splitext(n)[0], [src / n]) for n in filenames_sample
                if not match or match in n]
    else:
        jobs = [
            (set_name, [Path(p) for p in sorted(glob.glob(str(src / pattern)))])
            for set_name, pattern in filename_sets.items()
            if not match or match in set_name
        ]

    for prefix, files in jobs:
        builder = PackedDatasetBuilder(
            outdir=str(dest), prefix=prefix, chunk_size=chunk_size,
            sep_token=tokenizer.bos_id, dtype="auto",
            vocab_size=tokenizer.vocab_size,
        )
        for filepath in files:
            if not filepath.is_file():
                raise RuntimeError(
                    f"Input file not found at {filepath}. Download RedPajama "
                    "(togethercomputer/RedPajama-Data-1T[-Sample]) first."
                )
            print(f"Processing {filepath}")
            if str(filepath).endswith(".zst"):
                import zstandard as zstd

                with zstd.open(open(filepath, "rb"), "rt", encoding="utf-8") as f:
                    for row in f:
                        text = json.loads(row)["text"]
                        builder.add_array(
                            np.asarray(tokenizer.encode(text, bos=True, eos=False))
                        )
            else:
                with open(filepath, encoding="utf-8") as f:
                    for row in f:
                        text = json.loads(row)["text"]
                        builder.add_array(
                            np.asarray(tokenizer.encode(text, bos=True, eos=False))
                        )
        builder.write_reminder()


# ja-fork dataset list (reference `scripts/prepare_ja.py:18-35`)
JA_DATASETS = [
    ("izumi-lab/wikipedia-ja-20230720", "wikipedia-ja-20230720"),
    ("izumi-lab/wikipedia-en-20230720", "wikipedia-en-20230720"),
    ("izumi-lab/wikinews-ja-20230728", "wikinews-ja-20230728"),
    ("izumi-lab/wikinews-en-20230728", "wikinews-en-20230728"),
    ("izumi-lab/open-text-books", "open-text-books"),
    ("if001/oscar_2023_filtered", "oscar_2023_filtered"),
    ("globis-university/aozorabunko-clean", "aozorabunko-clean-sin"),
]


def prepare_ja(
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    destination_path: str = "data/ja",
    chunk_size: int = 2049 * 1024,
    match: str = "",
) -> None:
    """Japanese corpora (HF datasets) -> packed chunks via the HF tokenizer
    (reference `scripts/prepare_ja.py:18-83`)."""
    from datasets import load_dataset

    from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder

    dest = Path(destination_path)
    dest.mkdir(parents=True, exist_ok=True)
    tokenizer = _tokenizer(tokenizer_path)

    total_tokens = 0
    for hf_name, prefix in JA_DATASETS:
        if match and match not in prefix:
            continue
        print(f"Processing {hf_name}")
        ds = load_dataset(hf_name, split="train")
        builder = PackedDatasetBuilder(
            outdir=str(dest), prefix=prefix, chunk_size=chunk_size,
            sep_token=tokenizer.bos_id, dtype="auto",
            vocab_size=tokenizer.vocab_size,
        )
        for sample in ds:
            text = sample.get("text") or sample.get("content") or ""
            arr = np.asarray(tokenizer.encode(text, bos=True, eos=False))
            total_tokens += len(arr)
            builder.add_array(arr)
        builder.write_reminder()
    print(f"total tokens: {total_tokens:,}")


def prepare_shakespeare(destination_path: str = "data/shakespeare") -> None:
    """Tiny Shakespeare -> train.bin/val.bin with an in-training-set 100-vocab
    SentencePiece tokenizer (reference `scripts/prepare_shakespeare.py`)."""
    from lit_llama_ja_tpu_torch.io.tokenizer import Tokenizer

    dest = Path(destination_path)
    dest.mkdir(parents=True, exist_ok=True)
    input_file_path = dest / "input.txt"
    if not input_file_path.exists():
        import urllib.request

        data_url = "https://raw.githubusercontent.com/karpathy/char-rnn/master/data/tinyshakespeare/input.txt"
        urllib.request.urlretrieve(data_url, input_file_path)

    data = input_file_path.read_text()
    n = len(data)
    train_data = data[: int(n * 0.9)]
    val_data = data[int(n * 0.9) :]

    Tokenizer.train(input=str(input_file_path), destination=str(dest), vocab_size=100)
    tokenizer = Tokenizer(dest / "tokenizer.model")
    train_ids = np.asarray(tokenizer.encode(train_data), dtype=np.uint16)
    val_ids = np.asarray(tokenizer.encode(val_data), dtype=np.uint16)
    print(f"train has {len(train_ids):,} tokens")
    print(f"val has {len(val_ids):,} tokens")
    train_ids.tofile(dest / "train.bin")
    val_ids.tofile(dest / "val.bin")


def prepare_any_text(
    source_path: str = "data/any",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    destination_path: str = "data/any-packed",
    chunk_size: int = 2049 * 512,
    glob_pattern: str = "*.txt",
    prefix: str = "any",
) -> None:
    """Line-based text files -> packed chunks (reference `scripts/prepare_any_text.py`).

    ``prefix`` names the output chunk files (so `pretrain --train-prefixes`
    can select them)."""
    from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder

    src = Path(source_path)
    dest = Path(destination_path)
    dest.mkdir(parents=True, exist_ok=True)
    tokenizer = _tokenizer(tokenizer_path)

    builder = PackedDatasetBuilder(
        outdir=str(dest), prefix=prefix, chunk_size=chunk_size,
        sep_token=tokenizer.bos_id, dtype="auto", vocab_size=tokenizer.vocab_size,
    )
    files = sorted(src.glob(glob_pattern))
    if not files:
        raise RuntimeError(f"no files matching {glob_pattern} under {src}")
    for path in files:
        print(f"Processing {path}")
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                builder.add_array(
                    np.asarray(tokenizer.encode(line, bos=True, eos=True))
                )
    builder.write_reminder()


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(prepare_any_text)
