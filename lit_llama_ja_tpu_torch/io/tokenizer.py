"""Tokenizers (a copy of `lit_llama_ja_tpu/io/tokenizer.py`, which needs no jax but
belongs to the JAX package; reference `lit_llama/tokenizer.py`).

Two implementations with the same interface:
  * `HFTokenizer` — HuggingFace `tokenizers` backend with the ja-fork's hardcoded
    special ids PAD=0 / BOS=1 / EOS=2 (reference `lit_llama/tokenizer.py:51-89`).
    This is the primary tokenizer (the ja fork uses it in the main generate path).
  * `Tokenizer` — SentencePiece backend incl. `train()` (reference
    `lit_llama/tokenizer.py:9-49`). Gated on the `sentencepiece` package.

Both return NumPy int32 arrays (host-side; device placement is the caller's job —
tokenization runs on the host). `tokenizers` and `sentencepiece` are imported
when a tokenizer is made, not with this module.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np


class Tokenizer:
    """SentencePiece tokenizer for LLaMA (reference `lit_llama/tokenizer.py:9-49`)."""

    def __init__(self, model_path: Union[str, Path]) -> None:
        try:
            from sentencepiece import SentencePieceProcessor
        except ImportError as e:  # pragma: no cover - env without sentencepiece
            raise ImportError(
                "sentencepiece is not installed; use HFTokenizer or install "
                "sentencepiece for .model tokenizers"
            ) from e
        self.processor = SentencePieceProcessor(model_file=str(model_path))
        self.bos_id = self.processor.bos_id()
        self.eos_id = self.processor.eos_id()
        self.pad_id = self.processor.pad_id()

    @property
    def vocab_size(self) -> int:
        return self.processor.vocab_size()

    def encode(
        self,
        string: str,
        bos: bool = True,
        eos: bool = False,
        max_length: int = -1,
        pad: bool = False,
    ) -> np.ndarray:
        tokens = self.processor.encode(string)
        return _finalize(tokens, self.bos_id, self.eos_id, self.pad_id, bos, eos,
                         max_length, pad)

    def decode(self, tokens) -> str:
        return self.processor.decode(np.asarray(tokens).tolist())

    @staticmethod
    def train(input: str, destination: str, vocab_size: int = 32000) -> None:
        try:
            from sentencepiece import SentencePieceTrainer
        except ImportError as e:  # pragma: no cover
            raise ImportError("sentencepiece is required for Tokenizer.train") from e
        model_prefix = os.path.join(destination, "tokenizer")
        SentencePieceTrainer.Train(
            input=input, model_prefix=model_prefix, vocab_size=vocab_size
        )


class HFTokenizer:
    """HuggingFace `tokenizers` backend with ja-fork special ids
    (reference `lit_llama/tokenizer.py:51-89`): <PAD>=0, <BOS>=1, <EOS>=2."""

    def __init__(self, model_path: Union[str, Path]) -> None:
        from tokenizers import Tokenizer as _HFTok

        self.processor = _HFTok.from_file(str(model_path))
        self.bos_id = 1
        self.eos_id = 2
        self.pad_id = 0

    @property
    def vocab_size(self) -> int:
        return self.processor.get_vocab_size()

    def encode(
        self,
        string: str,
        bos: bool = True,
        eos: bool = False,
        max_length: int = -1,
        pad: bool = False,
    ) -> np.ndarray:
        tokens = self.processor.encode(string).ids
        return _finalize(tokens, self.bos_id, self.eos_id, self.pad_id, bos, eos,
                         max_length, pad)

    def decode(self, tokens) -> str:
        return self.processor.decode(np.asarray(tokens).tolist())

    @staticmethod
    def train(input: str, destination: str, vocab_size: int = 35000) -> str:
        """Train a byte-level-BPE tokenizer.json with the ja-fork id layout
        (<PAD>=0, <BOS>=1, <EOS>=2 — `lit_llama/tokenizer.py:59-61`).

        Counterpart of `Tokenizer.train` (reference `tokenizer.py:46-49`) for
        the HF backend the ja fork actually generates with; lets the full
        prepare→pretrain→evaluate pipeline run without sentencepiece.
        Returns the written tokenizer.json path."""
        from tokenizers import Tokenizer as _HFTok
        from tokenizers import decoders, models, pre_tokenizers, trainers

        tok = _HFTok(models.BPE(unk_token=None))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size,
            special_tokens=["<PAD>", "<BOS>", "<EOS>"],  # ids 0/1/2
            show_progress=False,
        )
        tok.train([str(input)], trainer)
        out = os.path.join(str(destination), "tokenizer.json")
        tok.save(out)
        return out


def _finalize(tokens, bos_id, eos_id, pad_id, bos, eos, max_length, pad) -> np.ndarray:
    if bos:
        tokens = [bos_id] + list(tokens)
    if eos:
        tokens = list(tokens) + [eos_id]
    if max_length > 0:
        tokens = tokens[:max_length]
    if pad and len(tokens) < max_length:
        tokens = list(tokens) + [pad_id] * (max_length - len(tokens))
    return np.asarray(tokens, dtype=np.int32)
