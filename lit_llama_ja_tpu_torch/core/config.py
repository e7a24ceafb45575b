"""Model configuration and registry.

A copy of `lit_llama_ja_tpu/core/config.py`: the JAX package's modules cannot be
imported without importing jax, so the port keeps its own. The fields, derived
properties and registry are the same, so one config name means one model in both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def find_multiple(n: int, k: int) -> int:
    """Round ``n`` up to the nearest multiple of ``k``."""
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class LLaMAConfig:
    """Static model hyperparameters (frozen and hashable)."""

    block_size: int = 2048
    vocab_size: int = 32000
    padded_vocab_size: Optional[int] = None
    n_layer: int = 32
    n_head: int = 32
    n_embd: int = 4096
    rope_base: int = 10000
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.padded_vocab_size is None:
            object.__setattr__(
                self, "padded_vocab_size", find_multiple(self.vocab_size, 64)
            )

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    @property
    def n_hidden(self) -> int:
        """SwiGLU hidden size."""
        return find_multiple(int(2 * 4 * self.n_embd / 3), 256)

    @classmethod
    def from_name(cls, name: str, **overrides) -> "LLaMAConfig":
        return cls(**{**llama_configs[name], **overrides})

    def replace(self, **kw) -> "LLaMAConfig":
        return dataclasses.replace(self, **kw)

    def debug(self) -> None:
        for f in dataclasses.fields(self):
            print(f"{f.name}: ", getattr(self, f.name))


# Registry, incl. the ja-fork small configs with the 35000-token vocabulary.
llama_configs = {
    "19M": dict(n_layer=6, n_head=8, n_embd=512, vocab_size=35000),
    "49M": dict(n_layer=10, n_head=10, n_embd=640, vocab_size=35000),
    "125M": dict(n_layer=12, n_head=10, n_embd=780, vocab_size=35000),
    "7B": dict(n_layer=32, n_head=32, n_embd=4096),
    "13B": dict(n_layer=40, n_head=40, n_embd=5120),
    "30B": dict(n_layer=60, n_head=52, n_embd=6656),
    "65B": dict(n_layer=80, n_head=64, n_embd=8192),
}

# n_embd -> canonical name, for shape-based checkpoint identification.
llama_model_sizes = {
    cfg["n_embd"]: name for name, cfg in llama_configs.items()
}


def llama_model_lookup(n_embd: int) -> str:
    """Infer the config name from the embedding width of a checkpoint."""
    return llama_model_sizes[n_embd]
