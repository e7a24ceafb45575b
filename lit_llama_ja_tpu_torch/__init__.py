"""lit_llama_ja_tpu_torch — the PyTorch/CUDA port of `lit_llama_ja_tpu` for NVIDIA Hopper.

The module layout mirrors the JAX package (``core/config.py``, ``ops/``, ``quant/``,
``models/llama.py``, ``infer/generate.py``, ``train/``, ``data/``, ``io/``, ``cli/``)
so each function's counterpart is easy to find. The Pallas kernels of the JAX package
become CUDA C++ kernels under ``csrc/``, built at first use by ``ops/cuda/_build.py``
and bound with ``ctypes``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``; without a
card they raise rather than fall back. On CPU tensors every kernel wrapper runs its
plain PyTorch version, which is what the CPU tests compare against the JAX package.
This package never imports ``jax`` or ``lit_llama_ja_tpu``.
"""
from lit_llama_ja_tpu_torch.core.config import (  # noqa: F401
    LLaMAConfig,
    find_multiple,
    llama_configs,
    llama_model_lookup,
)

__version__ = "0.1.0"
