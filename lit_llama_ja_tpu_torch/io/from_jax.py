"""Carry a JAX parameter tree across to the port.

The input is the JAX package's param tree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``); the output is the same tree, leaf for leaf,
as torch tensors on ``device``, copied (the port's train step updates its tensors in
place, which must not write through to the caller's arrays). JAX's bf16 leaves
arrive as numpy arrays whose dtype is named ``bfloat16`` (an extension type numpy
itself does not define); their bits are moved through ``uint16`` so no extension
package is needed.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device


def array_to_tensor(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One numpy leaf -> a torch tensor on ``device`` (bf16 by its bits)."""
    dev = resolve_device(device)
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.view(np.uint16)
    a = np.require(a, requirements=["C", "W"])  # torch needs writable memory
    t = torch.from_numpy(a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(dev, copy=True)  # never shares memory with ``a``: training updates in place


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return array_to_tensor(tree, dev)
