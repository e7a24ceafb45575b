"""Checkpoint save/load (counterpart of `lit_llama_ja_tpu/io/checkpoint.py`).

The JAX package stores trees with Orbax, which is JAX's. The port keeps its own
on-disk format in the same directory layout:

  * ``<dir>/params.pt`` — ``torch.save`` of the flat tree: ``{"blocks/attn/c_attn/
    weight": tensor, ...}`` (`flatten_tree` keys), tensors on the CPU;
  * ``<dir>/config.json`` — the config's fields, when a config is given (an
    `models/moe.MoEConfig` writes its expert fields and loads back as one);
  * ``<dir>/quant_format.json`` — ``{"int4_pack": INT4_PACK_VERSION}`` for a tree
    with any ``qweight`` leaf; loading refuses a packed-int4 tree whose stamp differs;
  * for a full training state, ``opt_state.pt`` and ``meta.json`` beside them.

On a mesh (``mesh=``, `parallel/mesh.Mesh`), each rank reads only its slices of
``params.pt`` (and ``opt_state.pt``; on a mesh with ``pp``, its stage's layers only): the file is opened with ``torch.load(mmap=True)``
and every leaf is cut by `parallel/specs.shard_leaf` before it is copied, so host
memory stays near one shard, as JAX's Orbax restore into a sharding does. Saving
gathers the shards and rank 0 writes.

Small flat states (PEFT deltas) go to ``.npz`` with the JAX package's keys, so either
package reads the other's. `infer_model_name` keeps the reference's shape lookup.
Loaders take ``device="cuda"`` by default and raise without a card, as every entry
point of the port does.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_model_lookup
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.quant.linear import INT4_PACK_VERSION


# ---------------------------------------------------------------------------
# Flat trees
# ---------------------------------------------------------------------------

def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> ``{"a/b/c": leaf}``; None leaves (frozen parts of a
    partitioned tree) are left out. Leaves are returned as they are, not copied."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}{k}/"))
    elif tree is not None:
        flat[prefix[:-1]] = tree
    return flat


def unflatten_tree(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _save_tree(path: Path, tree) -> None:
    torch.save({k: v.detach().cpu() for k, v in flatten_tree(tree).items()}, path)


def _params_file(path: Path) -> Path:
    """``path/params.pt``. A directory with ``params/`` and no ``params.pt`` is what the
    JAX package's Orbax ``save_checkpoint`` writes; say so, and name the bridge."""
    file = path / "params.pt"
    if not file.exists() and (path / "params").is_dir():
        raise FileNotFoundError(
            f"{path} is an Orbax checkpoint of the JAX package (lit_llama_ja_tpu): it has "
            "params/ but no params.pt. Restore it with that package in a process that has "
            "jax, convert the arrays with lit_llama_ja_tpu_torch.io.from_jax."
            "params_from_numpy and write them with save_checkpoint."
        )
    return file


def _spec_path(key: str) -> str:
    """The parameter path of a flat key: an AdamW moment (``mu/...``, ``nu/...``) is
    sharded as its parameter."""
    head, _, rest = key.partition("/")
    return rest if head in ("mu", "nu") else key


def _load_tree(path: Path, device: torch.device, mesh=None):
    if mesh is None:
        flat = torch.load(path, map_location="cpu", weights_only=True)
        return unflatten_tree({k: v.to(device) for k, v in flat.items()})
    from lit_llama_ja_tpu_torch.parallel.specs import (
        is_head_aligned,
        rules_for,
        shard_leaf,
        spec_of,
    )

    flat = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    out, rules = {}, rules_for(mesh)
    for k, v in flat.items():
        p = _spec_path(k)
        out[k] = shard_leaf(v, spec_of(p, rules), mesh, is_head_aligned(p), device) if (
            v.dim()) else v.to(device)
    return unflatten_tree(out)


def _gathered(tree, mesh):
    """The full tree from this rank's shards (collective); the tree itself without a
    mesh. AdamW moments gather as their parameters."""
    if mesh is None:
        return tree
    from lit_llama_ja_tpu_torch.parallel.specs import (
        is_head_aligned,
        rules_for,
        spec_of,
        unshard_leaf,
    )

    flat, rules = flatten_tree(tree), rules_for(mesh)
    return unflatten_tree({
        k: unshard_leaf(v, spec_of(_spec_path(k), rules), mesh, is_head_aligned(_spec_path(k)))
        if v.dim() else v for k, v in flat.items()})


def _write_config(path: Path, config: Optional[LLaMAConfig]) -> None:
    if config is not None:
        (path / "config.json").write_text(json.dumps(dataclasses.asdict(config)))


def _read_config(path: Path) -> Optional[LLaMAConfig]:
    cfg_file = path / "config.json"
    if not cfg_file.exists():
        return None
    d = json.loads(cfg_file.read_text())
    if "n_expert" in d:  # an MoE checkpoint carries the expert fields
        from lit_llama_ja_tpu_torch.models.moe import MoEConfig

        return MoEConfig(**d)
    return LLaMAConfig(**d)


# ---------------------------------------------------------------------------
# The int4 pack-format stamp
# ---------------------------------------------------------------------------

def _tree_has_qweight(tree) -> bool:
    if isinstance(tree, dict):
        return "qweight" in tree or any(_tree_has_qweight(v) for v in tree.values())
    return False


def _tree_has_packed_int4(tree, config) -> bool:
    """True iff any qweight leaf uses the packed-int4 layout (rows == K // 2), read
    from its shape against the config's widths (int8 stores full-K rows)."""
    if config is None:
        return _tree_has_qweight(tree)  # conservative: cannot rule int4 out
    half_rows = (config.n_embd // 2, config.n_hidden // 2)
    return any(k.endswith("qweight") and v.shape[-2] in half_rows
               for k, v in flatten_tree(tree).items())


def _write_quant_format(path: Path, params) -> None:
    if _tree_has_qweight(params):
        (path / "quant_format.json").write_text(json.dumps({"int4_pack": INT4_PACK_VERSION}))


def _check_quant_format(path: Path, params, config) -> None:
    """Refuse a packed-int4 tree whose byte layout is not the one this build reads:
    it would load without error and dequantize every odd K-row wrong."""
    if not _tree_has_qweight(params):
        return
    fmt_file = path / "quant_format.json"
    stored = None
    if fmt_file.exists():
        stored = json.loads(fmt_file.read_text()).get("int4_pack")
    if stored == INT4_PACK_VERSION or not _tree_has_packed_int4(params, config):
        return  # the current layout, or an int8-only tree the layout does not touch
    raise ValueError(
        f"{path} contains packed int4 weights with pack format "
        f"{stored or 'v1/unstamped'}, but this build reads {INT4_PACK_VERSION!r} (high "
        "nibble stored two's-complement biased). Loading it would silently dequantize "
        "every odd K-row wrong."
    )


# ---------------------------------------------------------------------------
# Parameter checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(path, params, config: Optional[LLaMAConfig] = None, mesh=None) -> None:
    """Save a param tree (and optionally its config) to the directory ``path``.
    Quantized trees also get the ``quant_format.json`` stamp. On a mesh every rank
    calls it with its shards; rank 0 writes the gathered tree."""
    if mesh is not None:
        from lit_llama_ja_tpu_torch.parallel.mesh import barrier

        params = _gathered(params, mesh)
        if mesh.rank == 0:
            save_checkpoint(path, params, config)
        barrier(mesh)
        return
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    _save_tree(path / "params.pt", params)
    _write_config(path, config)
    _write_quant_format(path, params)


def load_checkpoint(path, device="cuda", mesh=None):
    """Load a tree saved by `save_checkpoint` onto ``device``; on a mesh, this rank's
    slices only. Returns (params, config-or-None)."""
    dev = resolve_device(device)
    path = Path(path).absolute()
    params = _load_tree(_params_file(path), dev, mesh)
    config = _read_config(path)
    _check_quant_format(path, params, config)
    return params, config


# ---------------------------------------------------------------------------
# Flat npz states (PEFT deltas, small trees)
# ---------------------------------------------------------------------------

def save_state_npz(path, tree) -> None:
    """The JAX package's ``.npz`` layout. numpy has no bf16, so bf16 leaves are
    stored as f32 (exactly) and load back as f32."""
    np.savez(path, **{k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
                      for k, v in flatten_tree(tree).items()})


def load_state_npz(path, device="cuda"):
    dev = resolve_device(device)
    with np.load(path) as data:
        return unflatten_tree({k: torch.from_numpy(data[k]).to(dev) for k in data.files})


def infer_model_name(n_embd: int) -> str:
    """Shape-based model lookup (reference `llama_model_lookup`)."""
    return llama_model_lookup(n_embd)


# ---------------------------------------------------------------------------
# Full training state (params + optimizer + progress)
# ---------------------------------------------------------------------------

def save_train_state(
    path, params, opt_state, config: Optional[LLaMAConfig] = None,
    meta: Optional[Dict[str, Any]] = None, mesh=None,
) -> None:
    """Save params + optimizer state (+ JSON metadata, e.g. {"iter": n}); on a mesh,
    gathered, by rank 0."""
    if mesh is not None:
        from lit_llama_ja_tpu_torch.parallel.mesh import barrier

        params, opt_state = _gathered(params, mesh), _gathered(opt_state, mesh)
        if mesh.rank == 0:
            save_train_state(path, params, opt_state, config, meta)
        barrier(mesh)
        return
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    _save_tree(path / "params.pt", params)
    _save_tree(path / "opt_state.pt", opt_state)
    _write_config(path, config)
    (path / "meta.json").write_text(json.dumps(meta or {}))


def load_train_state(path, device="cuda", mesh=None):
    """Load a `save_train_state` checkpoint onto ``device`` (on a mesh, this rank's
    slices). The optimizer's step count comes back on the device too, where
    `train/step.AdamW` advances it (it is saved as a CPU scalar, as before). Returns
    (params, opt_state, config-or-None, meta dict)."""
    dev = resolve_device(device)
    path = Path(path).absolute()
    params = _load_tree(_params_file(path), dev, mesh)
    opt_state = _load_tree(path / "opt_state.pt", dev, mesh)
    meta = json.loads((path / "meta.json").read_text())
    return params, opt_state, _read_config(path), meta
