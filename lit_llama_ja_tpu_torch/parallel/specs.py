"""Parameter partition specs (counterpart of `lit_llama_ja_tpu/parallel/specs.py`).

A spec is a tuple with one entry per dim of a leaf: None (replicated), an axis name,
or a tuple of axis names (the dim split over their product, row-major). `PARAM_RULES`
is the JAX package's table word for word: path regex -> spec, first match wins, over
paths like ``"blocks/attn/c_attn/weight"``. The TP dims are the historical
model-parallel split: qkv and MLP up projections column-parallel, output projections
row-parallel; ``fsdp`` shards the complementary dim; the stacked layer axis is never
split.

One exception, in `shard_leaf`: the fused ``c_attn`` leaves ``(L, D, 3D)`` (weight or
qweight, scales, zeros, outlier_w). JAX's ``tp`` spec cuts the packed ``3D`` dim into
contiguous pieces that cross the q|k|v boundaries, and GSPMD reshards around that;
the port computes each rank's heads explicitly (`parallel/sharded.py`), so its local
``c_attn`` shard takes heads ``[r·nh/tp, (r+1)·nh/tp)`` of each of q, k and v:
columns ``[q_r | k_r | v_r]``. `parallel/pipeline.py:73-82 relayout_qkv` of the JAX
package does the same for the pipeline's TP. The spec itself (which dim, which axis)
is unchanged, so `param_specs` still equals JAX's leaf for leaf.
"""
from __future__ import annotations

import functools
import re
from typing import Any, Optional, Tuple

import torch

from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, all_gather


def P(*entries) -> Tuple:
    """A partition spec: ``P(None, "fsdp", "tp")``, ``P(("dp", "fsdp"))``, ``P()``."""
    return tuple(entries)


# first match wins; paths look like "blocks/attn/c_attn/weight"
PARAM_RULES = (
    # token embedding (V, D): vocab over tp, embed over fsdp
    (r"^wte/weight$", P("tp", "fsdp")),
    # lm head (D, V): column-parallel over tp
    (r"^lm_head/weight$", P("fsdp", "tp")),
    # fused qkv (L, D, 3D): column-parallel
    (r"blocks/attn/c_attn/(weight|qweight)$", P(None, "fsdp", "tp")),
    (r"blocks/attn/c_attn/(scales|zeros|outlier_w)$", P(None, None, "tp")),
    # attn out-proj (L, D, D): row-parallel
    (r"blocks/attn/c_proj/(weight|qweight)$", P(None, "tp", "fsdp")),
    (r"blocks/attn/c_proj/(scales|zeros|outlier_w)$", P(None, None, "fsdp")),
    # mlp up projections (L, D, H): column-parallel
    (r"blocks/mlp/c_fc[12]/(weight|qweight)$", P(None, "fsdp", "tp")),
    (r"blocks/mlp/c_fc[12]/(scales|zeros|outlier_w)$", P(None, None, "tp")),
    # mlp down projection (L, H, D): row-parallel
    (r"blocks/mlp/c_proj/(weight|qweight)$", P(None, "tp", "fsdp")),
    (r"blocks/mlp/c_proj/(scales|zeros|outlier_w)$", P(None, None, "fsdp")),
    # int8 outlier row indices (L, n_out): tiny, replicate
    (r"outlier_idx$", P()),
    # MoE stacked experts: expert axis over fsdp, in-expert hidden dim over tp;
    # the router replicates (tiny, f32)
    (r"blocks/moe/c_fc[12]/weight$", P(None, "fsdp", None, "tp")),
    (r"blocks/moe/c_proj/weight$", P(None, "fsdp", "tp", None)),
    (r"blocks/moe/router/weight$", P()),
    # LoRA: the JAX package's two rules, kept word for word. They never match the
    # real paths (blocks/attn/c_attn/lora_A, .../lora_B), so every PEFT leaf falls
    # through to the last rule and is replicated, as in the JAX package
    (r"lora/.*/lora_A$", P(None, None, "fsdp")),
    (r"lora/.*/lora_B$", P(None, "tp", None)),
    # adapter v1: tiny, replicate
    (r"adapter/", P()),
    # norms & everything else 1-2D small: replicate
    (r".*", P()),
)

# activations / data
BATCH_SPEC = P(("dp", "fsdp"))  # batch dim sharded over dp×fsdp for data parallel
# KV cache (L, B, nh, S, hd): batch over dp, heads over tp
KV_CACHE_SPEC = P(None, "dp", "tp", None, None)

_HEAD_ALIGNED = re.compile(r"blocks/attn/c_attn/(weight|qweight|scales|zeros|outlier_w)$")


@functools.lru_cache(maxsize=None)
def _match(path: str, rules=PARAM_RULES) -> Tuple:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return P()


def spec_of(path: str, rules=PARAM_RULES) -> Tuple:
    return _match(path, rules)


def path_of(keys) -> str:
    """``"a/b/c"`` from a sequence of dict keys (or list indices)."""
    return "/".join(str(k) for k in keys)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested-dict tree, paths like ``"blocks/attn/c_attn/weight"``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_specs(params: Any, rules=PARAM_RULES) -> Any:
    """Tree of specs matching ``params``' structure."""
    return map_with_path(lambda path, _: _match(path, rules), params)


def axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Tuple) -> Tuple[str, ...]:
    """Every mesh axis that a spec splits some dim over."""
    return tuple(a for entry in spec for a in axes_of(entry))


def replication(spec: Tuple, mesh: Mesh) -> int:
    """How many ranks hold each element of a leaf of this spec."""
    used = spec_axes(spec)
    n = 1
    for a in mesh.axis_names:
        if a not in used:
            n *= mesh.shape[a]
    return n


def is_head_aligned(path: str) -> bool:
    return bool(_HEAD_ALIGNED.search(path))


def heads_view(t: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., 3D)`` -> ``(..., 3, n, 3D / (3n))``: q, k, v, each cut into n head groups."""
    return t.unflatten(-1, (3, n, t.shape[-1] // (3 * n)))


def shard_leaf(t: torch.Tensor, spec: Tuple, mesh: Mesh, head_aligned: bool = False,
               device=None) -> torch.Tensor:
    """This rank's slice of the full leaf ``t``, contiguous and owning its memory (on
    ``device`` when given), so that the full tree can be freed."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        n, i = mesh.size(axes), mesh.index(axes)
        if n == 1:
            continue
        if head_aligned and dim == t.dim() - 1 and axes == ("tp",):
            t = heads_view(t, n).select(-2, i).flatten(-2)
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over "
                             f"{axes} ({n} ranks)")
        piece = t.shape[dim] // n
        t = t.narrow(dim, i * piece, piece)
    out = t.to(device) if device is not None else t
    return out.clone() if out.data_ptr() == t.data_ptr() or not out.is_contiguous() else out


def unshard_leaf(t: torch.Tensor, spec: Tuple, mesh: Mesh,
                 head_aligned: bool = False) -> torch.Tensor:
    """The full leaf from every rank's `shard_leaf` (a collective over the spec's axes)."""
    for dim in reversed(range(len(spec))):
        axes = axes_of(spec[dim])
        if not axes or mesh.size(axes) == 1:
            continue
        if head_aligned and dim == t.dim() - 1 and axes == ("tp",):
            parts = all_gather(t.unflatten(-1, (3, 1, t.shape[-1] // 3)), mesh, axes, -2)
            t = parts.flatten(-3)
            continue
        t = all_gather(t, mesh, axes, dim)
    return t


def rules_for(mesh: Optional[Mesh]):
    """The rules that place a tree on ``mesh``: `PARAM_RULES`, or on a mesh with a
    ``pp`` axis `parallel/pipeline.PP_PARAM_RULES` (the blocks' layer axis over it)."""
    if mesh is not None and "pp" in mesh.axis_names:
        from lit_llama_ja_tpu_torch.parallel.pipeline import PP_PARAM_RULES

        return PP_PARAM_RULES
    return PARAM_RULES


def shard_params(params: Any, mesh: Mesh, rules=None, device=None) -> Any:
    """This rank's slice of every leaf of a full (host or single-device) tree, by
    ``rules`` (default `rules_for` the mesh)."""
    rules = rules_for(mesh) if rules is None else rules
    return map_with_path(
        lambda path, t: shard_leaf(t, _match(path, rules), mesh, is_head_aligned(path), device),
        params)


def gather_params(params: Any, mesh: Mesh, rules=None) -> Any:
    """The full tree from every rank's `shard_params` slice (collective)."""
    rules = rules_for(mesh) if rules is None else rules
    return map_with_path(
        lambda path, t: unshard_leaf(t, _match(path, rules), mesh, is_head_aligned(path)),
        params)


def check_divisible(config, mesh: Optional[Mesh]) -> None:
    """The widths that `shard_params` and the sharded forward split must divide."""
    if mesh is None:
        return
    tp = mesh.shape["tp"]
    if config.n_head % tp:
        raise ValueError(f"n_head {config.n_head} does not split over tp={tp}")
    if config.padded_vocab_size % tp:
        raise ValueError(f"padded_vocab_size {config.padded_vocab_size} does not split "
                         f"over tp={tp}")

