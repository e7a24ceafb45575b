"""Sharded execution over a ``(dp, fsdp, tp)`` mesh: what GSPMD inserts for the JAX
package.

The JAX package annotates each leaf with a `parallel/specs.py` spec and lets XLA's
partitioner insert the all-gathers and reductions (`train/step.py:222-242
jit_train_step`, the CLIs' ``shard_params``). It has no module for that step; this
one is its counterpart, written with explicit `torch.distributed` collectives, since
the port's forward calls its kernels on plain tensors. Each rank holds its
`specs.shard_params` slice of every leaf, and:

  * ``fsdp`` — a leaf is all-gathered along its ``fsdp`` dim just before its layer
    runs (`layer_view`) and dropped after it; the gather's backward reduce-scatters
    the gradient (ZeRO-3). With ``remat`` the gather sits inside the checkpointed
    block, so the backward gathers again instead of keeping the gathered weights.
  * ``tp`` — ``c_attn``, ``c_fc1`` and ``c_fc2`` are column-parallel (this rank's heads
    and hidden columns; ``c_attn`` head-aligned, see `specs.py`); the two ``c_proj``
    are row-parallel, their partial products all-reduced over ``tp``. The blocks run
    with `local_config` (``nh / tp`` heads of the same head_dim), so the KV cache and
    the page pool hold this rank's heads (`specs.KV_CACHE_SPEC`; an int4 head-pair
    cache needs ``nh / tp`` even). The embedding is vocab-parallel (a masked lookup,
    all-reduced), the lm_head column-parallel with its logits all-gathered. The MoE
    experts split their hidden dim the same way (their E axis goes over ``fsdp``).
  * Quantized linears shard as plain ones. A row-parallel shard of an int4 or int8
    pack takes the scale rows of its own K range by the ragged-group rule of the whole
    matrix (`k_shard_groups`); llm.int8's static outliers (``outlier_idx``
    replicated) add only the rows that fall in the shard. The sub-4-bit packs (whose K
    is padded) and llm.int8-dyn (whose outlier choice is global) run only without
    ``tp``.

The rank-local math is the single-device path's (`models/llama.py`,
`models/moe.py`, `quant/linear.py`): `layer_view` hands those functions per-layer
trees whose linears are `ColumnLinear` / `RowLinear` dicts, which
`llama.apply_linear` recognises, so every kernel launch is the one-device launch at a
shard's shape.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    copy_to,
    gather,
    gather_replicated,
    mean_over,
    reduce_from,
)
from lit_llama_ja_tpu_torch.parallel.specs import axes_of, map_with_path, spec_of

Params = Dict[str, Any]

_COLUMN = {("attn", "c_attn"), ("mlp", "c_fc1"), ("mlp", "c_fc2")}
_ROW = {("attn", "c_proj"), ("mlp", "c_proj")}


def tp_size(mesh: Mesh) -> int:
    return mesh.shape["tp"]


def local_config(config: LLaMAConfig, mesh) -> LLaMAConfig:
    """The config one rank's blocks compute with: ``nh / tp`` heads and a width of
    ``n_embd / tp``, the head_dim unchanged (the RoPE table and every head-shaped
    buffer follow from it). The identity without ``tp``."""
    tp = 1 if mesh is None else tp_size(mesh)
    if tp == 1:
        return config
    if config.n_head % tp:
        raise ValueError(f"n_head {config.n_head} does not split over tp={tp}")
    return config.replace(n_head=config.n_head // tp, n_embd=config.n_embd // tp)


def k_shard_groups(t: torch.Tensor, K: int, start: int, K_loc: int) -> torch.Tensor:
    """The scale (or zero) rows ``(G, N)`` of a K-shard ``[start, start + K_loc)`` of a
    pack over K rows, such that the shard's own tile rule (`quant/linear._expand_tiles`:
    tile ``ceil(K_loc / G_loc)``) gives every row the scale the whole matrix gives it.

    The whole matrix reads row ``k`` from tile row ``k // ceil(K / G)``. The shard's
    tiles are ``gcd(tile, start, K_loc)`` rows, so each lies inside one of the whole
    matrix's tiles: aligned shards keep the tile rows as they are; a ragged one (K = 780
    in groups of 64 is 13 tiles of 60, cut at 390) repeats them."""
    G = t.shape[-2]
    if G == 1:
        return t
    tile = -(-K // G)
    step = math.gcd(tile, start, K_loc)
    rows = torch.arange(start, start + K_loc, step, device=t.device) // tile
    return t.index_select(-2, rows)


def _refuse_unsharded_forms(p: Params) -> None:
    if "qweight_hi" in p or ("qweight" in p and "dyn_threshold" in p):
        raise NotImplementedError(
            "tensor parallelism covers plain, int4, int8 and llm.int8 linears; the "
            "sub-4-bit packs and llm.int8-dyn run with fsdp only")
    if any(k in p for k in ("lora_A", "adapter_bias")):
        raise NotImplementedError("LoRA and adapter leaves run without tensor parallelism")


class ColumnLinear(dict):
    """A column-parallel linear: this rank's output columns; the input's gradient is
    all-reduced over ``tp``."""

    def __init__(self, leaves: Params, mesh: Mesh):
        super().__init__(leaves)
        _refuse_unsharded_forms(leaves)
        self.mesh = mesh

    def parallel_apply(self, x: torch.Tensor, apply_linear, **kw) -> torch.Tensor:
        if "qweight" in self and x.shape[-1] != 2 * self["qweight"].shape[-2] and (
                x.shape[-1] != self["qweight"].shape[-2]):
            raise NotImplementedError("sub-4-bit packs run with fsdp only")
        return apply_linear(dict(self), copy_to(x, self.mesh, "tp"), **kw)


class RowLinear(dict):
    """A row-parallel linear: this rank's K rows against its slice of the input; the
    partial products are all-reduced over ``tp``."""

    def __init__(self, leaves: Params, mesh: Mesh):
        super().__init__(leaves)
        _refuse_unsharded_forms(leaves)
        self.mesh = mesh

    def parallel_apply(self, x: torch.Tensor, apply_linear, **kw) -> torch.Tensor:
        p = dict(self)
        K_loc = x.shape[-1]
        start = self.mesh.index("tp") * K_loc
        K = K_loc * tp_size(self.mesh)
        outlier_w = p.pop("outlier_w", None)
        outlier_idx = p.pop("outlier_idx", None)
        if "qweight" in p:
            rows = p["qweight"].shape[-2]
            if rows != K_loc and 2 * rows != K_loc:
                raise NotImplementedError("sub-4-bit packs run with fsdp only")
            p["scales"] = k_shard_groups(p["scales"], K, start, K_loc)
            p["zeros"] = k_shard_groups(p["zeros"], K, start, K_loc)
        y = apply_linear(p, x, **kw)
        if outlier_w is not None:
            idx = outlier_idx.long()
            inside = ((idx >= start) & (idx < start + K_loc)).to(x.dtype)
            xo = x[..., (idx - start).clamp(0, K_loc - 1)] * inside
            y = y + xo @ outlier_w.to(x.dtype)
        return reduce_from(y, self.mesh, "tp")


class ShardedMoE(dict):
    """An MoE layer on a mesh, read by `models/moe.moe_mlp`:

    * ``batch_ranks`` and ``slot_offsets`` route a batch split over the batch axes
      ``("dp", "fsdp")`` as GSPMD routes the global batch: the capacity of the global
      token count, and each route's slot in the global k-major order. The ranks
      all-gather their routes a level and expert, ``(k, E)``; a route's global slot is
      its rank's exclusive prefix in level-major, rank-major order plus its position
      among its rank's routes, and it is kept if that slot is under the capacity. A
      token's expert output reads no other token, so the queue stays this rank's own
      (``C`` rows an expert, the kept routes at their local slots);
    * ``stats_hook`` averages the routing statistics over the batch axes (`mean_over`)
      before the aux losses, so that they (the ``dropped`` share too) are the global
      batch's;
    * ``tp_hooks``, under ``tp``, where the experts hold this rank's hidden columns: the
      experts' input and the gates enter through `copy_to`, the combined output leaves
      through `reduce_from`, so the router's gradient sums the experts' partial
      contributions."""

    def __init__(self, leaves: Params, mesh: Mesh):
        super().__init__(leaves)
        batch = ("dp", "fsdp")
        self.batch_ranks = mesh.size(batch)

        def slot_offsets(counts: torch.Tensor) -> torch.Tensor:
            every = all_gather(counts[None], mesh, batch, 0)  # (ranks, k, E)
            level = every.sum(0)
            return (torch.cumsum(level, 0) - level) + every[:mesh.index(batch)].sum(0)

        self.slot_offsets = slot_offsets
        self.stats_hook = lambda stats: {k: mean_over(v, mesh, batch)
                                         for k, v in stats.items()}
        if tp_size(mesh) > 1:
            self.tp_hooks = (lambda t: copy_to(t, mesh, "tp"),
                             lambda t: reduce_from(t, mesh, "tp"))


def _gather_fsdp(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        if "fsdp" in axes_of(entry):
            t = gather(t, mesh, "fsdp", dim)
    return t


def layer_view(blocks: Params, l: int, mesh: Mesh) -> Params:
    """Layer ``l`` of a sharded stacked ``blocks`` tree as this rank computes it: the
    ``fsdp`` dims gathered (differentiably), the tensor-parallel linears wrapped."""
    view = map_with_path(
        lambda path, t: _gather_fsdp(t[l], spec_of("blocks/" + path)[1:], mesh), blocks)
    if "moe" in view:
        view["moe"] = ShardedMoE(view["moe"], mesh)
    if tp_size(mesh) == 1:
        return view
    for group, name in _COLUMN | _ROW:
        if group in view and name in view[group]:
            cls = ColumnLinear if (group, name) in _COLUMN else RowLinear
            view[group][name] = cls(view[group][name], mesh)
    return view


def embed(params: Params, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Vocab-parallel lookup of ``wte`` ``(V/tp, D/fsdp)`` local: the ``fsdp`` dim
    gathered, ids outside this rank's vocabulary rows give zeros, the rows are summed
    over ``tp``."""
    w = _gather_fsdp(params["wte"]["weight"], spec_of("wte/weight"), mesh)
    if tp_size(mesh) == 1:
        return w[idx]
    V_loc = w.shape[0]
    local = idx - mesh.index("tp") * V_loc
    inside = (local >= 0) & (local < V_loc)
    rows = w[local.clamp(0, V_loc - 1)] * inside[..., None].to(w.dtype)
    return reduce_from(rows, mesh, "tp")


def lm_head(params: Params, x: torch.Tensor, mesh: Mesh, apply_linear) -> torch.Tensor:
    """The lm_head: a plain ``(D/fsdp, V/tp)`` weight is column-parallel and its logits
    are all-gathered over ``tp``; a quantized head is replicated by the rules and runs
    whole on every rank."""
    p = params["lm_head"]
    if "weight" not in p:
        return apply_linear(p, x)
    w = _gather_fsdp(p["weight"], spec_of("lm_head/weight"), mesh)
    if tp_size(mesh) == 1:
        return apply_linear({**p, "weight": w}, x)
    y = apply_linear({**p, "weight": w}, copy_to(x, mesh, "tp"))
    return gather_replicated(y, mesh, "tp", -1)
