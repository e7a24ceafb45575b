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
    replicated) add only the rows that fall in the shard.
  * The sub-4-bit packs store a padded ``Kp = sub4_pad_rows(K, g)`` rows, and JAX's
    specs give a row-parallel rank the stored rows ``[r·Kp/tp, (r+1)·Kp/tp)``, which
    do not line up with the activation's ``K/tp`` split: such a rank all-gathers x
    over ``tp``, zero-pads it to Kp, runs K4 or K5 on its columns of it and its
    rows of the pack, and the partial products are all-reduced. The high-bit plane of
    int3 (``qweight_hi``, replicated by the rules) is cut to the rank's columns or
    rows where it is used. llm.int8-dyn picks its outlier columns by a top-k over all
    of K: a column-parallel rank sees the whole x; a row-parallel one all-gathers the
    column peaks of its x, so every rank picks the columns one device picks, and adds
    the live ones of its own range (`quant/linear.dynamic_int8_matmul`).
  * LoRA and Adapter v2 leaves are replicated (every PEFT leaf's spec is ``P()``). A
    column-parallel rank uses its columns of ``lora_B``, ``adapter_scale`` and
    ``adapter_bias`` (head-aligned on ``c_attn``) and all of ``lora_A``; each enters
    through `copy_to` before it is cut, so that its gradient sums the ranks' partial
    ones. A row-parallel linear applies its v2 leaves whole after the reduction. The
    LoRA dropout mask is drawn for the whole batch and cut to the rank's rows, so it
    is the one a single device draws.

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
import torch.nn.functional as F

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.models.lora import lora_branch
from lit_llama_ja_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    copy_to,
    gather,
    gather_replicated,
    mean_over,
    reduce_from,
)
from lit_llama_ja_tpu_torch.parallel.specs import axes_of, heads_view, map_with_path, spec_of
from lit_llama_ja_tpu_torch.quant.linear import (
    dynamic_int8_matmul,
    infer_bits_params,
    quant_matmul,
)

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


_PEFT = ("lora_A", "lora_B", "lora_alpha", "adapter_scale", "adapter_bias")
_BATCH = ("dp", "fsdp")


def _base(p: Params) -> Params:
    """A linear's own leaves, without its PEFT leaves."""
    return {k: v for k, v in p.items() if k not in _PEFT}


def _adapter_v2(p: Params, y: torch.Tensor, cut=lambda t: t) -> torch.Tensor:
    if "adapter_bias" not in p:
        return y
    return cut(p["adapter_scale"]).to(y.dtype) * (y + cut(p["adapter_bias"]).to(y.dtype))


class ColumnLinear(dict):
    """A column-parallel linear: this rank's output columns (its heads of q, k and v
    when ``heads``); the input's gradient is all-reduced over ``tp``."""

    def __init__(self, leaves: Params, mesh: Mesh, heads: bool = False):
        super().__init__(leaves)
        self.mesh = mesh
        self.heads = heads

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's output columns of a replicated leaf ``(..., N)``, cut after
        `copy_to`, so that the leaf's gradient sums every rank's columns."""
        tp = tp_size(self.mesh)
        t = copy_to(t, self.mesh, "tp")
        if tp == 1:
            return t
        i = self.mesh.index("tp")
        if self.heads:
            return heads_view(t, tp).select(-2, i).flatten(-2)
        n = t.shape[-1] // tp
        return t.narrow(-1, i * n, n)

    def parallel_apply(self, x: torch.Tensor, apply_linear, dropout_seed=None,
                       dropout_rate: float = 0.0) -> torch.Tensor:
        x = copy_to(x, self.mesh, "tp")
        p = _base(self)
        if "qweight_hi" in p and p["qweight_hi"].shape[-1] != p["qweight"].shape[-1]:
            p["qweight_hi"] = self.cols(p["qweight_hi"]).contiguous()
        y = apply_linear(p, x)
        if "lora_A" in self:
            B = copy_to(self["lora_B"], self.mesh, "tp")
            out = B.shape[-1] // tp_size(self.mesh)
            leaf = {"lora_A": copy_to(self["lora_A"], self.mesh, "tp"),
                    "lora_B": B.narrow(-1, self.mesh.index("tp") * out, out),
                    "lora_alpha": self["lora_alpha"]}
            n, i = self.mesh.size(_BATCH), self.mesh.index(_BATCH)
            y = y + lora_branch(leaf, x, dropout_seed=dropout_seed,
                                dropout_rate=dropout_rate,
                                rows=(i * x.shape[0], n * x.shape[0]))
        return _adapter_v2(self, y, self.cols)


class RowLinear(dict):
    """A row-parallel linear: this rank's K rows against its slice of the input; the
    partial products are all-reduced over ``tp``."""

    def __init__(self, leaves: Params, mesh: Mesh):
        super().__init__(leaves)
        self.mesh = mesh

    def parallel_apply(self, x: torch.Tensor, apply_linear, **kw) -> torch.Tensor:
        mesh, p = self.mesh, _base(self)
        K_loc = x.shape[-1]
        tp = tp_size(mesh)
        start = mesh.index("tp") * K_loc
        K = K_loc * tp
        if "dyn_threshold" in p:
            y = dynamic_int8_matmul(x, p, lambda peak: all_gather(peak, mesh, "tp", 0), start)
        elif "qweight" in p and infer_bits_params(p, K, tp) in (2, 3):
            y = self._padded_rows(p, x, K)
        else:
            outlier_w = p.pop("outlier_w", None)
            outlier_idx = p.pop("outlier_idx", None)
            if "qweight" in p:
                p["scales"] = k_shard_groups(p["scales"], K, start, K_loc)
                p["zeros"] = k_shard_groups(p["zeros"], K, start, K_loc)
            y = apply_linear(p, x)
            if outlier_w is not None:
                idx = outlier_idx.long()
                inside = ((idx >= start) & (idx < start + K_loc)).to(x.dtype)
                xo = x[..., (idx - start).clamp(0, K_loc - 1)] * inside
                y = y + xo @ outlier_w.to(x.dtype)
        return _adapter_v2(self, reduce_from(y, mesh, "tp"))

    def _padded_rows(self, p: Params, x: torch.Tensor, K: int) -> torch.Tensor:
        """A sub-4-bit K-shard: this rank's ``Kp/tp`` stored rows against the same
        columns of x, all-gathered and zero-padded to Kp."""
        mesh = self.mesh
        tp, i = tp_size(mesh), mesh.index("tp")
        Ks = 4 * p["qweight"].shape[-2]
        Kp = Ks * tp
        xs = F.pad(gather(x, mesh, "tp", -1), (0, Kp - K)).narrow(-1, i * Ks, Ks)
        p["scales"] = k_shard_groups(p["scales"], Kp, i * Ks, Ks)
        p["zeros"] = k_shard_groups(p["zeros"], Kp, i * Ks, Ks)
        if "qweight_hi" in p and p["qweight_hi"].shape[-2] != Ks // 8:
            p["qweight_hi"] = p["qweight_hi"].narrow(-2, i * (Ks // 8), Ks // 8)
        return quant_matmul(xs, p, bits=3 if "qweight_hi" in p else 2)


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
        if "lora_A" in view["attn"]["c_attn"]:  # the dropout mask of this rank's rows
            view["attn"]["c_attn"] = ColumnLinear(view["attn"]["c_attn"], mesh, True)
        return view
    for group, name in _COLUMN | _ROW:
        if group in view and name in view[group]:
            leaves = view[group][name]
            if (group, name) in _COLUMN:
                view[group][name] = ColumnLinear(leaves, mesh, (group, name) == ("attn", "c_attn"))
            else:
                view[group][name] = RowLinear(leaves, mesh)
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
    """The lm_head: a plain ``(D/fsdp, V/tp)`` weight is column-parallel (Adapter v2
    leaves cut to its vocab columns) and its logits are all-gathered over ``tp``; a
    quantized head is replicated by the rules and runs whole on every rank."""
    p = params["lm_head"]
    if "weight" not in p:
        return apply_linear(p, x)
    w = _gather_fsdp(p["weight"], spec_of("lm_head/weight"), mesh)
    if tp_size(mesh) == 1:
        return apply_linear({**p, "weight": w}, x)
    head = ColumnLinear({**p, "weight": w}, mesh)
    return gather_replicated(head.parallel_apply(x, apply_linear), mesh, "tp", -1)
