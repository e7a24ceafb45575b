"""Mixture-of-Experts LLaMA variant with token-choice routing (counterpart of
`lit_llama_ja_tpu/models/moe.py`; the reference has no MoE).

The parameter tree is the JAX package's: the dense blocks' ``mlp`` is replaced by

    "moe": {"router": {"weight": (L, D, E)},            # always f32
            "c_fc1":  {"weight": (L, E, D, H)}, "c_fc2": {"weight": (L, E, D, H)},
            "c_proj": {"weight": (L, E, H, D)}}

so one numpy tree feeds both packages (`io/from_jax.params_from_numpy`).

The semantics are the JAX package's, kept exactly:
  * fixed-capacity token-choice routing (GShard/Switch): C slots an expert, the
    tokens that overflow are dropped (their residual passes through);
  * k-major order: every token's primary route claims its slot before any secondary
    route, so congestion drops secondaries first;
  * top-k gates renormalised over the k chosen experts; ties between equal router
    probabilities go to the lower expert index, as ``jax.lax.top_k`` orders them;
  * the router runs in f32 whatever the params' dtype: its leaf stays f32 under a
    ``compute_dtype`` cast (`train/step.cast_floating`, `models/llama.cast_params`),
    and the product ``x @ router`` is taken in f32;
  * a dropped assignment adds a zero into its expert's last slot and is masked out
    of the combine, so every real slot receives exactly one nonzero contribution and
    the dispatch's bits (and those of the combine's backward) do not depend on the
    order of the adds;
  * the aux statistics are taken before the drop (``f`` over all k·N routes) and
    averaged over layers.

Dispatch and combine are `index_add` and `index_select` over the flattened (E*C, D)
queue; the expert products (``ecd,edh->ech``) are batched matmuls. Where the JAX
package scans over layers the port loops in Python.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, find_multiple
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.models.llama import (
    _check_params_device,
    _rope_for_positions,
    attention_block,
    block_config,
    embed,
    host_roll,
    layer_params,
    lm_head,
    unstack_layers,
)
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm

Params = Dict[str, Any]
AUX_KEYS = ("load_balance", "router_z", "dropped")


@dataclass(frozen=True)
class MoEConfig(LLaMAConfig):
    """LLaMAConfig plus the MoE fields. ``from_name`` is inherited and returns an
    MoEConfig."""

    n_expert: int = 8
    n_expert_active: int = 2  # top-k routes a token
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3

    def capacity(self, n_tokens: int) -> int:
        """Slots an expert for a batch of ``n_tokens``."""
        c = int(n_tokens * self.n_expert_active * self.capacity_factor / self.n_expert)
        return max(find_multiple(max(c, 1), 8), 8)


def init_moe_params(
    generator: torch.Generator,
    config: MoEConfig,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Params:
    """A parameter tree with the JAX package's shapes and std, N(0, 0.02 /
    sqrt(2 * n_layer)), from ``generator`` (the numbers differ from JAX's). The
    router is f32 whatever ``dtype`` is."""
    dev = resolve_device(device)
    L, D, H, V = config.n_layer, config.n_embd, config.n_hidden, config.padded_vocab_size
    E = config.n_expert
    std = 0.02 / (2 * L) ** 0.5

    def normal(*shape, dt=dtype):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * std).to(device=dev, dtype=dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "wte": {"weight": normal(V, D)},
        "lm_head": {"weight": normal(D, V)},
        "ln_f": {"scale": ones(D)},
        "blocks": {
            "rms_1": {"scale": ones(L, D)},
            "attn": {
                "c_attn": {"weight": normal(L, D, 3 * D)},
                "c_proj": {"weight": normal(L, D, D)},
            },
            "rms_2": {"scale": ones(L, D)},
            "moe": {
                "router": {"weight": normal(L, D, E, dt=torch.float32)},
                "c_fc1": {"weight": normal(L, E, D, H)},
                "c_fc2": {"weight": normal(L, E, D, H)},
                "c_proj": {"weight": normal(L, E, H, D)},
            },
        },
    }


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route_tokens(
    router_w: torch.Tensor,  # (D, E) f32
    xf: torch.Tensor,  # (N, D)
    k: int,
    capacity: int,
    slot_offsets=None,
):
    """Token-choice top-k routing with a fixed capacity.

    Returns ``(gate (N, k), expert (N, k), pos (N, k), keep (N, k), stats)``: ``pos`` is
    the assignment's slot in its expert's queue, ``keep`` masks the assignments past
    ``capacity``; ``stats`` holds ``f`` (the share of the k·N routes an expert gets,
    before the drop), ``P`` (the mean router probability), ``router_z`` and
    ``dropped`` (the share of assignments dropped).

    ``slot_offsets`` (a batch split over ranks, `parallel/sharded.ShardedMoE`): a
    function of this rank's routes a level and expert, ``(k, E)``, that returns the
    slots taken before this rank's level-``j`` routes in the global k-major order (every
    rank's levels below ``j``, then the ranks before this one at ``j``). ``keep`` then
    holds the global rule (a route's global slot under ``capacity``), while ``pos``
    stays the slot in this rank's own queue, which is never above the global one."""
    N = xf.shape[0]
    E = router_w.shape[-1]
    logits = xf.float() @ router_w.float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower expert first
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :k], expert[:, :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # k-major order: primary routes claim capacity slots first. The running count of
    # each expert is a scan along the contiguous rows of the (E, k*N) transpose: on
    # CUDA a scan down the E columns of (k*N, E) runs E threads wide.
    assign = expert.t().reshape(-1)  # (k*N,)
    onehot = F.one_hot(assign, E).to(torch.int32)  # (k*N, E)
    running = torch.cumsum(onehot.t().contiguous(), dim=1).t()
    pos_flat = (running * onehot).sum(-1) - 1
    pos = pos_flat.reshape(k, N).t()  # (N, k)
    if slot_offsets is None:
        keep = pos < capacity
    else:
        counts = onehot.view(k, N, E).sum(1)  # (k, E) this rank's routes a level
        shift = slot_offsets(counts) - (torch.cumsum(counts, 0) - counts)
        keep = pos + torch.gather(shift, 1, expert.t()).t() < capacity

    stats = {
        "f": onehot.float().mean(0),
        "P": probs.mean(0),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "dropped": 1.0 - keep.float().mean(),
    }
    return gate, expert, pos, keep, stats


def finalize_aux(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The aux losses from the routing statistics: ``load_balance = E * sum(f * P)``
    (1 at uniform routing), ``router_z``, and the ``dropped`` share."""
    E = stats["f"].shape[-1]
    return {
        "load_balance": E * torch.sum(stats["f"] * stats["P"], dim=-1),
        "router_z": stats["router_z"],
        "dropped": stats["dropped"],
    }


def moe_mlp(
    moe_params: Params,  # one layer: router (D, E), experts (E, D, H) / (E, H, D)
    x: torch.Tensor,  # (B, T, D)
    config: MoEConfig,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sparse SwiGLU MLP: route, dispatch into ``(E, C, D)`` queues, the experts'
    batched SwiGLU, combine weighted by the gates. `llama.mlp_block` plus the aux
    losses.

    On a mesh the layer is a `parallel/sharded.ShardedMoE`. Without an explicit
    ``capacity`` (the training forward, whose batch is split over ``("dp", "fsdp")``) it
    routes the global batch as one device would: its capacity is that of the global
    token count and its ``slot_offsets`` place each route in the global k-major order,
    so that every rank keeps the routes one device keeps; its ``stats_hook`` averages
    the routing statistics over the batch ranks; under ``tp`` it holds its share of
    every expert's hidden dim and carries ``tp_hooks``: the experts' input and the gates
    pass the first (identity forward, gradient summed over ``tp``), the combined output
    the second (summed over ``tp``)."""
    B, T, D = x.shape
    N = B * T
    k, E = config.n_expert_active, config.n_expert
    # a batch split over ranks routes as one: the capacity of the global token count,
    # the slots in the global k-major order (`route_tokens`)
    global_order = capacity is None and hasattr(moe_params, "slot_offsets")
    C = capacity if capacity is not None else config.capacity(
        N * (moe_params.batch_ranks if global_order else 1))
    xf = x.reshape(N, D)

    gate, expert, pos, keep, stats = route_tokens(
        moe_params["router"]["weight"], xf, k, C,
        moe_params.slot_offsets if global_order else None)
    stats_hook = getattr(moe_params, "stats_hook", None)
    if stats_hook is not None:
        stats = stats_hook(stats)
    aux = finalize_aux(stats)
    tp_in, tp_out = getattr(moe_params, "tp_hooks", (None, None))
    if tp_in is not None:
        xf, gate = tp_in(xf), tp_in(gate)

    # dispatch into the (E*C, D) queue rows: a dropped assignment adds zero to its
    # expert's last slot, so every real slot sums one nonzero row and zeros, and the
    # adds (atomic on CUDA, as are those of the combine's backward) keep their bits
    # in any order
    pos_c = torch.where(keep, pos, C - 1)
    slot = (expert * C + pos_c).reshape(-1)  # (N*k,)
    contrib = keep[..., None].to(x.dtype)  # (N, k, 1)
    buf = x.new_zeros((E * C, D)).index_add(
        0, slot, (contrib * xf[:, None, :]).reshape(N * k, D)).view(E, C, D)

    w1 = moe_params["c_fc1"]["weight"].to(x.dtype)
    w2 = moe_params["c_fc2"]["weight"].to(x.dtype)
    wp = moe_params["c_proj"]["weight"].to(x.dtype)
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w2)  # (E, C, H)
    y_e = torch.bmm(h, wp)  # (E, C, D)

    # combine: each assignment's expert output, weighted by its gate
    y_tok = y_e.reshape(E * C, D).index_select(0, slot).view(N, k, D)
    w = (gate[..., None] * keep[..., None]).to(x.dtype)
    y = torch.sum(y_tok * w, dim=1)
    if tp_out is not None:
        y = tp_out(y)
    return y.reshape(B, T, D), aux


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

def moe_transformer_block(
    block_params: Params,
    x: torch.Tensor,
    rope: torch.Tensor,
    config: MoEConfig,
    kv_cache=None,
    input_pos=None,
    capacity: Optional[int] = None,
    prefill_attn: bool = False,
    roll: bool = False,
):
    """Pre-norm residual block with the MLP replaced by the sparse MoE."""
    h, new_cache = attention_block(
        block_params["attn"],
        rmsnorm(x, block_params["rms_1"]["scale"], config.norm_eps),
        rope,
        config,
        kv_cache,
        input_pos,
        prefill_attn=prefill_attn,
        roll=roll,
    )
    x = x + h
    y, aux = moe_mlp(
        block_params["moe"],
        rmsnorm(x, block_params["rms_2"]["scale"], config.norm_eps),
        config,
        capacity,
    )
    return x + y, new_cache, aux


def forward_moe(
    params: Params,
    idx: torch.Tensor,
    config: MoEConfig,
    device="cuda",
    remat: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward: ``(B, T)`` ids -> ``(logits, aux)``, the aux losses
    averaged over layers (add ``aux_loss_coef * load_balance + router_z_coef *
    router_z`` to the task loss when training). ``remat`` checkpoints each block, as
    `models/llama.forward` does; ``mesh`` runs it sharded, as there (the experts' E
    axis over ``fsdp``, their hidden dim over ``tp``)."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, None, idx.shape[1], dev)
    x = embed(params, idx, mesh)
    bconfig = block_config(config, mesh)

    def block(x, l):
        x, _, aux = moe_transformer_block(layer_params(params["blocks"], l, mesh), x, rope,
                                          bconfig)
        return (x, *(aux[key] for key in AUX_KEYS))

    per_layer = []
    for l in range(config.n_layer):
        if remat:
            x, *aux = checkpoint(block, x, l, use_reentrant=False, preserve_rng_state=False)
        else:
            x, *aux = block(x, l)
        per_layer.append(aux)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    aux = {key: torch.stack([a[i] for a in per_layer]).mean()
           for i, key in enumerate(AUX_KEYS)}
    return lm_head(params, x, mesh), aux


@torch.no_grad()
def forward_moe_with_cache(
    params: Params,
    idx: torch.Tensor,
    input_pos: torch.Tensor,
    kv_cache,
    config: MoEConfig,
    prefill_attn: bool = False,
    device="cuda",
    mesh=None,
    *,
    roll: Optional[bool] = None,
):
    """Incremental forward with a KV cache, `models/llama.forward_with_cache`'s contract
    (the cache updated in place; ``mesh`` and ``roll`` as there). The capacity
    covers every assignment, ``find_multiple(N * k, 8)``, so nothing drops at decode; the
    routing's shapes are static, so a step on device positions reads nothing back to the
    host."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    if roll is None:
        roll = host_roll(input_pos, kv_cache["k"].shape[3])
    input_pos = input_pos.to(dev, non_blocking=True)
    idx = torch.as_tensor(idx, device=dev)
    rope = _rope_for_positions(config, input_pos, idx.shape[1], dev)
    x = embed(params, idx, mesh)
    cap = find_multiple(idx.shape[0] * idx.shape[1] * config.n_expert_active, 8)
    bconfig = block_config(config, mesh)
    for l, cache_l in enumerate(unstack_layers(kv_cache, config.n_layer)):
        x, _, _ = moe_transformer_block(
            layer_params(params["blocks"], l, mesh), x, rope, bconfig, kv_cache=cache_l,
            input_pos=input_pos, capacity=cap, prefill_attn=prefill_attn, roll=roll,
        )
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh), kv_cache


def moe_penalty(config: MoEConfig, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    return config.aux_loss_coef * aux["load_balance"] + config.router_z_coef * aux["router_z"]


def make_moe_train_step(config: MoEConfig, optimizer, *, remat: bool = False,
                        compute_dtype: Optional[torch.dtype] = None, device="cuda",
                        mesh=None, cuda_graph: bool = True):
    """The MoE train step: `forward_moe` and its weighted aux losses in
    `train/step.make_train_step` (gradient accumulation, in-place update, the
    ``compute_dtype`` cast, which keeps the router f32; ``mesh`` and ``cuda_graph`` as
    there: one captured graph on a CUDA device without a mesh). The routing's shapes
    are static and its statistics stay on the device, so the step reads nothing back
    to the host."""
    from lit_llama_ja_tpu_torch.train.step import make_train_step

    dev = resolve_device(device)

    def fwd(p, x):
        logits, aux = forward_moe(p, x, config, device=dev, remat=remat, mesh=mesh)
        return logits, moe_penalty(config, aux)

    return make_train_step(config, optimizer, forward_fn=fwd, compute_dtype=compute_dtype,
                           device=dev, mesh=mesh, cuda_graph=cuda_graph)


def moe_loss(
    params: Params,
    batch_inputs: torch.Tensor,
    batch_targets: torch.Tensor,
    config: MoEConfig,
    remat: bool = False,
    device="cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy plus the weighted aux losses (the MoE train objective)."""
    dev = resolve_device(device)
    logits, aux = forward_moe(params, batch_inputs, config, device=dev, remat=remat)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = torch.as_tensor(batch_targets, device=dev).long()
    ce = -torch.gather(logp, -1, targets[..., None])[..., 0].mean()
    return ce + moe_penalty(config, aux), {**aux, "ce": ce}
