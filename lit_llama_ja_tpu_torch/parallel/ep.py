"""Expert parallelism: the MoE forward and train step with the experts split over an
``ep`` axis (counterpart of `lit_llama_ja_tpu/parallel/ep.py`).

The layout is the JAX package's (GShard / Switch):

  * tokens split over ``ep`` on the batch dim: each rank runs attention for its batch
    rows with the dense leaves replicated (plain data parallel for them);
  * experts split over ``ep`` on the E axis of the stacked expert weights
    (``(L, E/ep, D, H)`` on each rank, owner-major: expert ``e`` lives on rank
    ``e // E_local``);
  * each rank routes its own tokens (`models/moe.route_tokens`) into a full
    ``(E, C, D)`` dispatch buffer (the ``index_add`` of `models/moe.moe_mlp`), then ONE
    ``all_to_all_single`` over ``ep`` exchanges queue slices so that each rank holds
    ``(E_local, ep·C, D)``; after the batched expert SwiGLU a mirror exchange returns
    the outputs home for the gate-weighted combine. The exchange is a
    `torch.autograd.Function` whose backward is the mirror exchange
    (`mesh.all_to_all`).

Routing is local (capacity slots are claimed within the rank's own C-slice); the f/P
routing statistics are averaged over ``ep`` before `finalize_aux` (`mesh.mean_over`,
the ``pmean`` of the JAX package), so the aux losses are the global batch's. With room
for every token the result equals the single-device `forward_moe` up to reduction
order; under congestion the drops differ per rank, as in multi-worker GShard.

The train step takes each rank's loss (its rows' cross-entropy plus the aux terms),
sums the replicated leaves' gradients over ``ep`` and divides every gradient by the
axis size (`train/step.sync_grads`), clips by the norm over all shards and applies the
port's AdamW, where the JAX step applies ``optax``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
from lit_llama_ja_tpu_torch.models.llama import (
    _rope_for_positions,
    apply_linear,
    attention_block,
    index_layer,
)
from lit_llama_ja_tpu_torch.models.moe import (
    AUX_KEYS,
    MoEConfig,
    finalize_aux,
    moe_penalty,
    route_tokens,
)
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    all_to_all,
    gather_replicated,
    mean_over,
)
from lit_llama_ja_tpu_torch.parallel.specs import P, map_with_path, shard_leaf
from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss
from lit_llama_ja_tpu_torch.train.step import (
    cast_floating,
    global_grad_norm,
    local_rows,
    sync_grads,
)

Params = Dict[str, Any]

_EXPERT_LEAVES = ("c_fc1", "c_fc2", "c_proj")


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

def ep_spec_of(path: str, axis: str = "ep") -> Tuple:
    """Expert leaves (``blocks/moe/c_*``) split the E axis (dim 1, after the stacked L
    axis); the router and every dense leaf replicate."""
    keys = path.split("/")
    if "moe" in keys and any(k in _EXPERT_LEAVES for k in keys):
        return P(None, axis)
    return P()


def ep_param_specs(params: Params, axis: str = "ep") -> Any:
    return map_with_path(lambda path, _: ep_spec_of(path, axis), params)


def shard_params_ep(params: Params, mesh: Mesh, axis: str = "ep") -> Params:
    """This rank's slice of a full MoE tree: its experts, every dense leaf whole."""
    return map_with_path(lambda path, t: shard_leaf(t, ep_spec_of(path, axis), mesh), params)


# ---------------------------------------------------------------------------
# The expert-parallel MoE MLP
# ---------------------------------------------------------------------------

def moe_mlp_ep(
    moe_params: Params,  # one layer; expert leaves LOCAL: (E_local, D, H) ...
    x: torch.Tensor,  # (B_local, T, D): this rank's tokens
    config: MoEConfig,
    mesh: Mesh,
    axis: str = "ep",
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-choice MoE with an all-to-all dispatch and combine over ``axis``.
    ``capacity`` is the slots a (source rank, expert) pair gets; an expert takes up to
    ``ep·C`` tokens a step."""
    B, T, D = x.shape
    N = B * T
    k, E = config.n_expert_active, config.n_expert
    ep = mesh.size(axis)
    E_local = moe_params["c_fc1"]["weight"].shape[0]
    if E_local * ep != E:
        raise ValueError(f"{E_local} local experts x {ep} ranks != {E} experts")
    C = capacity if capacity is not None else config.capacity(N)
    xf = x.reshape(N, D)

    gate, expert, pos, keep, stats = route_tokens(moe_params["router"]["weight"], xf, k, C)
    # average the f/P STATISTICS (not the finished losses): the global token set's
    # balance, the unsharded value
    aux = finalize_aux({key: mean_over(v, mesh, axis) for key, v in stats.items()})

    pos_c = torch.where(keep, pos, C - 1)
    slot = (expert * C + pos_c).reshape(-1)
    contrib = keep[..., None].to(x.dtype)
    buf = x.new_zeros((E * C, D)).index_add(
        0, slot, (contrib * xf[:, None, :]).reshape(N * k, D))

    # exchange: rank e receives every source's queue slices of its experts
    # (ep·E_local·C, D) -> chunks by owner -> (ep_src, E_local, C, D) -> (E_local, ep·C, D)
    buf = all_to_all(buf, mesh, axis).view(ep, E_local, C, D)
    buf = buf.transpose(0, 1).reshape(E_local, ep * C, D)

    w1 = moe_params["c_fc1"]["weight"].to(x.dtype)
    w2 = moe_params["c_fc2"]["weight"].to(x.dtype)
    wp = moe_params["c_proj"]["weight"].to(x.dtype)
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w2)
    y_e = torch.bmm(h, wp)  # (E_local, ep·C, D)

    # mirror exchange back to each token's home rank: owner-major == expert id
    y_e = y_e.view(E_local, ep, C, D).transpose(0, 1).reshape(ep * E_local * C, D)
    y_e = all_to_all(y_e, mesh, axis)  # (E·C, D)

    y_tok = y_e.index_select(0, slot).view(N, k, D)
    w = (gate[..., None] * keep[..., None]).to(x.dtype)
    return torch.sum(y_tok * w, dim=1).reshape(B, T, D), aux


def _forward_local(params, idx_local, config, mesh, axis, capacity, remat):
    """Logits of this rank's rows and the aux losses averaged over layers."""
    T = idx_local.shape[1]
    rope = _rope_for_positions(config, None, T, idx_local.device)
    x = params["wte"]["weight"][idx_local]

    def block(x, l):
        bp = index_layer(params["blocks"], l)
        h, _ = attention_block(bp["attn"], rmsnorm(x, bp["rms_1"]["scale"], config.norm_eps),
                               rope, config)
        x = x + h
        y, aux = moe_mlp_ep(bp["moe"], rmsnorm(x, bp["rms_2"]["scale"], config.norm_eps),
                            config, mesh, axis, capacity)
        return (x + y, *(aux[key] for key in AUX_KEYS))

    per_layer = []
    for l in range(config.n_layer):
        if remat:
            x, *aux = checkpoint(block, x, l, use_reentrant=False)
        else:
            x, *aux = block(x, l)
        per_layer.append(aux)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    aux = {key: torch.stack([a[i] for a in per_layer]).mean() for i, key in enumerate(AUX_KEYS)}
    return apply_linear(params["lm_head"], x), aux


def make_forward_moe_ep(config: MoEConfig, mesh: Mesh, params_proto: Params = None, *,
                        axis: str = "ep", capacity: Optional[int] = None,
                        remat: bool = False, device="cuda"):
    """``forward(params, idx (B, T)) -> (logits (B, T, V), aux)`` with the batch and the
    experts split over ``axis``: ``params`` is this rank's `shard_params_ep` slice,
    ``idx`` the whole batch (B divisible by the axis size); every rank returns the
    whole logits. ``params_proto`` is accepted for the JAX signature."""
    del params_proto
    dev = resolve_device(device)

    def forward(params, idx):
        idx = torch.as_tensor(idx, device=dev)
        logits, aux = _forward_local(params, local_rows(idx, mesh, 0, (axis,)), config, mesh,
                                     axis, capacity, remat)
        return gather_replicated(logits, mesh, axis, 0), aux

    return forward


def forward_moe_ep(params: Params, idx: torch.Tensor, config: MoEConfig, mesh: Mesh,
                   axis: str = "ep", capacity: Optional[int] = None, device="cuda"):
    """`make_forward_moe_ep` applied once."""
    return make_forward_moe_ep(config, mesh, axis=axis, capacity=capacity,
                               device=device)(params, idx)


def make_moe_train_step_ep(config: MoEConfig, optimizer, mesh: Mesh, *, axis: str = "ep",
                           capacity: Optional[int] = None, remat: bool = False,
                           compute_dtype: Optional[torch.dtype] = None, device="cuda"):
    """The expert-parallel MoE train step. ``.jit_with(params)`` (the JAX signature)
    returns ``step(params, opt_state, batch (B, T+1)) -> (params, opt_state, loss)``:
    ``params`` and ``opt_state`` are this rank's slices, updated in place; ``batch``
    is the whole batch; ``loss`` is the global batch's cross-entropy plus the weighted
    aux losses, on every rank."""
    dev = resolve_device(device)

    def spec_fn(path):
        return ep_spec_of(path, axis)

    def step(params, opt_state, batch):
        batch = local_rows(torch.as_tensor(batch, device=dev), mesh, 0, (axis,))
        leaves = flatten_tree(params)
        try:
            for t in leaves.values():
                t.requires_grad_(True)
            logits, aux = _forward_local(cast_floating(params, compute_dtype), batch[:, :-1],
                                         config, mesh, axis, capacity, remat)
            loss = cross_entropy_loss(logits, batch[:, 1:]) + moe_penalty(config, aux)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        grads = sync_grads(dict(zip(leaves, grads)), mesh, spec_fn, data_axes=(axis,))
        norm = (global_grad_norm(grads, mesh, spec_fn)
                if optimizer.grad_clip is not None else None)
        optimizer.apply(leaves, grads, opt_state, norm)
        loss = all_reduce(loss.detach(), mesh, axis) / mesh.size(axis)
        return params, opt_state, loss

    class _Builder:
        @staticmethod
        def jit_with(params_proto):
            del params_proto
            return step

    return _Builder()
