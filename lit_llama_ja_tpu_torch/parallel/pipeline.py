"""Pipeline parallelism over the stacked layer axis (counterpart of
`lit_llama_ja_tpu/parallel/pipeline.py`).

The blocks are stacked on a leading ``(L, ...)`` axis, the natural pipeline boundary:
stage ``s`` of a ``pp``-way pipeline holds layers ``[s·L/pp, (s+1)·L/pp)``, the
``pp`` shard of that axis, with no other change to any leaf. A stage is a process.

Schedule: GPipe, as in the JAX package. The batch comes split into M micro-batches;
at tick ``t`` stage ``s`` runs micro-batch ``t − s`` (when in range) and hands its
activations to stage ``s+1`` with one `mesh.stage_hop` a tick. Where the JAX package
runs every stage at every tick (SPMD) and drops the idle ticks' outputs, a stage here
skips its idle ticks. The bubble is ``(pp−1)/(M+pp−1)``.

Backward: the JAX package derives it with ``jax.grad`` through the unrolled
``ppermute``s. Autograd does not cross processes, so every hop here is a
`mesh.StageHop`, whose backward runs the same hop the other way. On each rank the
hops and the stage computations form one chain (the input of tick ``t+1`` is the hop
output of tick ``t``; on the first stage the hop passes the next micro-batch's
embedding through), so one ``backward`` a rank runs the reverse schedule: the hops'
backwards in reverse tick order on every stage, matched tick by tick. ``remat=True``
checkpoints each block (`torch.utils.checkpoint`), so a stage keeps its stage-boundary
activations and not its blocks'.

The logits come from the last stage. `pipeline_forward` sends them to every stage
(the JAX package psums them over ``pp``); `make_pp_train_step` takes the loss on the
last stage and sends its value to the others. The leaves that ``pp`` does not split
(``wte``, ``ln_f``, ``lm_head``) get their gradient on one stage only (the embedding
on the first, the head on the last); the step sums their gradients over ``pp``, as
shard_map's transpose does, so that every stage's copy takes the same update.

Composition:
  * ``dp``: the rows of each micro-batch split over ``("dp", "fsdp")``
    (`specs.BATCH_SPEC`), the gradients summed over them (`train/step.sync_grads`);
  * ``tp``: inside a stage the blocks run as the port's tensor-parallel layers
    (`parallel/sharded.py`: ``ColumnLinear``/``RowLinear``, one all-reduce over ``tp``
    a sub-block). The JAX package reshapes the fused qkv weight ``(L, D, 3D) -> (L, D,
    3, D)`` (its ``relayout_qkv``) so that a ``tp`` shard of its last dim holds whole
    heads of each of q, k and v. The port shards the ``(L, D, 3D)`` layout as it is:
    `specs.shard_leaf` cuts ``c_attn`` head-aligned (this rank's heads of each of q, k
    and v, columns ``[q_r | k_r | v_r]``), which is what `models/llama._qkv` reads, so
    no layer reads the reshaped layout and the port has no ``relayout_qkv``.

One table of rules, `PP_PARAM_RULES`, serves training and serving: `specs.PARAM_RULES`
with the blocks' leading axis over ``pp``. Where ``tp`` and ``fsdp`` have one rank it
splits what the JAX package's ``PP_PARAM_RULES`` splits; with them it is the JAX
package's pp serving placement (`parallel/pp_decode.pp_auto_param_shardings`: the
blocks keep their tp/fsdp dims, and so do the embedding and the head). Under pp×tp
training the JAX package's ``PP_TP_PARAM_RULES`` instead replicates ``wte`` and
``lm_head``; the port keeps them vocab-split, as its other tensor-parallel paths do.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
from lit_llama_ja_tpu_torch.models import llama
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, StageHop, all_reduce, broadcast
from lit_llama_ja_tpu_torch.parallel.specs import PARAM_RULES, P, param_specs, shard_params, spec_of
from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss
from lit_llama_ja_tpu_torch.train.step import (
    cast_floating,
    global_grad_norm,
    local_rows,
    sync_grads,
)


def _pp_rules(rules):
    blocks = tuple((pat, P("pp", *spec[1:])) for pat, spec in rules if pat.startswith("blocks/"))
    rest = tuple((pat, spec) for pat, spec in rules if not pat.startswith("blocks/"))
    return ((r"^blocks/.*outlier_idx$", P("pp")),) + blocks + ((r"^blocks/", P("pp")),) + rest


# `specs.PARAM_RULES` with every block leaf's leading (layer) axis over "pp"; first match
# wins, as there (see the module docstring).
PP_PARAM_RULES = _pp_rules(PARAM_RULES)
# one table: its tp dims are those of PARAM_RULES, and they split nothing where tp = 1
PP_TP_PARAM_RULES = PP_PARAM_RULES


def pp_param_specs(params: Any, tp: bool = False) -> Any:
    """The spec of every leaf under `PP_PARAM_RULES` (``tp`` is the JAX signature's: one
    table serves both)."""
    del tp
    return param_specs(params, PP_PARAM_RULES)


def pp_spec_of(path: str):
    return spec_of(path, PP_PARAM_RULES)


def shard_params_pp(params: Any, mesh: Mesh, tp: bool = False, device=None) -> Any:
    """This rank's slice of a full tree on a pipeline mesh: its stage's layers and, on a
    mesh with ``tp`` or ``fsdp``, its shards of them (c_attn head-aligned)."""
    del tp
    return shard_params(params, mesh, PP_PARAM_RULES, device)


def check_pipeline(config: LLaMAConfig, mesh: Mesh, axis: str = "pp") -> int:
    """The stage count; raises where the layers do not split over it."""
    S = mesh.shape.get(axis, 1)
    if config.n_layer % S:
        raise ValueError(f"n_layer={config.n_layer} does not split over {axis}={S}")
    return S


def _stage_body(blocks, config: LLaMAConfig, mesh: Mesh, rope, remat: bool) -> Callable:
    """This stage's layers as one function of the activations (`models/llama`'s block
    on `layer_params` views, tensor-parallel where the mesh has ``tp``)."""
    n_local = blocks["rms_1"]["scale"].shape[0]
    bconfig = llama.block_config(config, mesh)

    def block(x, l):
        return llama.transformer_block(llama.layer_params(blocks, l, mesh), x, rope,
                                       bconfig)[0]

    def run(x):
        for l in range(n_local):
            x = checkpoint(block, x, l, use_reentrant=False) if remat else block(x, l)
        return x

    return run


def run_schedule(params, idx: torch.Tensor, config: LLaMAConfig, mesh: Mesh, *,
                 axis: str = "pp", remat: bool = False, device="cuda"):
    """The GPipe forward of this rank's stage over ``idx`` ``(M, mb, T)`` (this rank's
    rows). Returns ``(outs, root)``: on the last stage the M output activations ``(mb,
    T, D)`` (before ``ln_f``), elsewhere an empty list; ``root`` is the last hop's
    output on the other stages (seed it with zeros to run their backward), None on the
    last."""
    dev = resolve_device(device)
    S, s = check_pipeline(config, mesh, axis), mesh.index(axis)
    M, mb, T = idx.shape
    rope = llama._rope_for_positions(config, None, T, dev)
    stage = _stage_body(params["blocks"], config, mesh, rope, remat)
    # the embedding runs on the first stage only; the others receive its activations
    emb = llama.embed(params, idx, mesh) if s == 0 else None
    template = torch.zeros((mb, T, config.n_embd), dtype=params["wte"]["weight"].dtype,
                           device=dev)
    dummy = template.new_zeros((), requires_grad=torch.is_grad_enabled())
    x, outs, root = None, [], None
    for t in range(M + S - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            y = stage(x if x is not None else emb[m])
            if s == S - 1:
                outs.append(y)
        more = 0 <= m + 1 < M  # this stage runs a micro-batch at the next tick
        send, recv = y is not None and s < S - 1, s > 0 and more
        x = None
        if send or recv:
            # the first stage's hop passes the next micro-batch's embedding through
            fallback = emb[m + 1] if s == 0 and more else template
            out = StageHop.apply(y if y is not None else dummy, fallback, mesh, axis, send,
                                 recv)
            if more:
                x = out
            else:
                root = out
    return outs, root


def _head(params, y, config: LLaMAConfig, mesh: Mesh):
    return llama.lm_head(params, rmsnorm(y, params["ln_f"]["scale"], config.norm_eps), mesh)


def pipeline_forward(params, idx, config: LLaMAConfig, mesh: Mesh, axis: str = "pp",
                     remat: bool = False, tp_axis: Optional[str] = None,
                     device="cuda") -> torch.Tensor:
    """GPipe forward: ``idx`` ``(M, mb, T)`` token ids (M micro-batches, the whole batch)
    -> logits ``(M, mb_local, T, V)`` on every stage, ``mb_local`` this rank's rows of
    each micro-batch over ``("dp", "fsdp")``. ``params`` is this rank's
    `shard_params_pp` slice. The math of `models/llama.forward` on each micro-batch.
    ``tp_axis`` is the JAX signature's: the port runs a stage tensor-parallel whenever
    the mesh has ``tp`` (the head-aligned shards need no relayout). No gradient flows
    back through the logits sent to the other stages; train with `make_pp_train_step`."""
    if tp_axis not in (None, "tp"):
        raise ValueError(f"tensor parallelism runs over the mesh's 'tp' axis, not {tp_axis!r}")
    dev = resolve_device(device)
    idx = local_rows(torch.as_tensor(idx, device=dev).long(), mesh)
    S, s = check_pipeline(config, mesh, axis), mesh.index(axis)
    outs, _ = run_schedule(params, idx, config, mesh, axis=axis, remat=remat, device=dev)
    M, mb, T = idx.shape
    dtype = params["wte"]["weight"].dtype  # the activations', which every stage allocates
    if s == S - 1:
        logits = torch.stack([_head(params, y, config, mesh) for y in outs]).to(dtype)
    else:
        logits = torch.empty((M, mb, T, config.padded_vocab_size), dtype=dtype, device=dev)
    return broadcast(logits.detach(), mesh, axis, S - 1)


def make_pp_train_step(config: LLaMAConfig, optimizer, mesh: Mesh, *, axis: str = "pp",
                       remat: bool = False, ignore_index: int = -1,
                       tp_axis: Optional[str] = None,
                       compute_dtype: Optional[torch.dtype] = None, device="cuda"):
    """The pipeline-parallel train step. ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` with ``batch`` ``(M, mb, T+1)`` (the whole batch; as
    `train/step.make_train_step`, slots 0..T-1 inputs and 1..T targets): the M
    micro-batches are both the pipeline's work and the gradient accumulation, one
    optimizer update a step, the loss the mean of the micro-batches' losses (the same
    value on every rank). ``params`` and ``opt_state`` are this rank's `shard_params_pp`
    slices, updated in place. ``.jit_with(params)`` returns the step (the JAX
    signature)."""
    if tp_axis not in (None, "tp"):
        raise ValueError(f"tensor parallelism runs over the mesh's 'tp' axis, not {tp_axis!r}")
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        batch = local_rows(torch.as_tensor(batch, device=dev).long(), mesh)
        S, s = check_pipeline(config, mesh, axis), mesh.index(axis)
        M = batch.shape[0]
        leaves = flatten_tree(params)
        try:
            for t in leaves.values():
                t.requires_grad_(True)
            outs, root = run_schedule(cast_floating(params, compute_dtype), batch[..., :-1],
                                      config, mesh, axis=axis, remat=remat, device=dev)
            if s == S - 1:
                p = cast_floating(params, compute_dtype)
                loss = sum(cross_entropy_loss(_head(p, y, config, mesh), batch[m, :, 1:],
                                              ignore_index) for m, y in enumerate(outs)) / M
                # every hop's backward must run to match its neighbour's, so the whole
                # graph runs: no ``inputs=``, which would prune the hops that reach no leaf
                loss.backward()
                loss = loss.detach()
            else:
                root.backward(torch.zeros_like(root))
                loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {k: t.grad if t.grad is not None else torch.zeros_like(t)
                     for k, t in leaves.items()}
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
                t.grad = None
        grads = sync_grads(grads, mesh, pp_spec_of, sum_axes=(axis,))
        norm = (global_grad_norm(grads, mesh, pp_spec_of)
                if optimizer.grad_clip is not None else None)
        optimizer.apply(leaves, grads, opt_state, norm)
        loss = broadcast(loss, mesh, axis, S - 1)
        return params, opt_state, all_reduce(loss, mesh, ("dp", "fsdp")) / mesh.size(
            ("dp", "fsdp"))

    train_step.jit_with = lambda params: train_step
    return train_step

