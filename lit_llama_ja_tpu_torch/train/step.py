"""Train step and optimizer (counterpart of `lit_llama_ja_tpu/train/step.py`).

One call does forward, backward, gradient accumulation over the micro-batch axis and
the optimizer update, on one device:

  * **Gradient accumulation** — a Python loop over the micro-batches in place of the
    JAX package's ``lax.scan``; gradients are summed, then divided by the number of
    micro-batches, and so is the loss.
  * **PEFT** — an optional trainable predicate over leaf paths (``"blocks/attn/
    c_attn/weight"``) selects the leaves that get gradients and optimizer state; the
    others are constants of the graph and stay bit-identical.
  * **Mixed precision** — ``compute_dtype`` casts the floating leaves inside the loss;
    autograd carries the gradients back to the f32 master leaves.

Unlike the JAX step, which returns new arrays, the port updates the parameter and
optimizer-state tensors IN PLACE (the counterpart of donating them to ``jit``) and
returns the same dicts. ``make_sft_train_step`` is the instruction-tuning step of the
finetune CLIs (full, LoRA, Adapter v1 and v2).

On a mesh (``mesh=``, the counterpart of ``jit_train_step``'s shardings): every rank
holds its `parallel/specs.shard_params` slice of the parameters and of the AdamW
moments, takes its rows of each micro-batch (`specs.BATCH_SPEC`: the batch over
``(dp, fsdp)``) and runs the sharded forward (`parallel/sharded.py`). The gradients
come out of the backward reduce-scattered over ``fsdp`` for the leaves it shards
(the gather's backward) and are all-reduced over the data axes that do not shard
them, then divided by their size, so that the step sees the gradient of the mean
loss over the global batch. The global-norm clip takes the norm over all shards,
counting an element that ``tp`` or ``dp`` replicates once (`global_grad_norm`).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import Bound, TrainGraphs
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree, unflatten_tree
from lit_llama_ja_tpu_torch.models import llama
from lit_llama_ja_tpu_torch.models.lora import draw_seeds
from lit_llama_ja_tpu_torch.parallel.mesh import all_reduce
from lit_llama_ja_tpu_torch.parallel.specs import replication, spec_axes, spec_of
from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss, token_nll_sum


def _map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def cast_floating(params, dtype: Optional[torch.dtype]):
    """``params`` with every floating leaf cast to ``dtype`` (a differentiable cast),
    except an MoE router, which routes in f32 whatever the compute dtype
    (`models/moe.py`); unchanged when ``dtype`` is None."""
    if dtype is None:
        return params
    return _map_with_path(
        lambda path, a: a.to(dtype) if a.is_floating_point() and not path.endswith(
            "router/weight") else a, params)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """optax's ``clip_by_global_norm``: every gradient times ``max_norm / norm`` when
    the global norm is at least ``max_norm``, unchanged below it (not
    ``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``). ``norm``: the global norm
    when the gradients are shards (`global_grad_norm`); else it is theirs."""
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads.values()))
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=weight_decay))`` as the JAX package builds it, on tensors:

      * `clip_by_global_norm` first, when ``grad_clip`` is set;
      * Adam moments with bias correction by ``1 - b ** (n + 1)``;
      * decoupled weight decay on every leaf (no mask: norm scales and the embedding
        decay too), added to the Adam direction before the learning rate;
      * update ``n`` (from 0) uses ``schedule(n)``, as optax counts.

    State: ``{"count": int64 scalar, "mu": tree, "nu": tree}`` with the trees holding
    the trainable leaves only. The count lives on the leaves' device and is advanced
    in place; the learning rate and the bias corrections are f32 scalars derived from
    it there (``schedule`` is called on the count tensor, `train/lr.py`), as optax
    derives them in f32, so that an update reads nothing back to the host.
    """

    EPS = 1e-8  # optax's adamw default

    def __init__(self, schedule, weight_decay: float = 0.1, beta1: float = 0.9,
                 beta2: float = 0.95, grad_clip: Optional[float] = 1.0):
        self.schedule = schedule if callable(schedule) else (lambda _: schedule)
        self.weight_decay, self.beta1, self.beta2 = weight_decay, beta1, beta2
        self.grad_clip = grad_clip

    def init(self, params) -> Dict[str, Any]:
        flat = flatten_tree(params)
        dev = next(iter(flat.values())).device if flat else torch.device("cpu")
        return {
            "count": torch.zeros((), dtype=torch.int64, device=dev),
            "mu": unflatten_tree({k: torch.zeros_like(t) for k, t in flat.items()}),
            "nu": unflatten_tree({k: torch.zeros_like(t) for k, t in flat.items()}),
        }

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """``schedule(count)`` as an f32 scalar on the count's device (a schedule that
        returns a number gives a constant)."""
        lr = self.schedule(count)
        if isinstance(lr, torch.Tensor):
            return lr.to(torch.float32)
        return torch.full((), lr, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def apply(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Any], norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Update ``leaves`` (path -> tensor) and ``state`` in place from ``grads``;
        ``norm`` is the global gradient norm of sharded ``grads``. Returns the learning
        rate of this update (an f32 scalar on the device)."""
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip, norm)
        count = state["count"]
        lr = self.learning_rate(count)
        n = (count + 1).to(torch.float32)
        bc1 = 1.0 - torch.pow(self.beta1, n)
        bc2 = 1.0 - torch.pow(self.beta2, n)
        mu, nu = flatten_tree(state["mu"]), flatten_tree(state["nu"])
        for path, p in leaves.items():
            g = grads[path]
            mu[path].mul_(self.beta1).add_(g, alpha=1.0 - self.beta1)
            nu[path].mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            update = (mu[path] / bc1) / (torch.sqrt(nu[path] / bc2) + self.EPS)
            update.add_(p, alpha=self.weight_decay)
            p.sub_(update.mul_(lr))
        count.add_(1)
        return lr


# The JAX package's name; the defaults are the reference's hyperparameters
# (`pretrain/redpajama.py:57-71`): b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1,
# global-norm clip 1.0.
make_adamw = AdamW


def partition_trainable(params, trainable_pred: Callable[[str], bool]):
    """Split a param tree into (trainable, frozen) trees of the same structure, with
    the leaves not selected set to None."""
    trainable = _map_with_path(lambda path, p: p if trainable_pred(path) else None, params)
    frozen = _map_with_path(lambda path, p: None if trainable_pred(path) else p, params)
    return trainable, frozen


def merge_trees(a, b):
    """Merge two same-structure trees where exactly one of (a, b) is None per leaf."""
    if isinstance(a, dict):
        return {k: merge_trees(a[k], b[k]) for k in a}
    return a if a is not None else b


def global_grad_norm(grads: Dict[str, torch.Tensor], mesh, spec_fn) -> torch.Tensor:
    """The norm of the whole gradient from every rank's shards: each rank's squares
    divided by the number of ranks that hold the same elements (``spec_fn(path)`` is
    the leaf's spec), summed over the mesh."""
    sq = sum(torch.sum(g.float() * g.float()) / replication(spec_fn(path), mesh)
             for path, g in grads.items())
    return torch.sqrt(all_reduce(sq, mesh, mesh.axis_names))


def sync_grads(grads: Dict[str, torch.Tensor], mesh, spec_fn,
               data_axes=("dp", "fsdp"), sum_axes=()) -> Dict[str, torch.Tensor]:
    """Each rank's gradient of its own loss -> the gradient of the mean loss over the
    ranks of ``data_axes``: summed over the data axes that the leaf's spec does not
    shard (those it shards were summed by the gather's backward), then divided by
    their size. A leaf is also summed over the ``sum_axes`` its spec does not shard (a
    pipeline's ``pp``: a leaf used on one stage alone)."""
    out = {}
    for path, g in grads.items():
        split = spec_axes(spec_fn(path))
        missing = [a for a in data_axes if a not in split]
        if missing:
            g = all_reduce(g, mesh, missing)
        for a in sum_axes:
            if a not in split:
                g = all_reduce(g, mesh, a)
        out[path] = g / mesh.size(data_axes)
    return out


def _accumulate_and_update(params, opt_state, optimizer: AdamW, trainable_pred, micro_losses,
                           mesh=None):
    """One optimizer step: the gradients of every loss that ``micro_losses`` yields
    (one a micro-batch, as a thunk) with respect to the trainable leaves, summed,
    divided by their count, and applied in place. Returns the mean loss and the
    learning rate of the update. On a mesh the gradients and the loss are this rank's
    (see the module docstring). Every leaf leaves with the ``requires_grad`` it came
    with."""
    work = params if trainable_pred is None else partition_trainable(params, trainable_pred)[0]
    leaves = flatten_tree(work)
    grads, loss_sum, n = None, None, 0
    tracked = [t.requires_grad for t in leaves.values()]
    try:
        for t in leaves.values():
            t.requires_grad_(True)
        for loss_fn in micro_losses:
            loss = loss_fn()
            g = torch.autograd.grad(loss, list(leaves.values()))
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            n += 1
    finally:
        for t, was in zip(leaves.values(), tracked):
            t.requires_grad_(was)
    grads = {k: g / n for k, g in zip(leaves, grads)}
    loss = loss_sum / n
    if mesh is None:
        return loss, optimizer.apply(leaves, grads, opt_state)
    grads = sync_grads(grads, mesh, spec_of)
    norm = global_grad_norm(grads, mesh, spec_of) if optimizer.grad_clip is not None else None
    lr = optimizer.apply(leaves, grads, opt_state, norm)
    return all_reduce(loss, mesh, ("dp", "fsdp")) / mesh.size(("dp", "fsdp")), lr


def _step_body(optimizer: AdamW, trainable_pred, micro_loss: Callable, mesh):
    """The body of a train step: ``body(trees, *, out, **batch)`` runs the step over
    ``trees`` (a `Bound` of the params and the optimizer state, updated in place) and
    the device tensors of ``batch`` (their leading axis the micro-batches;
    ``micro_loss(params, a, batch)`` is micro-batch ``a``'s loss) and writes the mean
    loss and the learning rate into ``out`` (f32 ``(2,)``). It reads nothing back to
    the host, so that a CUDA graph can hold it (`infer/decode_graph.TrainGraphs`).
    It closes over no step object, so that no reference cycle keeps a graph alive."""

    def body(trees, *, out: torch.Tensor, **batch: torch.Tensor) -> None:
        params, opt_state = trees.trees
        n = next(iter(batch.values())).shape[0]
        loss, lr = _accumulate_and_update(
            params, opt_state, optimizer, trainable_pred,
            (functools.partial(micro_loss, params, a, batch) for a in range(n)), mesh)
        out[0].copy_(loss)
        out[1].copy_(lr)

    return body


def _as_ids(x):
    """Token ids or labels as int64: a tensor stays where it is, anything else becomes
    a numpy array (staged from the host)."""
    return x.long() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.int64)


class TrainStep:
    """A train step, ``step(params, opt_state, batch, ...) -> (params, opt_state,
    loss)``, run as one device program where it can be: the counterpart of the JAX
    package's ``jit_train_step``.

    * **Captured** (a CUDA device, no mesh, ``cuda_graph``): the batch is staged into
      static device buffers from pinned host memory, and the step's body
      (`_step_body`) is captured in a CUDA graph at the first step of a batch shape,
      after one eager warm-up step (`infer/decode_graph.TrainGraphs`, kind "train");
      every later step is one replay. The graph holds its activations and gradients
      in its pool between steps.
    * **Body in a host loop** (the CPU): the same staging and the same body, called
      eagerly, as the decode bodies run on the CPU.
    * **Eager** (``cuda_graph=False``, or a mesh, whose gloo collectives stage through
      the host): the body called on the batch moved to the device (this rank's rows
      on a mesh), with no buffers and no graph.

    The loss returned is a copy (the step's buffer is rewritten by the next step);
    `last_lr` is the learning rate of the last update. ``pool``: the graphs' memory
    pool (None without capture), for a validation that shares it.
    """

    def __init__(self, body: Callable, device, *, cuda_graph: bool, mesh,
                 stage: Callable):
        self.device = device
        self.body = body
        self.mesh = mesh
        self.stage = stage
        self.graphs: Optional[TrainGraphs] = None
        if cuda_graph and mesh is None:
            self.graphs = TrainGraphs(device, body, (2,), capture=device.type == "cuda",
                                      kind="train")
        self.last: Optional[torch.Tensor] = None

    @property
    def pool(self):
        return None if self.graphs is None else self.graphs.pool

    @property
    def last_lr(self) -> Optional[torch.Tensor]:
        return None if self.last is None else self.last[1].clone()

    def __call__(self, params, opt_state, batch, generator: Optional[torch.Generator] = None):
        host = self.stage(batch, generator)
        trees = Bound(params, opt_state)
        if self.graphs is not None:
            out = self.graphs.run(trees, **host)
        else:
            out = torch.zeros((2,), dtype=torch.float32, device=self.device)
            # a rank takes its rows of the batch; the seeds are every rank's
            dev_batch = {k: torch.as_tensor(v, device=self.device) for k, v in host.items()}
            dev_batch.update({k: local_rows(v, self.mesh) for k, v in dev_batch.items()
                              if k != "seeds"})
            self.body(trees, out=out, **dev_batch)
        self.last = out
        return params, opt_state, out[0].clone()


def make_train_step(
    config: LLaMAConfig,
    optimizer: AdamW,
    *,
    forward_fn: Optional[Callable] = None,
    trainable_pred: Optional[Callable[[str], bool]] = None,
    ignore_index: int = -1,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    device="cuda",
    mesh=None,
    cuda_graph: bool = True,
) -> TrainStep:
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``batch`` is ``(accum_steps, micro_bs, T+1)`` int token ids (numpy or torch):
    slots 0..T-1 are inputs, 1..T targets. ``params`` and ``opt_state`` are updated
    in place and returned; ``loss`` is a 0-d f32 tensor on the device.
    ``forward_fn(params, inputs)`` replaces `models/llama.forward`; it may return
    ``(logits, penalty)``, whose penalty is added to the loss.

    On CUDA the attention kernels take bf16 only, so f32 params need
    ``compute_dtype=torch.bfloat16``; without it the first forward raises.

    The step is one CUDA graph on a CUDA device without a mesh (`TrainStep`);
    ``cuda_graph=False`` keeps it eager, for comparison.

    ``mesh``: ``params`` and ``opt_state`` are this rank's shards, ``batch`` is the
    global batch, of which the rank takes its rows; ``forward_fn`` must then run on the
    mesh too. The loss returned is the global batch's mean on every rank. A step on a
    mesh runs eagerly.
    """
    dev = resolve_device(device)
    fwd = forward_fn or (lambda p, x: llama.forward(p, x, config, device=dev, remat=remat,
                                                    mesh=mesh))

    def micro_loss(params, a, batch):
        micro = batch["batch"][a]
        out = fwd(cast_floating(params, compute_dtype), micro[:, :-1])
        logits, penalty = out if isinstance(out, tuple) else (out, None)
        loss = cross_entropy_loss(logits, micro[:, 1:], ignore_index)
        return loss + penalty if penalty is not None else loss

    return TrainStep(_step_body(optimizer, trainable_pred, micro_loss, mesh), dev,
                     cuda_graph=cuda_graph, mesh=mesh,
                     stage=lambda batch, _: {"batch": _as_ids(batch)})


def local_rows(batch: torch.Tensor, mesh, dim: int = 1,
               axes=("dp", "fsdp")) -> torch.Tensor:
    """This rank's rows of a global batch along ``dim``, split over ``axes``
    (`specs.BATCH_SPEC`: a ``(A, micro_bs, ...)`` batch over dp x fsdp on dim 1); the
    whole batch without a mesh."""
    if mesh is None:
        return batch
    n, i = mesh.size(axes), mesh.index(axes)
    if batch.shape[dim] % n:
        raise ValueError(f"a batch of {batch.shape[dim]} rows does not split over "
                         f"{' x '.join(axes)} = {n} ranks")
    rows = batch.shape[dim] // n
    return batch.narrow(dim, i * rows, rows)


def make_sft_train_step(
    config: LLaMAConfig,
    optimizer: AdamW,
    *,
    forward_fn: Optional[Callable] = None,
    trainable_pred: Optional[Callable[[str], bool]] = None,
    lora_dropout: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    device="cuda",
    mesh=None,
    cuda_graph: bool = True,
) -> TrainStep:
    """Instruction-tuning step (reference `finetune/lora.py:180-184`). Returns
    ``train_step(params, opt_state, batch, generator=None) -> (params, opt_state,
    loss)`` with ``batch = {"input_ids": (A, B, T), "labels": (A, B, T)}``: the loss
    predicts ``labels[:, 1:]`` from ``logits[:, :-1]``, labels of -1 ignored.

    Without ``forward_fn`` the model is `models/llama.forward`, with ``lora_dropout``
    on the LoRA branch's input: each step draws ``(A, n_layer)`` seeds from
    ``generator`` on its device (`models/lora.draw_seeds`; no dropout without one), one
    a micro-batch and layer, staged with the batch, and each mask is a function of its
    seed (`models/lora.dropout_keep`), so a captured step draws new masks at every
    replay. ``forward_fn(params, inputs)`` (the adapter forward) takes no dropout, as
    in the JAX package. ``compute_dtype``, ``device`` and ``cuda_graph`` are
    `make_train_step`'s.

    ``mesh``: as `make_train_step`'s (``forward_fn`` must run on the mesh too). A
    micro-batch's loss is its mean over the labels of the whole micro-batch: each rank
    sums over its rows and divides by the count of every rank's labels, so that the
    ranks' rows weigh as they do on one device. The LoRA dropout masks are drawn for
    the whole micro-batch and cut to the rank's rows (`models/lora.lora_branch`).
    """
    dev = resolve_device(device)
    dropout = forward_fn is None and lora_dropout > 0.0

    def micro_loss(params, a, batch):
        p = cast_floating(params, compute_dtype)
        ids, labels = batch["input_ids"][a], batch["labels"][a]
        if forward_fn is not None:
            logits = forward_fn(p, ids)
        else:
            seeds = batch["seeds"][a] if "seeds" in batch else None
            logits = llama.forward(p, ids, config, device=dev, dropout_seeds=seeds,
                                   dropout_rate=lora_dropout, mesh=mesh)
        return sft_loss(logits, labels, mesh)

    def stage(batch, generator):
        host = {"input_ids": _as_ids(batch["input_ids"]), "labels": _as_ids(batch["labels"])}
        if dropout and generator is not None:
            host["seeds"] = draw_seeds(generator, (host["input_ids"].shape[0], config.n_layer))
        return host

    return TrainStep(_step_body(optimizer, trainable_pred, micro_loss, mesh), dev,
                     cuda_graph=cuda_graph, mesh=mesh, stage=stage)


def sft_loss(logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """The SFT cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]``. On a mesh
    the rows are this rank's: its NLL sum over the count of every rank's labels, times
    the number of data ranks, so that the ranks' mean (`sync_grads`, and the loss
    `_accumulate_and_update` returns) is the whole batch's mean."""
    if mesh is None:
        return cross_entropy_loss(logits[:, :-1], labels[:, 1:])
    nll, count = token_nll_sum(logits[:, :-1], labels[:, 1:])
    count = all_reduce(count.float(), mesh, ("dp", "fsdp"))
    return nll * mesh.size(("dp", "fsdp")) / torch.clamp(count, min=1)


def init_opt_state(optimizer: AdamW, params, trainable_pred=None):
    if trainable_pred is not None:
        params = partition_trainable(params, trainable_pred)[0]
    return optimizer.init(params)

