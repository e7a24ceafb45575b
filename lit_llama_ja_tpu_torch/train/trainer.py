"""Reusable training loop (counterpart of `lit_llama_ja_tpu/train/trainer.py`).

The caller provides the train step, a batch iterator, and callbacks for validation
and checkpointing. Metrics (iter, loss, lr, tokens/s) print in the reference's
format and append to a JSONL metrics file with the JAX package's keys.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import Bound, TrainGraphs
from lit_llama_ja_tpu_torch.models import llama
from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss
from lit_llama_ja_tpu_torch.train.step import cast_floating


@dataclass
class TrainLoopConfig:
    max_iters: int = 1000
    log_interval: int = 10
    eval_interval: int = 200
    save_interval: int = 200
    eval_iters: int = 20
    grad_accum_steps: int = 1
    micro_batch_size: int = 4
    block_size: int = 2048
    out_dir: Optional[str] = None
    metrics_file: Optional[str] = None


def _append_jsonl(path: Optional[Path], record: dict) -> None:
    if path:
        with path.open("a") as f:
            f.write(json.dumps(record) + "\n")


def train_loop(
    step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, loss)
    params,
    opt_state,
    batches: Iterator[np.ndarray],  # yields (micro_bs, T+1) int arrays
    cfg: TrainLoopConfig,
    *,
    lr_schedule: Optional[Callable] = None,
    validate_fn: Optional[Callable] = None,  # (params) -> float
    save_fn: Optional[Callable] = None,  # (params, iter_num) -> None
    save_state_fn: Optional[Callable] = None,  # (params, opt_state, iter) -> None
    restart_iter: int = 0,
):
    """Run the loop; returns (params, opt_state).

    ``batches`` yields micro-batches; ``grad_accum_steps`` of them are stacked into
    one batch per optimizer step. ``restart_iter`` offsets the counter on resume.
    ``save_state_fn`` checkpoints the full training state (optimizer moments
    included) each save interval.

    A non-finite loss aborts immediately: the optimizer update for that step has
    already been applied, so the parameters can no longer be trusted — resume from
    the last checkpoint instead of training forward on poison.

    The loop reads one value back a step, the loss (``float(loss)``, as the JAX loop
    does); with a captured ``step_fn`` (`train/step.TrainStep` on the card) a step is
    the staging of its batch and one graph replay before that read.
    """
    metrics_path = Path(cfg.metrics_file) if cfg.metrics_file else None
    step_count = 0
    tokens = 0
    step_time = 0.0
    prev_t = time.time()

    it = iter(batches)
    for iter_num in range(restart_iter, cfg.max_iters):
        try:
            micro = [np.asarray(next(it)) for _ in range(cfg.grad_accum_steps)]
        except StopIteration:
            break
        batch = np.stack(micro)  # (accum, micro_bs, T+1)
        t0 = time.time()
        params, opt_state, loss = step_fn(params, opt_state, batch)
        loss = float(loss)  # waits for the step
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss ({loss}) at iter {iter_num}; parameters are "
                "already updated with it — resume from the last checkpoint"
            )
        step_count += 1
        t1 = time.time()

        tokens += batch.shape[0] * batch.shape[1] * (batch.shape[2] - 1)
        step_time += t1 - prev_t
        prev_t = t1

        if iter_num % cfg.log_interval == 0:
            lr = float(lr_schedule(iter_num)) if lr_schedule else None
            toks_sec = tokens / step_time if step_time > 0 else 0.0
            print(
                f"iter {iter_num}: loss {loss:.4f}, time: {(t1 - t0) * 1000:.2f}ms, "
                f"speed: {toks_sec:.0f} toks/s/device"
            )
            _append_jsonl(metrics_path, {"iter": iter_num, "train_loss": loss,
                                         "step": step_count, "lr": lr,
                                         "tokens_per_sec": toks_sec})
            tokens = 0
            step_time = 0.0

        if validate_fn is not None and step_count % cfg.eval_interval == 0:
            val_loss = validate_fn(params)
            print("-" * 80)
            print(f"step {iter_num}: val loss {val_loss:.4f}")
            print("-" * 80)
            _append_jsonl(metrics_path, {"iter": iter_num, "val_loss": float(val_loss),
                                         "step": step_count})

        if step_count % cfg.save_interval == 0:
            if save_fn is not None:
                print(f"Saving checkpoint at iter {iter_num}")
                save_fn(params, iter_num)
            if save_state_fn is not None:
                save_state_fn(params, opt_state, iter_num)

    return params, opt_state


def make_val_loss(loss_of: Callable, device, *, cuda_graph: bool = True, mesh=None,
                  pool=None) -> Callable:
    """``val_loss(params, **batch) -> loss``, a 0-d f32 tensor on the device, unread:
    ``loss_of(params, **batch)`` on the batch's arrays (numpy, staged as int64) without
    gradients, as the JAX package jits its validation losses. On a CUDA device without
    a mesh it is one CUDA graph a batch shape (`infer/decode_graph.TrainGraphs`, kind
    "val", in ``pool``: a train step's, whose graphs never run at the same time); on
    the CPU the same body runs eagerly through the same staging; ``cuda_graph=False``
    or a mesh calls it on the arrays moved to the device. The loss is the graph's
    buffer, rewritten by the next call: read it first."""
    dev = resolve_device(device)

    @torch.no_grad()
    def body(trees, *, out: torch.Tensor, **batch: torch.Tensor) -> None:
        out.copy_(loss_of(trees.trees[0], **batch))

    graphs = None
    if cuda_graph and mesh is None:
        graphs = TrainGraphs(dev, body, (), capture=dev.type == "cuda", kind="val",
                             pool=pool)

    def val_loss(params, **batch) -> torch.Tensor:
        host = {k: np.asarray(v, dtype=np.int64) for k, v in batch.items()}
        if graphs is not None:
            return graphs.run(Bound(params), **host)
        out = torch.zeros((), dtype=torch.float32, device=dev)
        body(Bound(params), out=out, **{k: torch.as_tensor(v, device=dev)
                                        for k, v in host.items()})
        return out

    val_loss.graphs = graphs
    return val_loss


def make_validate_fn(config, eval_iters: int, val_batches_fn: Callable, forward_fn=None,
                     device="cuda", compute_dtype: Optional[torch.dtype] = None, *,
                     cuda_graph: bool = True, mesh=None, pool=None):
    """Mean loss over ``eval_iters`` validation batches (reference
    `pretrain/redpajama.py:290-309`), without gradients. ``forward_fn(params, inputs)``
    replaces `models/llama.forward`; ``compute_dtype`` casts the floating params as the
    train step does. Each batch's loss is one replay of a captured graph on the card
    (`make_val_loss`; ``cuda_graph``, ``mesh`` and ``pool`` as there) and one read, as
    the JAX loop reads its jitted ``val_loss``."""
    dev = resolve_device(device)
    fwd = forward_fn or (lambda p, x: llama.forward(p, x, config, device=dev))

    def loss_of(params, batch):
        logits = fwd(cast_floating(params, compute_dtype), batch[:, :-1])
        return cross_entropy_loss(logits, batch[:, 1:])

    val_loss = make_val_loss(loss_of, dev, cuda_graph=cuda_graph, mesh=mesh, pool=pool)

    def validate(params) -> float:
        losses = []
        it = iter(val_batches_fn())
        for _ in range(eval_iters):
            try:
                batch = np.asarray(next(it))
            except StopIteration:
                break
            losses.append(float(val_loss(params, batch=batch)))
        return float(np.mean(losses)) if losses else float("nan")

    validate.val_loss = val_loss
    return validate
