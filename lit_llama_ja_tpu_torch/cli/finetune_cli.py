"""Finetuning CLIs: full, LoRA, Adapter v1 and Adapter v2 (counterpart of
`lit_llama_ja_tpu/cli/finetune_cli.py`; reference `finetune/{full,lora,adapter,adapter_v2}.py`).

    python -m lit_llama_ja_tpu_torch.cli.finetune_cli --data-dir data/alpaca \\
        --pretrained-path <checkpoint dir or .pth> --out-dir out/lora/alpaca

(`main_lora` is the command-line entry; the others are called from Python.) All four
share `_finetune_driver`; they differ in which leaves train, which forward runs, and what a
save holds: ``iter-XXXXXX.npz`` with the PEFT state (the JAX package's keys, so either
package reads it), or a checkpoint directory ``iter-XXXXXX`` for full finetuning. The
hyperparameter defaults are the reference scripts'. On the card the step computes in
bf16 over f32 master leaves (the attention kernels take bf16 only); the frozen leaves
of a PEFT run are never written. On one card the step and the validation loss are
each one captured CUDA graph (`train/step.TrainStep`, `train/trainer.make_val_loss`),
as the JAX CLI jits them: a step stages its batch and its dropout seeds, replays, and
the loop reads the loss back.

``dp``/``fsdp``/``tp``: under a process group (``torchrun``) the ranks form a ``(dp,
fsdp, tp)`` mesh, as the JAX CLI does (the reference's FSDP and ZeRO-2 finetuning,
`finetune/full.py:57-58`, `finetune/adapter.py:55-59`). Each rank loads its slices of
the base (`cli/generate_cli.load_model_any`) and adds the PEFT leaves whole, from the
same seed; ``micro_batch_size`` splits over ``dp·fsdp`` and ``grad_accum`` counts
whole micro-batches, as in the JAX CLI. Rank 0 prints and writes a PEFT save from its
replicated leaves; a full save is gathered (`io/checkpoint.save_checkpoint`). Without a
process group the mesh arguments must describe one rank.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device


def _finetune_driver(
    *,
    data_dir: str,
    pretrained_path: str,
    out_dir: str,
    variant: str,  # "full" | "lora" | "adapter" | "adapter_v2"
    learning_rate: float,
    weight_decay: float,
    micro_batch_size: int,
    batch_size: int,
    max_iters: int,
    warmup_iters: int,
    max_seq_length: int = 256,
    eval_interval: int = 100,
    save_interval: int = 100,
    eval_iters: int = 100,
    log_interval: int = 10,
    lora_r: int = 8,
    lora_alpha: int = 16,
    lora_dropout: float = 0.05,
    seed: int = 1337,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    device: str = "cuda",
):
    from lit_llama_ja_tpu_torch.cli.generate_cli import compute_dtype, load_model_any
    from lit_llama_ja_tpu_torch.data.sft import load_sft_dataset, sft_batches
    from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint, save_state_npz
    from lit_llama_ja_tpu_torch.models import adapter as adapter_mod
    from lit_llama_ja_tpu_torch.models import llama
    from lit_llama_ja_tpu_torch.models import lora as lora_mod
    from lit_llama_ja_tpu_torch.parallel.mesh import (
        all_reduce,
        barrier,
        make_mesh,
        maybe_init_distributed,
    )
    from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
    from lit_llama_ja_tpu_torch.train.step import (
        cast_floating,
        init_opt_state,
        local_rows,
        make_adamw,
        make_sft_train_step,
        sft_loss,
    )
    from lit_llama_ja_tpu_torch.train.trainer import make_val_loss

    dev = resolve_device(device)
    dtype = compute_dtype(dev)
    maybe_init_distributed()
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp)
    if not torch.distributed.is_initialized():
        mesh = None  # one rank and no group: the one-device path
    rank0 = mesh is None or mesh.rank == 0
    log = print if rank0 else (lambda *a, **k: None)
    if mesh is not None:
        log(f"mesh: {mesh.shape}, backend {mesh.backend}")
        data_ways = mesh.size(("dp", "fsdp"))
        if micro_batch_size % data_ways:
            raise ValueError(f"micro_batch_size={micro_batch_size} must divide over "
                             f"dp*fsdp={data_ways}")
    params, config = load_model_any(Path(pretrained_path), device=dev, mesh=mesh)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    trainable_pred: Optional[Callable] = None
    forward_fn = None
    extract_state = None
    dropout = 0.0
    init_gen = torch.Generator(device=dev).manual_seed(seed)

    if variant == "lora":
        lparams = lora_mod.init_lora_params(init_gen, config, r=lora_r, alpha=lora_alpha,
                                            device=dev)
        params = lora_mod.add_lora(params, lparams)
        trainable_pred = lora_mod.lora_trainable
        extract_state = lora_mod.extract_lora
        dropout = lora_dropout
    elif variant in ("adapter", "adapter_v2"):
        acfg = adapter_mod.AdapterConfig(
            **{f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
        )
        aparams = adapter_mod.init_adapter_params(init_gen, acfg, device=dev)
        params = adapter_mod.add_adapter(params, aparams)
        if variant == "adapter_v2":
            params = adapter_mod.add_adapter_v2(params, mesh=mesh)
            trainable_pred = adapter_mod.adapter_v2_trainable
            extract_state = adapter_mod.extract_adapter_v2_state
        else:
            trainable_pred = adapter_mod.adapter_trainable
            extract_state = adapter_mod.extract_adapter_state
        config = acfg
        forward_fn = lambda p, x: adapter_mod.adapter_forward(p, x, config, device=dev,
                                                              mesh=mesh)

    grad_accum = max(batch_size // micro_batch_size, 1)
    schedule = cosine_with_warmup(learning_rate, warmup_iters, max_iters, learning_rate / 10)
    opt = make_adamw(schedule, weight_decay=weight_decay)
    step = make_sft_train_step(
        config, opt, forward_fn=forward_fn, trainable_pred=trainable_pred,
        lora_dropout=dropout, compute_dtype=dtype, device=dev, mesh=mesh,
    )
    opt_state = init_opt_state(opt, params, trainable_pred=trainable_pred)

    train_data = load_sft_dataset(Path(data_dir) / "train.pt")
    val_data = load_sft_dataset(Path(data_dir) / "test.pt")
    batches = sft_batches(train_data, micro_batch_size, max_seq_length, seed=seed)
    eval_fwd = forward_fn or (lambda p, x: llama.forward(p, x, config, device=dev, mesh=mesh))

    def eval_loss(params, input_ids, labels):
        x, y = local_rows(input_ids, mesh, 0), local_rows(labels, mesh, 0)
        loss = sft_loss(eval_fwd(cast_floating(params, dtype), x), y, mesh)
        if mesh is not None:
            loss = all_reduce(loss, mesh, ("dp", "fsdp")) / mesh.size(("dp", "fsdp"))
        return loss

    # one captured graph on the card, in the step's pool, as the JAX CLI jits it
    val_loss = make_val_loss(eval_loss, dev, mesh=mesh, pool=getattr(step, "pool", None))

    def validate(params) -> float:
        vb = sft_batches(val_data, micro_batch_size, max_seq_length, seed=seed + 1)
        losses = [float(val_loss(params, input_ids=b["input_ids"], labels=b["labels"]))
                  for b, _ in zip(vb, range(min(eval_iters, 20)))]
        return float(np.mean(losses))

    def save(params, iter_num):
        if extract_state is None:
            save_checkpoint(out / f"iter-{iter_num:06d}", params, config,
                            **({} if mesh is None else {"mesh": mesh}))
            return
        if rank0:  # the PEFT leaves are replicated: rank 0's are the whole state
            save_state_npz(out / f"iter-{iter_num:06d}.npz", extract_state(params))
        barrier(mesh)

    dropout_gen = torch.Generator(device=dev).manual_seed(seed)
    step_count = 0
    for iter_num in range(max_iters):
        micro = [next(batches) for _ in range(grad_accum)]
        batch = {k: np.stack([m[k] for m in micro]) for k in ("input_ids", "labels")}
        t0 = time.time()
        params, opt_state, loss = step(params, opt_state, batch, dropout_gen)
        loss = float(loss)
        dt = time.time() - t0
        step_count += 1
        if iter_num % log_interval == 0:
            log(f"iter {iter_num}: loss {loss:.4f}, time: {dt*1000:.2f}ms")
        if step_count % eval_interval == 0:
            log(f"step {iter_num}: val loss {validate(params):.4f}")
        if step_count % save_interval == 0:
            log(f"Saving {variant} weights to {out}")
            save(params, iter_num)
    save(params, max_iters)
    return params


def main_full(
    data_dir: str = "data/alpaca",
    pretrained_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    out_dir: str = "out/full/alpaca",
    max_iters: int = 12500,  # reference finetune/full.py epoch math
    micro_batch_size: int = 4,
    batch_size: int = 128,
    learning_rate: float = 3e-5,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    device: str = "cuda",
):
    """Full finetuning on an instruction dataset (reference `finetune/full.py`)."""
    return _finetune_driver(
        data_dir=data_dir, pretrained_path=pretrained_path, out_dir=out_dir,
        variant="full", learning_rate=learning_rate, weight_decay=0.02,
        micro_batch_size=micro_batch_size, batch_size=batch_size,
        max_iters=max_iters, warmup_iters=100,
        dp=dp, fsdp=fsdp, tp=tp, device=device,
    )


def main_lora(
    data_dir: str = "data/alpaca",
    pretrained_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    out_dir: str = "out/lora/alpaca",
    max_iters: int = 37500,  # 50000 * 3 // micro_batch_size (reference)
    micro_batch_size: int = 4,
    batch_size: int = 128,
    learning_rate: float = 3e-4,
    lora_r: int = 8,
    lora_alpha: int = 16,
    lora_dropout: float = 0.05,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    device: str = "cuda",
):
    """LoRA finetuning (reference `finetune/lora.py:27-46` hyperparameters)."""
    return _finetune_driver(
        data_dir=data_dir, pretrained_path=pretrained_path, out_dir=out_dir,
        variant="lora", learning_rate=learning_rate, weight_decay=0.0,
        micro_batch_size=micro_batch_size, batch_size=batch_size,
        max_iters=max_iters, warmup_iters=100,
        lora_r=lora_r, lora_alpha=lora_alpha, lora_dropout=lora_dropout,
        dp=dp, fsdp=fsdp, tp=tp, device=device,
    )


def main_adapter(
    data_dir: str = "data/alpaca",
    pretrained_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    out_dir: str = "out/adapter/alpaca",
    max_iters: int = 9 * 12500,
    micro_batch_size: int = 4,
    batch_size: int = 64,
    learning_rate: float = 9e-3,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    device: str = "cuda",
):
    """Adapter v1 finetuning (reference `finetune/adapter.py`)."""
    return _finetune_driver(
        data_dir=data_dir, pretrained_path=pretrained_path, out_dir=out_dir,
        variant="adapter", learning_rate=learning_rate, weight_decay=0.02,
        micro_batch_size=micro_batch_size, batch_size=batch_size,
        max_iters=max_iters, warmup_iters=2 * (64 // 4),
        dp=dp, fsdp=fsdp, tp=tp, device=device,
    )


def main_adapter_v2(
    data_dir: str = "data/alpaca",
    pretrained_path: str = "checkpoints/lit-llama/7B/lit-llama.pth",
    out_dir: str = "out/adapter_v2/alpaca",
    max_iters: int = 9 * 12500,
    micro_batch_size: int = 4,
    batch_size: int = 64,
    learning_rate: float = 9e-3,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    device: str = "cuda",
):
    """Adapter v2 finetuning (reference `finetune/adapter_v2.py`)."""
    return _finetune_driver(
        data_dir=data_dir, pretrained_path=pretrained_path, out_dir=out_dir,
        variant="adapter_v2", learning_rate=learning_rate, weight_decay=0.02,
        micro_batch_size=micro_batch_size, batch_size=batch_size,
        max_iters=max_iters, warmup_iters=2 * (64 // 4),
        dp=dp, fsdp=fsdp, tp=tp, device=device,
    )


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main_lora)
