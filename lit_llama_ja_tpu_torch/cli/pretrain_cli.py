"""Pretraining CLI (counterpart of `lit_llama_ja_tpu/cli/pretrain_cli.py`; reference
`pretrain/redpajama.py`, `pretrain/shakespeare.py`).

    python -m lit_llama_ja_tpu_torch.cli.pretrain_cli --model-size 125M \\
        --train-data-dir data/lit-redpajama --val-data-dir data/lit-redpajama-val

Several ranks: run it under ``torchrun`` (or call `main` inside ranks whose default
process group exists) with the mesh arguments ``--dp``, ``--fsdp`` (-1: the remaining
ranks) and ``--tp``, as the JAX CLI takes them:

    torchrun --nproc-per-node 2 -m lit_llama_ja_tpu_torch.cli.pretrain_cli \
        --model-size 125M --fsdp 2 --device cpu ...

``--moe-experts E`` trains the MoE family (`models/moe.py`). A single data source is
read by the C++ reader (`data/native_loader.py`), a weighted mixture by the Python
reader, as in the JAX CLI.
"""
from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.data.packed_dataset import (
    CombinedDataset,
    PackedDataset,
    batch_iterator,
)
from lit_llama_ja_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from lit_llama_ja_tpu_torch.models import llama
from lit_llama_ja_tpu_torch.models.moe import MoEConfig, init_moe_params, make_moe_train_step
from lit_llama_ja_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed
from lit_llama_ja_tpu_torch.parallel.specs import check_divisible, shard_params
from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw, make_train_step
from lit_llama_ja_tpu_torch.train.trainer import TrainLoopConfig, make_validate_fn, train_loop

# data mixture configs (reference `pretrain/redpajama.py:84-95`, ja fork)
train_data_config = [
    ("wikipedia-ja-20230720", 1.0),
    ("wikipedia-en-20230720", 1.0),
    ("open-text-books", 1.0),
    ("oscar_2023_filtered", 1.0),
    ("aozorabunko-clean-sin", 1.0),
]
val_data_config = [
    ("wikinews-ja-20230728", 1.0),
    ("wikinews-en-20230728", 1.0),
]


def create_dataset(
    data_dir: str,
    data_config,
    block_size: int,
    num_processes: int = 1,
    process_rank: int = 0,
    seed: int = 12345,
    shuffle: bool = True,
):
    datasets = []
    for prefix, _ in data_config:
        filenames = sorted(glob.glob(os.path.join(data_dir, prefix + "*")))
        if not filenames:
            continue
        datasets.append(
            PackedDataset(
                filenames, n_chunks=max(len(filenames), 1), block_size=block_size,
                shuffle=shuffle, seed=seed, wrap=True,
                num_processes=num_processes, process_rank=process_rank,
            )
        )
    if not datasets:
        raise RuntimeError(
            f"No data found at {data_dir}. Run scripts/prepare_redpajama.py or "
            "scripts/prepare_ja.py first."
        )
    weights = [w for _, w in data_config[: len(datasets)]]
    s = sum(weights)
    return CombinedDataset(datasets, seed=seed, weights=[w / s for w in weights])


def _compute_dtype(dev: torch.device) -> Optional[torch.dtype]:
    """bf16 on the card (the attention kernels take bf16, and a TPU runs an f32
    matmul at bf16 precision by default); f32 on the CPU."""
    return torch.bfloat16 if dev.type == "cuda" else None


def main(
    train_data_dir: str = "data/lit-redpajama",
    val_data_dir: Optional[str] = None,
    model_size: str = "7B",
    out_dir: str = "out/training",
    load_dir: Optional[str] = None,
    restart_iter: int = 0,
    resume: Optional[str] = None,
    learning_rate: float = 8e-4,
    weight_decay: float = 0.1,
    micro_batch_size: int = 4,
    batch_size: int = 128,
    max_iters: int = 143000,
    warmup_iters: int = 2000,
    grad_clip: float = 1.0,
    remat: bool = False,
    dp: int = 1,
    fsdp: int = -1,
    tp: int = 1,
    save_interval: int = 100,
    eval_interval: int = 100,
    eval_iters: int = 100,
    log_interval: int = 500,
    seed: int = 1337,
    moe_experts: int = 0,
    moe_topk: int = 2,
    train_prefixes: Optional[str] = None,
    val_prefixes: Optional[str] = None,
    device: str = "cuda",
) -> None:
    """Pretrain LLaMA on packed datasets (reference `pretrain/redpajama.py:97-189`).

    Precision: on CUDA the step casts the params to bf16 inside the loss
    (``compute_dtype=torch.bfloat16``) while the master weights, gradients and AdamW
    moments stay f32. The attention kernels take bf16, and on a TPU, where the JAX
    package runs, an f32 matmul runs at bf16 precision by default. An MoE router
    stays f32 (`train/step.cast_floating`). On the CPU the step runs in f32. Without a
    mesh, on the card, the step and the validation loss are each one captured CUDA
    graph (`train/step.TrainStep`, `train/trainer.make_val_loss`), as the JAX CLI jits
    them; a resumed state's optimizer count is loaded onto the device.

    MoE: ``--moe-experts E`` swaps the dense MLP for a top-``--moe-topk`` mixture of E
    experts a block. As in the JAX CLI, its validation runs the dense forward, which
    finds no ``mlp`` leaf and raises ``KeyError`` at the first evaluation (ROADMAP.md,
    queue 3).

    Data: a single source with chunk files is read by the C++ reader (seeded
    shuffle); where it does not build, the Python reader takes over with a printed
    message. Several sources are mixed by the Python reader.

    Resume: ``--resume <out_dir>/state-latest`` restores the full training state
    (params, optimizer moments, iteration, data position: the C++ reader skips the
    consumed batches, the Python reader fast-forwards). ``--load-dir``/
    ``--restart-iter`` keep the reference's weights-only restart.

    Distribution: under a process group the ranks form a ``(dp, fsdp, tp)`` mesh
    (`parallel/mesh.make_mesh`); each holds its slices of the params and AdamW moments
    and its rows of every micro-batch (`train/step.py`), all read the same batches,
    and ``grad_accum = max(batch_size // world // micro_batch_size, 1)``, as in the JAX
    CLI. Rank 0 writes the gathered checkpoints and the metrics file. Without a
    process group the mesh arguments must describe one rank.
    """
    dev = resolve_device(device)
    maybe_init_distributed()
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp)
    if not torch.distributed.is_initialized():
        mesh = None  # one rank and no group: the one-device path
    else:
        print(f"mesh: {mesh.shape}, backend {mesh.backend}")
    world = 1 if mesh is None else mesh.world
    rank0 = mesh is None or mesh.rank == 0
    on_mesh = {} if mesh is None else {"mesh": mesh}  # for the checkpoint functions
    # comma-separated chunk-file prefix overrides (equal mixture weights)
    eff_train_config = (
        [(px.strip(), 1.0) for px in train_prefixes.split(",")]
        if train_prefixes else train_data_config
    )
    eff_val_config = (
        [(px.strip(), 1.0) for px in val_prefixes.split(",")]
        if val_prefixes else val_data_config
    )
    if moe_experts:
        config = MoEConfig.from_name(model_size, n_expert=moe_experts, n_expert_active=moe_topk)
    else:
        config = LLaMAConfig.from_name(model_size)
    config.debug()
    check_divisible(config, mesh)
    os.makedirs(out_dir, exist_ok=True)
    print(f"device: {dev}")

    if load_dir:
        print(f"load from checkpoint... {load_dir}")
        params, _ = load_checkpoint(load_dir, device=dev, **on_mesh)
    else:
        init = init_moe_params if moe_experts else llama.init_params
        params = init(torch.Generator().manual_seed(seed), config, device=dev)
        if mesh is not None:
            params = shard_params(params, mesh)

    schedule = cosine_with_warmup(learning_rate, warmup_iters, max_iters, learning_rate / 10)
    opt = make_adamw(schedule, weight_decay=weight_decay, grad_clip=grad_clip)
    opt_state = init_opt_state(opt, params)
    if resume:
        print(f"resuming full training state from {resume}")
        params, opt_state, _, meta = load_train_state(resume, device=dev, **on_mesh)
        restart_iter = int(meta.get("iter", -1)) + 1
        print(f"-> continuing from iter {restart_iter}")
    compute_dtype = _compute_dtype(dev)
    make_step = make_moe_train_step if moe_experts else make_train_step
    step = make_step(config, opt, remat=remat, compute_dtype=compute_dtype, device=dev,
                     mesh=mesh)

    grad_accum = max(batch_size // world // micro_batch_size, 1)
    batches = None
    sources = [p for p, _ in eff_train_config
               if glob.glob(os.path.join(train_data_dir, p + "*"))]
    if len(sources) == 1:
        try:
            from lit_llama_ja_tpu_torch.data.native_loader import NativePackedBatches

            files = sorted(glob.glob(os.path.join(train_data_dir, sources[0] + "*")))
            batches = NativePackedBatches(
                files, micro_batch_size, config.block_size + 1, seed=seed + 1, wrap=True,
                skip_batches=restart_iter * grad_accum,
            )
            print("using native C++ packed reader")
        except (OSError, RuntimeError) as e:  # no g++, or the build failed
            print(f"native reader unavailable ({e}); using Python reader")
    if batches is None:
        train_ds = create_dataset(train_data_dir, eff_train_config, config.block_size + 1,
                                  seed=seed + 1)
        ds_iter = iter(train_ds)
        if restart_iter:
            ds_iter.fast_forward(restart_iter * grad_accum * micro_batch_size)
        batches = batch_iterator(ds_iter, micro_batch_size)

    validate_fn = None
    if val_data_dir:
        val_ds = create_dataset(val_data_dir, eff_val_config, config.block_size + 1,
                                seed=seed + 2, shuffle=False)
        validate_fn = make_validate_fn(
            config, eval_iters, lambda: batch_iterator(val_ds, micro_batch_size),
            forward_fn=lambda p, x: llama.forward(p, x, config, device=dev, mesh=mesh),
            device=dev, compute_dtype=compute_dtype, mesh=mesh, pool=getattr(step, "pool", None),
        )

    def save_fn(params, iter_num):
        save_checkpoint(Path(out_dir) / f"iter-{iter_num:06d}-ckpt", params, config, **on_mesh)

    def save_state_fn(params, opt_state, iter_num):
        save_train_state(Path(out_dir) / "state-latest", params, opt_state, config,
                         meta={"iter": iter_num}, **on_mesh)

    loop_cfg = TrainLoopConfig(
        max_iters=max_iters, log_interval=log_interval,
        eval_interval=eval_interval, save_interval=save_interval,
        eval_iters=eval_iters, grad_accum_steps=grad_accum,
        micro_batch_size=micro_batch_size, block_size=config.block_size,
        out_dir=out_dir, metrics_file=str(Path(out_dir) / "metrics.jsonl") if rank0 else None,
    )
    params, opt_state = train_loop(
        step, params, opt_state, batches, loop_cfg,
        lr_schedule=schedule, validate_fn=validate_fn, save_fn=save_fn,
        save_state_fn=save_state_fn, restart_iter=restart_iter,
    )
    print(f"Saving checkpoint to {out_dir}")
    save_checkpoint(Path(out_dir) / f"iter-{max_iters:06d}-ckpt", params, config, **on_mesh)


def main_shakespeare(
    data_dir: str = "data/shakespeare",
    out_dir: str = "out/shakespeare",
    learning_rate: float = 3e-4,
    micro_batch_size: int = 8,
    max_iters: int = 2000,
    block_size: int = 256,
    n_layer: int = 4,
    n_head: int = 8,
    n_embd: int = 256,
    log_interval: int = 50,
    seed: int = 1337,
    device: str = "cuda",
) -> None:
    """Shakespeare smoke pretrain (reference `pretrain/shakespeare.py`): memmap .bin
    random crops, tiny model, 100-token vocab. Precision as in `main`."""
    dev = resolve_device(device)
    config = LLaMAConfig(
        block_size=block_size, vocab_size=100,
        n_layer=n_layer, n_head=n_head, n_embd=n_embd,
    )
    params = llama.init_params(torch.Generator().manual_seed(seed), config, device=dev)
    schedule = cosine_with_warmup(learning_rate, 100, max_iters, learning_rate / 10)
    opt = make_adamw(schedule, weight_decay=0.1)
    step = make_train_step(config, opt, compute_dtype=_compute_dtype(dev), device=dev)
    opt_state = init_opt_state(opt, params)

    train_data = np.memmap(os.path.join(data_dir, "train.bin"), dtype=np.uint16, mode="r")

    def batches():
        rng = np.random.default_rng(seed)
        while True:
            ix = rng.integers(0, len(train_data) - block_size - 1, micro_batch_size)
            yield np.stack(
                [train_data[i : i + block_size + 1].astype(np.int64) for i in ix]
            )

    loop_cfg = TrainLoopConfig(
        max_iters=max_iters, log_interval=log_interval,
        eval_interval=10**9, save_interval=10**9,
        grad_accum_steps=1, micro_batch_size=micro_batch_size,
        block_size=block_size, out_dir=out_dir,
    )
    params, _ = train_loop(step, params, opt_state, batches(), loop_cfg, lr_schedule=schedule)
    save_checkpoint(Path(out_dir) / "final", params, config)


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main)
