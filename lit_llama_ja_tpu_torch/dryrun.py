"""Entry points of a quick check (counterpart of `__graft_entry__.py`): one forward of
the flagship config, and one sharded step of every parallel family.

    python -m lit_llama_ja_tpu_torch.dryrun 4          # 4 gloo ranks on the card
    python -m lit_llama_ja_tpu_torch.dryrun 4 cpu      # 4 gloo ranks on the CPU

* `entry` returns ``(fn, args)``: `models/llama.forward` of the 19M ja config at
  ``block_size=128`` on bf16 params from a seeded generator, and ``(1, 32)`` ids.
* `dryrun_multichip` runs in every rank of a process group of ``n_devices`` ranks and
  follows the JAX function step by step, on its tiny config (block 32, vocab 128, 2
  layers, 4 heads, 32 wide) and its mesh factorisation: one dp×fsdp×tp train step;
  one dp×fsdp×tp LoRA SFT step (r 2, alpha 4); with an even rank count a pp×tp×dp
  GPipe step and a pp×tp `PagedEngine` run on one 5-token prompt; an ep MoE step at
  ``ep = min(n, 4)``; the ring-attention `forward_sp` at T = 64 over a tp mesh of
  every rank. Rank 0 prints the JAX function's lines with the port's values; every
  rank returns its losses, tokens and kernel launches by step.
* `main` spawns the ranks over gloo (on the one card, or on the CPU when asked) and
  returns rank 0's results.

On the card every step computes in bf16 (the attention kernels take bf16 only).
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device


def entry(device="cuda"):
    """``(fn, (params, idx))``: a forward of the 19M ja config (reference
    `lit_llama/model.py:49`) at ``block_size=128`` on bf16 params, idx ``ones((1, 32))``."""
    from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
    from lit_llama_ja_tpu_torch.models import llama

    dev = resolve_device(device)
    config = LLaMAConfig.from_name("19M", block_size=128)
    params = llama.init_params(torch.Generator().manual_seed(0), config,
                               dtype=torch.bfloat16, device=dev)
    idx = torch.ones((1, 32), dtype=torch.long, device=dev)

    def fn(params, idx):
        return llama.forward(params, idx, config, device=dev)

    return fn, (params, idx)


def _launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count."""
    from lit_llama_ja_tpu_torch.ops.cuda import flash_attention, paged_attention
    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul, quant_matmul_sub4

    fns = [quant_matmul.quant_matmul_int4, quant_matmul.quant_matmul_int8,
           quant_matmul_sub4.quant_matmul_int2, quant_matmul_sub4.quant_matmul_int3,
           flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd,
           paged_attention.paged_decode_attention, paged_attention.paged_decode_attention_db]
    return {fn.__name__: fn.launches for fn in fns}


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, Any]:
    """One step of every parallel family over the ``n_devices`` ranks of the current
    process group (see the module docstring). Returns ``{"lines": [...], "loss": {step:
    loss}, "tokens": n, "launches": {step: {kernel: count}}}``, the launches those of
    this rank during each step."""
    import torch.distributed as dist

    from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
    from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
    from lit_llama_ja_tpu_torch.models import llama
    from lit_llama_ja_tpu_torch.models import lora as lora_mod
    from lit_llama_ja_tpu_torch.models.moe import MoEConfig, init_moe_params
    from lit_llama_ja_tpu_torch.parallel.ep import make_moe_train_step_ep, shard_params_ep
    from lit_llama_ja_tpu_torch.parallel.mesh import make_mesh
    from lit_llama_ja_tpu_torch.parallel.pipeline import make_pp_train_step, shard_params_pp
    from lit_llama_ja_tpu_torch.parallel.sp_forward import forward_sp
    from lit_llama_ja_tpu_torch.parallel.specs import gather_params, shard_params
    from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
    from lit_llama_ja_tpu_torch.train.step import (
        AdamW,
        init_opt_state,
        make_adamw,
        make_sft_train_step,
        make_train_step,
    )

    dev = resolve_device(device)
    cdt = torch.bfloat16 if dev.type == "cuda" else None
    n, rank = n_devices, dist.get_rank()
    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) runs in a process group of {n} ranks, "
                         f"not {dist.get_world_size()}")
    out: Dict[str, Any] = {"lines": [], "loss": {}, "launches": {}}

    def say(line):
        out["lines"].append(line)
        if rank == 0:
            print(line, flush=True)

    def counted(name, fn):
        before = _launches()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["launches"][name] = {k: v - before[k] for k, v in _launches().items()}
        return res

    def init(seed, config):
        return llama.init_params(torch.Generator().manual_seed(seed), config, device=dev)

    # factor n into dp × fsdp × tp (2-way tp where it can)
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    fsdp = 2 if rest % 2 == 0 else rest
    dp = rest // fsdp
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp)
    say(f"mesh: dp={dp} fsdp={fsdp} tp={tp}")

    config = LLaMAConfig(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=32)
    params = shard_params(init(0, config), mesh)
    opt = make_adamw(cosine_with_warmup(1e-3, 10, 100, 1e-4))
    step = make_train_step(config, opt, compute_dtype=cdt, device=dev, mesh=mesh)
    batch = torch.as_tensor(np.random.default_rng(0).integers(0, 128, size=(1, 2 * dp * fsdp, 33)))
    params, _, loss = counted("train", lambda: step(params, init_opt_state(opt, params), batch))
    out["loss"]["train"] = float(loss)
    say(f"dryrun_multichip({n}): one sharded train step OK, loss={float(loss):.4f}")

    # mesh-sharded SFT: the LoRA leaves train over the same dp×fsdp×tp mesh
    lp = lora_mod.init_lora_params(torch.Generator().manual_seed(5), config, r=2, alpha=4,
                                   device=dev)
    params_sft = shard_params(lora_mod.add_lora(init(5, config), lp), mesh)
    opt_sft = make_adamw(1e-3, weight_decay=0.0)
    sft_step = make_sft_train_step(config, opt_sft, trainable_pred=lora_mod.lora_trainable,
                                   compute_dtype=cdt, device=dev, mesh=mesh)
    sft_batch = {"input_ids": batch[:, :, :-1], "labels": batch[:, :, 1:]}
    state_sft = init_opt_state(opt_sft, params_sft, trainable_pred=lora_mod.lora_trainable)
    _, _, loss = counted("lora_sft", lambda: sft_step(params_sft, state_sft, sft_batch,
                                                      torch.Generator().manual_seed(6)))
    out["loss"]["lora_sft"] = float(loss)
    say(f"dryrun_multichip({n}): dp×fsdp×tp LoRA-SFT train step OK, loss={float(loss):.4f}")

    # pipeline parallelism: GPipe over a dp×tp×pp mesh
    pp = 2 if n % 2 == 0 else 1
    if pp > 1:
        rest_pp = n // pp
        tp_pp = 2 if rest_pp % 2 == 0 else 1
        dp_pp = rest_pp // tp_pp
        mesh_pp = make_mesh(dp=dp_pp, fsdp=1, tp=tp_pp, pp=pp)
        params_pp = shard_params_pp(init(1, config), mesh_pp, tp=tp_pp > 1)
        opt_pp = make_adamw(cosine_with_warmup(1e-3, 10, 100, 1e-4))
        step_pp = make_pp_train_step(config, opt_pp, mesh_pp, tp_axis="tp" if tp_pp > 1 else None,
                                     compute_dtype=cdt, device=dev).jit_with(params_pp)
        batch_pp = torch.as_tensor(
            np.random.default_rng(1).integers(0, 128, size=(2 * pp, max(dp_pp, 1), 33)))
        _, _, loss = counted("gpipe", lambda: step_pp(params_pp, opt_pp.init(params_pp),
                                                      batch_pp))
        out["loss"]["gpipe"] = float(loss)
        say(f"dryrun_multichip({n}): pp={pp}×tp={tp_pp}×dp={dp_pp} GPipe train step OK, "
            f"loss={float(loss):.4f}")

        # pipeline-parallel serving over pp × tp (the first pp·tp ranks)
        tp_srv = 2 if (n // pp) % 2 == 0 else 1
        mesh_srv = make_mesh(dp=1, fsdp=1, tp=tp_srv, pp=pp, world=pp * tp_srv)
        if rank < pp * tp_srv:
            eng = PagedEngine(llama.cast_params(init(2, config), cdt), config, max_batch=2,
                              n_pages=16, page_size=4, pp_mesh=mesh_srv, pp_microbatches=2,
                              device=dev)
            prompt = np.random.default_rng(2).integers(0, 128, size=(5,)).astype(np.int32)
            res = counted("paged_engine", lambda: eng.run([(prompt, 4)]))
            out["tokens"] = len(res[0])
            say(f"dryrun_multichip({n}): pp={pp}×tp={tp_srv} paged-engine decode OK, "
                f"tokens={len(res[0])}")
            del eng

    # expert parallelism: the experts over 'ep' (the first ep ranks)
    ep = min(n, 4)
    mesh_ep = make_mesh(dp=1, fsdp=1, tp=1, ep=ep, world=ep)
    if rank < ep:
        moe_cfg = MoEConfig(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=32,
                            n_expert=2 * ep, n_expert_active=2)
        moe_params = shard_params_ep(
            init_moe_params(torch.Generator().manual_seed(3), moe_cfg, device=dev), mesh_ep)
        opt_ep = AdamW(1e-3, weight_decay=1e-4, beta2=0.999, grad_clip=None)  # optax.adamw's
        step_ep = make_moe_train_step_ep(moe_cfg, opt_ep, mesh_ep, compute_dtype=cdt,
                                         device=dev).jit_with(moe_params)
        batch_ep = torch.as_tensor(np.random.default_rng(3).integers(0, 128, size=(ep, 33)))
        _, _, loss = counted("moe_ep", lambda: step_ep(
            moe_params, init_opt_state(opt_ep, moe_params), batch_ep))
        out["loss"]["moe_ep"] = float(loss)
        say(f"dryrun_multichip({n}): ep={ep} MoE (E={moe_cfg.n_expert} top-"
            f"{moe_cfg.n_expert_active}) all_to_all train step OK, loss={float(loss):.4f}")

    # sequence parallelism: the ring-attention forward past block_size, on the params
    # of the first step
    mesh_sp = make_mesh(dp=1, fsdp=1, tp=n)
    whole = llama.cast_params(gather_params(params, mesh), cdt)
    idx_sp = torch.ones((1, 2 * config.block_size), dtype=torch.long)
    logits_sp = counted("sp_ring", lambda: forward_sp(whole, idx_sp, config, mesh_sp, "tp",
                                                      "ring", device=dev))
    out["sp_logits_finite"] = bool(torch.isfinite(logits_sp).all())
    say(f"dryrun_multichip({n}): ring-attention SP forward OK, "
        f"T={idx_sp.shape[1]} logits={tuple(logits_sp.shape)}")
    return out


def _rank(rank: int, n: int, root: str, device: str) -> None:
    import torch.distributed as dist

    if device != "cpu":
        torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=n)
    try:
        out = dryrun_multichip(n, device)
        torch.save(out, os.path.join(root, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(n_devices: int = 4, device: str = "cuda") -> Dict[str, Any]:
    """Spawn ``n_devices`` gloo ranks (all on the one card, or on the CPU with
    ``device="cpu"``), run `dryrun_multichip` in each and return rank 0's results."""
    import torch.multiprocessing as mp

    resolve_device(device)  # no card and no device="cpu": raise here, not in the ranks
    with tempfile.TemporaryDirectory() as root:
        mp.spawn(_rank, args=(n_devices, root, device), nprocs=n_devices, join=True)
        return torch.load(os.path.join(root, "out0.pt"), weights_only=False)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
         sys.argv[2] if len(sys.argv) > 2 else "cuda")
