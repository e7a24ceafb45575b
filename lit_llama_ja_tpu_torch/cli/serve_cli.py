"""Batch-serving CLI over the continuous-batching engines (counterpart of
`lit_llama_ja_tpu/cli/serve_cli.py`).

    python -m lit_llama_ja_tpu_torch.cli.serve_cli --checkpoint-path <dir or .pth> \\
        --tokenizer-path <tokenizer.json> --quantize gptq.int4 --quantize-kv int8

The paged engine (`infer/paged.py`) is the default; ``--paged false`` selects the
slot-stripe engine (`infer/serving.py`), and ``--draft-checkpoint-path`` the
speculative paged engines (`infer/spec_serving.py`, or `infer/tree_spec.py` with
``--draft-tree``). ``--tp``/``--fsdp`` shard the weights over a ``(1, fsdp, tp)`` mesh
of ranks (run under ``torchrun``): every rank runs the engine alike on its slices, its
cache holding its ``nh / tp`` heads, and rank 0 prints. ``--pp-stages S`` serves
pipeline-parallel (`parallel/pp_decode.py`, `parallel/pp_spec.py`) over a ``(1, fsdp,
tp, S)`` mesh of ``S · tp · fsdp`` ranks, each holding its stage's layers;
``--pp-microbatches`` sets the wavefront's micro-groups (default S). A draft model is
loaded whole on every rank and runs alike there. The stripe engine has no pipeline
form: with ``--pp-stages`` it runs the model whole on every rank, as the JAX package's
CLI runs it whole.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

from lit_llama_ja_tpu_torch.core.device import resolve_device


def main(
    prompts_file: str = "",
    prompt: str = "Hello, my name is",
    n_requests: int = 8,
    max_new_tokens: int = 50,
    max_batch: int = 8,
    temperature: float = 0.8,
    top_k: int = 200,
    top_p: float = 1.0,
    checkpoint_path: str = "checkpoints/lit-llama/7B/native",
    tokenizer_path: str = "checkpoints/lit-llama/tokenizer.json",
    quantize: Optional[str] = None,
    quantize_kv: str = "int4",
    max_seq_length: int = 2048,
    paged: bool = True,
    page_size: int = 16,
    n_pages: int = 0,
    prefill_chunk: int = 0,
    draft_checkpoint_path: str = "",
    draft_k: int = 4,
    adaptive_k: bool = False,
    draft_tree: str = "",
    pp_stages: int = 0,
    pp_microbatches: int = 0,
    tp: int = 1,
    fsdp: int = 1,
    seed: int = 1234,
    device: str = "cuda",
) -> None:
    """Serve a batch of prompts with continuous batching.

    Args:
        prompts_file: newline-separated prompts; empty -> repeat ``prompt``
            ``n_requests`` times.
        quantize: None | llm.int8 | llm.int8-rtn | llm.int8-dyn |
            {gptq|rtn}.int{2,3,4,8}[-g<N>] | {gptq|rtn}.mix... (weights).
        quantize_kv: "int4" (default, head-pair packed) | "int8" | "none". The int8
            page pool runs the paged decode-attention kernel on the card.
        paged: page-pool KV cache (the default): a shared memory budget with admission
            backpressure and preemption. ``--paged false`` selects the slot-stripe
            engine, whose cache is int8 at most (int4 is served as int8).
        page_size: tokens per page (paged only).
        n_pages: KV pool size in pages; 0 -> the dense equivalent
            ``max_batch * max_seq_length / page_size`` plus the trash page.
        prefill_chunk: interleave long-prompt prefill with decode in chunks of this
            many tokens (paged only); 0 = whole-prompt prefill.
        draft_checkpoint_path: a small model of the same tokenizer that turns on
            batched speculative decoding (paged only): up to draft_k + 1 tokens per
            slot per step, the target's distribution exactly.
        draft_k: drafted tokens per speculative round.
        adaptive_k: pick K per round from [1, draft_k] under the measured acceptance
            (chain speculation only).
        draft_tree: comma-separated branching per level (e.g. "4,2,2") for tree
            speculation; empty = a chain of draft_k tokens.
        pp_stages, pp_microbatches: pipeline-parallel serving over this many stages
            (the paged and speculative engines), with this many micro-groups a step
            (0: pp_stages).
        tp, fsdp: weight sharding over a (1, fsdp, tp) mesh of ranks, inside each stage
            with pp_stages.
        seed: sampling seed.
        device: "cuda" (default) or "cpu".
    """
    from lit_llama_ja_tpu_torch.cli.generate_cli import (
        compute_dtype,
        load_model_any,
        load_tokenizer,
        serving_mesh,
    )
    from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
    from lit_llama_ja_tpu_torch.infer.serving import Engine
    from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
    from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine
    from lit_llama_ja_tpu_torch.models.llama import cast_params, normalize_kv_mode

    pp = pp_stages if pp_stages > 1 else 1
    dev = resolve_device(device)
    mesh = serving_mesh(tp, fsdp, pp)
    model_mesh = mesh if paged or pp == 1 else None  # the stripe engine: whole on every rank
    params, config = load_model_any(Path(checkpoint_path), quantize, device=dev,
                                    mesh=model_mesh)
    params = cast_params(params, compute_dtype(dev))
    quantize_kv = normalize_kv_mode(quantize_kv)
    tokenizer = load_tokenizer(tokenizer_path)

    if prompts_file:
        prompts = [line.strip() for line in Path(prompts_file).read_text().splitlines()
                   if line.strip()]
    else:
        prompts = [prompt] * n_requests

    if paged:
        common = dict(
            max_batch=max_batch, n_pages=n_pages or (max_batch * max_seq_length) // page_size + 1,
            page_size=page_size, max_pages_per_slot=max(1, max_seq_length // page_size),
            quantize_kv=quantize_kv, eos_id=tokenizer.eos_id,
            prefill_chunk=prefill_chunk or None, seed=seed, device=dev,
        )
        if pp > 1:
            common.update(pp_mesh=mesh, pp_microbatches=pp_microbatches or pp)
        else:
            common.update(mesh=mesh)
        if draft_checkpoint_path:  # whole on every rank
            dparams, dconfig = load_model_any(Path(draft_checkpoint_path), None, device=dev)
            draft = dict(draft_params=cast_params(dparams, compute_dtype(dev)),
                         draft_config=dconfig)
            if draft_tree:
                engine = TreeSpeculativePagedEngine(
                    params, config, tree=tuple(int(b) for b in draft_tree.split(",")),
                    **draft, **common)
            else:
                engine = SpeculativePagedEngine(params, config, draft_k=draft_k,
                                                adaptive_k=adaptive_k, **draft, **common)
        else:
            engine = PagedEngine(params, config, **common)
    else:
        if quantize_kv == "int4":
            # the stripe engine has no head-pair int4 cache; its write path is int8
            print("stripe engine supports int8 KV at most; using int8", file=sys.stderr)
            quantize_kv = "int8"
        engine = Engine(params, config, max_batch=max_batch, max_seq_length=max_seq_length,
                        quantize_kv=quantize_kv, eos_id=tokenizer.eos_id, seed=seed, device=dev,
                        mesh=model_mesh)
    encoded = []
    for p in prompts:
        ids = tokenizer.encode(p, bos=True, eos=False)
        if len(ids) >= max_seq_length:
            print(f"skipping prompt of {len(ids)} tokens (cache holds {max_seq_length})",
                  file=sys.stderr)
            continue
        encoded.append(ids)
    if not encoded:
        print("no valid prompts", file=sys.stderr)
        return

    t0 = time.perf_counter()
    outputs = engine.run([(ids, max_new_tokens) for ids in encoded], temperature=temperature,
                         top_k=top_k, top_p=top_p if top_p < 1.0 else None)
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return

    n_tokens = 0
    for rid in sorted(outputs):
        n_tokens += len(outputs[rid]) - len(encoded[rid])
        print(f"--- request {rid} ---")
        print(tokenizer.decode(outputs[rid]))
    print(f"\n{len(outputs)} requests, {n_tokens} tokens in {dt:.2f}s "
          f"-> {n_tokens / dt:.1f} tokens/s aggregate", file=sys.stderr)


if __name__ == "__main__":
    from lit_llama_ja_tpu_torch.utils.cli import CLI

    CLI(main)
