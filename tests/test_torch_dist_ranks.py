"""Gloo ranks on the CPU for the parallel tests of the PyTorch port.

`spawn` runs ``body(mesh_rank, world, *args)`` in ``world`` fresh processes joined by a
gloo group whose rendezvous is a file under the test's ``tmp_path`` (so tests under
pytest-xdist cannot collide), each with one intra-op thread. A body returns a dict of
tensors (or None); `spawn` returns every rank's dict, in rank order. The rank bodies
live in this module, which does not import jax, so a spawned rank starts quickly. It
holds no test of its own: the parallel test files import it.
"""
from __future__ import annotations

import gc
import os
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, root, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=world)
    try:
        out = body(rank, world, *args)
        torch.save(out, os.path.join(root, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(body, world: int, tmp_path, *args, meanwhile=None):
    """``meanwhile``: a function this process runs while the ranks run; its result is
    returned after the ranks' outputs when given."""
    root = Path(tmp_path) / f"ranks-{body.__name__}-{world}"
    root.mkdir(parents=True, exist_ok=True)
    for f in root.glob("*"):
        f.unlink()
    ctx = mp.spawn(_entry, args=(world, str(root), body, args), nprocs=world, join=False)
    extra = meanwhile() if meanwhile is not None else None
    while not ctx.join():
        pass
    outs = [torch.load(root / f"out{r}.pt", weights_only=False) for r in range(world)]
    return outs if meanwhile is None else (outs, extra)


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def _mesh(dims):
    from lit_llama_ja_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(**dims)


def model_paths(rank, world, trees, cfg, idx, prompt, meshes):
    """For each mesh: the sharded forward's logits of every tree in ``trees``, the
    greedy tokens of `generate` (int8 cache), of `speculative_generate` (the dense tree
    drafting for itself) and of the paged engine (int8 pool), and the local shapes of
    the dense tree's leaves."""
    from lit_llama_ja_tpu_torch.infer.generate import generate
    from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
    from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
    from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
    from lit_llama_ja_tpu_torch.models.llama import forward
    from lit_llama_ja_tpu_torch.parallel.specs import shard_params

    out = {}
    for m, dims in enumerate(meshes):
        mesh = _mesh(dims)
        for name, tree in trees.items():
            local = shard_params(tree, mesh)
            out[f"{m}/{name}/logits"] = forward(local, idx, cfg, device="cpu", mesh=mesh)
            if name == "fp":
                out[f"{m}/shapes"] = {k: tuple(v.shape) for k, v in flatten_tree(local).items()}
            if dims.get("dp", 1) != 1:
                continue
            out[f"{m}/{name}/generate"] = torch.as_tensor(generate(
                local, cfg, prompt, 6, temperature=0.0, quantize_kv="int8", device="cpu",
                mesh=mesh))
            if name == "fp":  # the target drafting for itself, both sharded
                out[f"{m}/speculative"] = torch.as_tensor(speculative_generate(
                    local, cfg, local, cfg, prompt, 6, K=2, temperature=0.0,
                    quantize_kv="int8", device="cpu", mesh=mesh))
            eng = PagedEngine(local, cfg, max_batch=2, n_pages=16, page_size=8,
                              quantize_kv="int8", device="cpu", mesh=mesh)
            res = eng.run([(prompt, 5), (prompt[:5], 4)], temperature=0.0)
            out[f"{m}/{name}/paged"] = [torch.as_tensor(res[i]) for i in sorted(res)]
    return out


def train_steps(rank, world, cases, batch, meshes, n_steps):
    """For each mesh and each ``(params, cfg, moe)`` of ``cases``: ``n_steps`` sharded
    AdamW steps; the losses and the gathered parameters."""
    from lit_llama_ja_tpu_torch.models.moe import make_moe_train_step
    from lit_llama_ja_tpu_torch.parallel.specs import gather_params, shard_params
    from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw, make_train_step

    out = {}
    for m, dims in enumerate(meshes):
        mesh = _mesh(dims)
        for name, (params, cfg, moe) in cases.items():
            local = shard_params(params, mesh)
            opt = make_adamw(lambda _: 1e-2, grad_clip=0.5)
            state = init_opt_state(opt, local)
            step = (make_moe_train_step if moe else make_train_step)(cfg, opt, device="cpu",
                                                                     mesh=mesh)
            losses = []
            for _ in range(n_steps):
                local, state, loss = step(local, state, batch)
                losses.append(loss)
            out[f"{m}/{name}"] = {"loss": torch.stack(losses),
                                  "params": gather_params(local, mesh)}
    return out


class CharTokenizer:
    """A stand-in tokenizer: one id a character (``ord % 250 + 3``), BOS 1, EOS 2."""
    bos_id, eos_id, vocab_size = 1, 2, 256

    def encode(self, text, bos=True, eos=False):
        ids = ([1] if bos else []) + [ord(c) % 250 + 3 for c in text] + ([2] if eos else [])
        return torch.tensor(ids, dtype=torch.int32)

    def decode(self, ids):
        return "".join(chr(int(i) + 97 - 3) if 3 <= int(i) < 29 else "?" for i in ids)


def cli_runs(rank, world, root, tiny, runs):
    """Run the port's CLIs in this rank: ``runs`` is a list of ``(name, kwargs)``;
    pretrain runs write their metrics under ``root``, generate and serve runs return
    what rank 0 printed."""
    import contextlib
    import io
    from unittest import mock

    from lit_llama_ja_tpu_torch.cli import generate_cli, pretrain_cli, serve_cli
    from lit_llama_ja_tpu_torch.core import config as tconfig

    out = {}
    # the registry is the process's: a test process gets it back as it was
    with mock.patch.dict(tconfig.llama_configs, {"tiny": tiny}), \
            mock.patch.object(generate_cli, "load_tokenizer", lambda _: CharTokenizer()):
        for name, kw in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn = {"pretrain": pretrain_cli.main, "generate": generate_cli.main,
                      "serve": serve_cli.main}[name.split("-")[0]]
                fn(**kw)
            out[name] = buf.getvalue() if rank == 0 else ""
    return out


def ring_matmuls(rank, world, cases):
    """`ring_quant_matmul` over an fsdp axis of every rank: ``cases`` maps a name to
    ``(x, full pack, K)``; each rank cuts its K-shard with `k_shard`."""
    from lit_llama_ja_tpu_torch.parallel.collective_matmul import k_shard, ring_quant_matmul

    mesh = _mesh(dict(fsdp=-1))
    return {name: ring_quant_matmul(x, k_shard(qp, K, mesh), mesh, axis="fsdp",
                                    grouped=qp["scales"].shape[0] > 1)
            for name, (x, qp, K) in cases.items()}


def seq_parallel(rank, world, q, k, v, params, cfg, idx_short, idx_long):
    """Both sequence-parallel attentions and `forward_sp` (both impls) over a tp axis of
    every rank; q, k, v are whole and each rank takes its positions."""
    from lit_llama_ja_tpu_torch.parallel.ring_attention import ring_attention
    from lit_llama_ja_tpu_torch.parallel.sp_attention import sequence_parallel_attention
    from lit_llama_ja_tpu_torch.parallel.sp_forward import forward_sp

    mesh = _mesh(dict(fsdp=1, tp=world))
    Tl = q.shape[2] // world
    mine = [t[:, :, rank * Tl:(rank + 1) * Tl] for t in (q, k, v)]
    out = {"allgather": sequence_parallel_attention(*mine, mesh, impl="allgather"),
           "ring": sequence_parallel_attention(*mine, mesh, impl="ring"),
           "ring_direct": ring_attention(*mine, mesh),
           "ring_bf16": ring_attention(*[t.bfloat16() for t in mine], mesh)}
    for impl in ("allgather", "ring"):
        out[f"sp_{impl}"] = forward_sp(params, idx_short, cfg, mesh, attn_impl=impl,
                                       device="cpu")
        out[f"sp_long_{impl}"] = forward_sp(params, idx_long, cfg, mesh, attn_impl=impl,
                                            device="cpu")
    return out


def expert_parallel(rank, world, params, cfg, idx, batch, lr):
    """`forward_moe_ep` and one `make_moe_train_step_ep` step (optax.adamw's settings:
    b2 0.999, weight decay 1e-4, no clip) over an ep axis of every rank; the step's
    loss and its gathered parameters."""
    from lit_llama_ja_tpu_torch.parallel.ep import (
        ep_spec_of,
        forward_moe_ep,
        make_moe_train_step_ep,
        shard_params_ep,
    )
    from lit_llama_ja_tpu_torch.parallel.specs import unshard_leaf
    from lit_llama_ja_tpu_torch.train.step import AdamW, init_opt_state

    mesh = _mesh(dict(fsdp=1, ep=world))
    local = shard_params_ep(params, mesh)
    logits, aux = forward_moe_ep(local, idx, cfg, mesh, device="cpu")
    opt = AdamW(lr, weight_decay=1e-4, beta2=0.999, grad_clip=None)
    step = make_moe_train_step_ep(cfg, opt, mesh, device="cpu").jit_with(local)
    local, _, loss = step(local, init_opt_state(opt, local), batch)

    def gathered(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: gathered(v, f"{prefix}{k}/") for k, v in tree.items()}
        return unshard_leaf(tree, ep_spec_of(prefix[:-1]), mesh)

    return {"logits": logits, "aux": aux, "loss": loss, "params": gathered(local),
            "local_fc1": torch.tensor(local["blocks"]["moe"]["c_fc1"]["weight"].shape)}


def moe_routing(rank, world, params, cfg, batch, meshes, lr):
    """For each batch mesh: the routing statistics of `forward_moe` on this rank's rows
    of ``batch[0]`` (averaged over the batch ranks), then one sharded MoE AdamW step on
    the whole batch; its loss and the gathered parameters."""
    from lit_llama_ja_tpu_torch.models.moe import forward_moe, make_moe_train_step
    from lit_llama_ja_tpu_torch.parallel.specs import gather_params, shard_params
    from lit_llama_ja_tpu_torch.train.step import init_opt_state, local_rows, make_adamw

    out = {}
    for m, dims in enumerate(meshes):
        mesh = _mesh(dims)
        local = shard_params(params, mesh)
        rows = local_rows(batch[0], mesh, dim=0)
        _, aux = forward_moe(local, rows[:, :-1], cfg, device="cpu", mesh=mesh)
        opt = make_adamw(lambda _: lr, grad_clip=0.5)
        step = make_moe_train_step(cfg, opt, device="cpu", mesh=mesh)
        local, _, loss = step(local, init_opt_state(opt, local), batch)
        out[m] = {"dropped": aux["dropped"], "loss": loss, "params": gather_params(local, mesh)}
    return out


def pipeline_runs(rank, world, params, cfg, idx, batch, meshes, n_steps, lr):
    """For each mesh (a ``pp`` axis, with ``dp`` or ``tp``): `pipeline_forward`'s logits
    (and with ``remat`` on the first mesh), then ``n_steps`` `make_pp_train_step` AdamW
    steps (clip 0.5); the losses and the gathered parameters."""
    from lit_llama_ja_tpu_torch.parallel.pipeline import (
        PP_PARAM_RULES,
        make_pp_train_step,
        pipeline_forward,
        shard_params_pp,
    )
    from lit_llama_ja_tpu_torch.parallel.specs import gather_params
    from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw

    out = {}
    for m, dims in enumerate(meshes):
        mesh = _mesh(dims)
        local = shard_params_pp(params, mesh)
        out[f"{m}/logits"] = pipeline_forward(local, idx, cfg, mesh, device="cpu")
        if m == 0:
            out[f"{m}/remat"] = pipeline_forward(local, idx, cfg, mesh, remat=True,
                                                 device="cpu")
        opt = make_adamw(lambda _: lr, grad_clip=0.5)
        state = init_opt_state(opt, local)
        step = make_pp_train_step(cfg, opt, mesh, remat=m == 0, device="cpu").jit_with(local)
        losses = []
        for _ in range(n_steps):
            local, state, loss = step(local, state, batch)
            losses.append(loss)
        out[f"{m}/loss"] = torch.stack(losses)
        out[f"{m}/params"] = gather_params(local, mesh, PP_PARAM_RULES)
        out[f"{m}/blocks_rows"] = local["blocks"]["rms_1"]["scale"].shape[0]
    return out


def pp_decode_runs(rank, world, params, cfg, setup, engine_cases, meshes, root, tiny, serve):
    """For each pipeline mesh (``meshes``: name -> (dims, n_micro)): from ``setup``'s
    prefilled pools (one rank's), the fused decode step (and six chained greedy steps,
    and a sampled step), the two-dispatch read and commit, and the fused and two-dispatch
    prefills; then the engine cases (name -> (mesh name, engine kwargs, requests, run
    kwargs, prefix)), and `serve_cli.main` with ``serve`` on rank 0's print. This
    stage's pools come back (its layers, its heads)."""
    from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
    from lit_llama_ja_tpu_torch.parallel.pipeline import shard_params_pp
    from lit_llama_ja_tpu_torch.parallel.pp_decode import (
        make_pp_commit,
        make_pp_decode_read,
        make_pp_decode_step,
        make_pp_prefill,
        make_pp_prefill_read,
        shard_pool_pp,
    )

    out, built = {}, {}
    for name, (dims, n_micro) in meshes.items():
        mesh = built[name] = _mesh(dims)
        if dims.get("tp", 1) > 1:
            continue

        def local(pool, mesh=mesh):
            return shard_pool_pp(pool, mesh)

        lp = shard_params_pp(params, mesh)
        for kv, (pool, tables, pos, cur) in setup["decode"].items():
            temps = torch.zeros(len(cur))
            gen = torch.Generator().manual_seed(7)
            step = make_pp_decode_step(cfg, mesh, n_micro=n_micro, quantized=kv, device="cpu")
            tok, p = step(lp, cur, pos, tables, local(pool), gen, temps)
            out[f"{name}/{kv}/fused"] = (tok, p)
            read = make_pp_decode_read(cfg, mesh, n_micro=n_micro, quantized=kv, device="cpu")
            tok, w, pi, of = read(lp, cur, pos, tables, local(pool), gen, temps)
            out[f"{name}/{kv}/split"] = (tok, make_pp_commit(mesh)(local(pool), w, pi, of))
            p, c, ps, toks = local(pool), torch.as_tensor(cur), torch.as_tensor(pos), []
            for i in range(6):
                c, p = step(lp, c, ps, tables, p, torch.Generator().manual_seed(i), temps)
                ps = ps + 1
                toks.append(c)
            out[f"{name}/{kv}/chain"] = torch.stack(toks)
            sampled = step(lp, cur, pos, tables, local(pool),
                           torch.Generator().manual_seed(0), torch.full((len(cur),), 0.8),
                           top_k=20, top_p=0.9)[0]
            out[f"{name}/{kv}/sampled"] = sampled
        for kv, (pool, toks, pos, tables) in setup["prefill"].items():
            fused = make_pp_prefill(cfg, mesh, quantized=kv, device="cpu")
            out[f"{name}/{kv}/prefill"] = fused(lp, toks, pos, tables, local(pool))
            read = make_pp_prefill_read(cfg, mesh, quantized=kv, device="cpu")
            lg, w, pi, of = read(lp, toks, pos, tables, local(pool))
            out[f"{name}/{kv}/prefill_split"] = (lg, make_pp_commit(mesh)(local(pool), w,
                                                                          pi, of))
    for name, (mesh_name, kw, requests, run_kw, prefix) in engine_cases.items():
        mesh = built[mesh_name]
        eng = PagedEngine(params, cfg, pp_mesh=mesh, pp_microbatches=meshes[mesh_name][1],
                          device="cpu", **kw)
        if prefix is not None:
            run_kw = dict(run_kw, prefix_id=eng.register_prefix(prefix))
        res = eng.run(requests, **run_kw)
        out[f"engine/{name}"] = ([res[i] for i in sorted(res)], eng.stats(), dict(eng.pool))
    out.update(cli_runs(rank, world, root, tiny, [("serve", serve)]) if serve else {})
    return out


def spec_round_runs(rounds, tparams, dparams, dcfg, pool, toks, pos, tables):
    """Run each of ``rounds`` (kind "chain" or "tree" -> a round with `parallel/pp_spec.
    make_pp_spec_round`'s or `make_pp_tree_round`'s contract) once on copies of
    ``pool`` and of a zero draft pool, sampled (temperature 0.8, top-k 20, top-p 0.95)
    from a generator seeded 0: ``cur`` and ``prev`` are the span's first two columns,
    the positions its first. Returns kind -> (tokens, n_out, pool, draft pool)."""
    from lit_llama_ja_tpu_torch.infer.paged import init_page_pool

    cur, prev = torch.as_tensor(toks[:, 0]), torch.as_tensor(toks[:, 1])
    p0, tabs = torch.as_tensor(pos[:, 0]), torch.as_tensor(tables)
    out = {}
    for kind, rnd in rounds.items():
        tpool = {k: v.clone() for k, v in pool.items()}
        dpool = init_page_pool(dcfg, pool["k"].shape[1], pool["k"].shape[3], device="cpu")
        lead = (prev, cur) if kind == "chain" else (cur,)
        with torch.no_grad():
            tokens, n_out = rnd(tparams, dparams, *lead, p0, tabs, tpool, dpool,
                                torch.Generator().manual_seed(0), torch.full((len(cur),), 0.8),
                                top_k=20, top_p=0.95)
        out[kind] = (tokens, n_out, tpool, dpool)
    return out


def page_coords_of(tables, pos, page):
    """`infer/paged.page_coords` of numpy tables and positions."""
    from lit_llama_ja_tpu_torch.infer.paged import page_coords

    return page_coords(torch.as_tensor(tables), torch.as_tensor(pos), page)


def _spec_engine(kind, params, cfg, draft, **kw):
    """A chain (``kind`` "chain") or tree speculative engine over ``draft = (params,
    config)``, on the CPU."""
    from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
    from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine

    cls = TreeSpeculativePagedEngine if kind == "tree" else SpeculativePagedEngine
    return cls(params, cfg, draft_params=draft[0], draft_config=draft[1], device="cpu", **kw)


def mesh_engine_runs(rank, world, params, cfg, drafts, cases, meshes, cli=None, verify=None):
    """The speculative and stripe engines on meshes. ``meshes``: name -> (dims, n_micro);
    a mesh with a ``pp`` axis goes to the engine as ``pp_mesh`` (n_micro micro-groups)
    with the whole tree, any other as ``mesh`` with this rank's `shard_params` slices.
    ``cases``: name -> (mesh name, kind ("chain", "tree" or "stripe"), engine kwargs,
    draft name in ``drafts``, requests, run kwargs). Returns for each case the token
    streams, `stats()` and this rank's caches, and under ``freed/<case>`` whether the
    engine was freed by its last reference, with the collector off; then
    `cli_runs(rank, world, *cli)`.
    ``verify = (pool, toks, pos, tables)`` (one rank's pool, a (B, T) span): on each
    pipeline mesh without ``tp``, `pp_spec.make_pp_verify`'s logits and this stage's pool
    through the fused route and through the deferred one with `make_pp_commit`, and
    `spec_round_runs` of `make_pp_spec_round` (K 3) and `make_pp_tree_round` ((2, 2))
    with ``drafts["draft"]``."""
    from lit_llama_ja_tpu_torch.infer.serving import Engine
    from lit_llama_ja_tpu_torch.parallel.pipeline import shard_params_pp
    from lit_llama_ja_tpu_torch.parallel.pp_decode import make_pp_commit, shard_pool_pp
    from lit_llama_ja_tpu_torch.parallel.pp_spec import (
        make_pp_spec_round,
        make_pp_tree_round,
        make_pp_verify,
    )
    from lit_llama_ja_tpu_torch.parallel.specs import shard_params

    built = {name: _mesh(dims) for name, (dims, _) in meshes.items()}
    out = {}
    for name, (dims, n_micro) in meshes.items():
        if verify is None or "pp" not in dims or dims.get("tp", 1) > 1:
            continue
        mesh, (pool, toks, pos, tables) = built[name], verify
        lp, T = shard_params_pp(params, mesh), toks.shape[1]
        for defer in (False, True):
            fn = make_pp_verify(cfg, mesh, T=T, n_micro=n_micro, defer_commit=defer,
                                device="cpu")
            with torch.no_grad():
                logits, got = fn(lp, toks, pos, tables, shard_pool_pp(pool, mesh))
            if defer:
                page_idx, offs = page_coords_of(tables, pos, pool["k"].shape[3])
                got = make_pp_commit(mesh)(shard_pool_pp(pool, mesh), got, page_idx, offs)
            out[f"verify/{name}/{defer}"] = (logits, got)
        dparams, dcfg = drafts["draft"]
        rounds = {"chain": make_pp_spec_round(cfg, dcfg, mesh, K=3, n_micro=n_micro,
                                              device="cpu"),
                  "tree": make_pp_tree_round(cfg, dcfg, mesh, branching=(2, 2),
                                             n_micro=n_micro, device="cpu")}
        out[f"rounds/{name}"] = spec_round_runs(rounds, lp, dparams, dcfg,
                                                shard_pool_pp(pool, mesh), toks, pos, tables)
    for name, (mesh_name, kind, kw, draft, requests, run_kw) in cases.items():
        mesh, n_micro = built[mesh_name], meshes[mesh_name][1]
        if "pp" in mesh.shape:
            local, where = params, dict(pp_mesh=mesh, pp_microbatches=n_micro)
        else:
            local, where = shard_params(params, mesh), dict(mesh=mesh)
        if kind == "stripe":
            eng = Engine(local, cfg, device="cpu", **where, **kw)
        else:
            eng = _spec_engine(kind, local, cfg, drafts[draft], **where, **kw)
        res = eng.run(requests, **run_kw)
        caches = ({"cache": eng.cache} if kind == "stripe"
                  else {"pool": eng.pool, "dpool": eng.dpool})
        out[name] = ([res[i] for i in sorted(res)], eng.stats(), caches)
        gone = weakref.ref(eng)
        gc.disable()  # the engine must go with its last reference, not at a collection
        del eng
        out[f"freed/{name}"] = gone() is None
        gc.enable()
    out.update(cli_runs(rank, world, *cli) if cli else {})
    return out


def sft_setup(variant, cfg, mesh=None):
    """``(trainable predicate, forward_fn)`` of an SFT variant (``"full"``, ``"lora"``,
    ``"adapter"``, ``"adapter_v2"``), as the finetune CLI builds them."""
    from lit_llama_ja_tpu_torch.models import adapter, lora

    if variant == "full":
        return None, None
    if variant == "lora":
        return lora.lora_trainable, None
    pred = adapter.adapter_v2_trainable if variant == "adapter_v2" else adapter.adapter_trainable
    return pred, lambda p, x: adapter.adapter_forward(p, x, cfg, device="cpu", mesh=mesh)


def sft_steps(tree, cfg, variant, dropout, batch, n_steps, lr, mesh=None):
    """``n_steps`` `make_sft_train_step` AdamW steps on ``tree`` (this rank's slices on a
    mesh), the dropout from a generator seeded 3; the losses and the tree."""
    from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw, make_sft_train_step

    pred, fwd = sft_setup(variant, cfg, mesh)
    opt = make_adamw(lambda _: lr, weight_decay=0.01)
    state = init_opt_state(opt, tree, trainable_pred=pred)
    step = make_sft_train_step(cfg, opt, forward_fn=fwd, trainable_pred=pred,
                               lora_dropout=dropout, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(3)
    losses = []
    for _ in range(n_steps):
        tree, state, loss = step(tree, state, batch, gen)
        losses.append(loss)
    return torch.stack(losses), tree


def finetune_cli_runs(runs):
    """Run the finetune CLIs: ``runs`` maps a name to ``(main's name, kwargs)``; each
    run's step losses, recorded around `make_sft_train_step`."""
    from unittest import mock

    from lit_llama_ja_tpu_torch.cli import finetune_cli
    from lit_llama_ja_tpu_torch.train import step as step_mod

    make = step_mod.make_sft_train_step
    out = {}
    for name, (main, kw) in runs.items():
        losses = []

        def recording(*a, **k):
            fn = make(*a, **k)

            def run(*b, **kb):
                res = fn(*b, **kb)
                losses.append(res[2])
                return res
            return run

        with mock.patch.object(step_mod, "make_sft_train_step", recording):
            getattr(finetune_cli, main)(**kw)
        out[name] = torch.stack(losses)
    return out


def mesh_finetune_runs(rank, world, cases, batch, meshes, n_steps, lr, cli=None):
    """For each mesh and each case ``name -> (tree, cfg, variant, dropout)``: the
    sharded SFT steps' losses, the gathered tree, and this rank's replicated leaves
    (spec ``P()``); then `finetune_cli_runs(cli)`."""
    from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
    from lit_llama_ja_tpu_torch.parallel.specs import gather_params, shard_params, spec_of

    out = {}
    for m, dims in enumerate(meshes):
        mesh = _mesh(dims)
        for name, (tree, cfg, variant, dropout) in cases.items():
            losses, local = sft_steps(shard_params(tree, mesh), cfg, variant, dropout, batch,
                                      n_steps, lr, mesh)
            out[f"{m}/{name}"] = {
                "loss": losses, "params": gather_params(local, mesh),
                "replicated": {k: v for k, v in flatten_tree(local).items() if spec_of(k) == ()}}
    out["cli"] = finetune_cli_runs(cli) if cli else {}
    if cli:
        from lit_llama_ja_tpu_torch.cli import finetune_cli

        main, kw = next(iter(cli.values()))
        try:
            getattr(finetune_cli, main)(**{**kw, "micro_batch_size": 1, "tp": 1, "fsdp": 2})
        except ValueError as e:
            out["cli_error"] = str(e)
    return out


def dyn_choices(tree, cfg, idx, mesh=None):
    """The candidate outlier columns that llm.int8-dyn picks in each linear of one
    forward, in call order (the live ones among them follow from the same peaks)."""
    from unittest import mock

    from lit_llama_ja_tpu_torch.models.llama import forward
    from lit_llama_ja_tpu_torch.quant import linear

    real, seen = linear._top_k_indices, []

    def recording(v, k):
        out = real(v, k)
        seen.append(torch.stack([out, (v[out] > 6.0).long()]))
        return out

    with mock.patch.object(linear, "_top_k_indices", recording):
        forward(tree, idx, cfg, device="cpu", mesh=mesh)
    return seen


def mesh_quant_runs(rank, world, trees, idx, prompt, meshes):
    """For each mesh and each quantized tree ``name -> (tree, cfg)``: the sharded
    forward's logits and the greedy tokens of `generate` (bf16 cache); for the
    llm.int8-dyn tree ``"dyn"``, `dyn_choices` too."""
    from lit_llama_ja_tpu_torch.infer.generate import generate
    from lit_llama_ja_tpu_torch.models.llama import forward
    from lit_llama_ja_tpu_torch.parallel.specs import shard_params

    out = {}
    for m, dims in enumerate(meshes):
        mesh = _mesh(dims)
        for name, (tree, cfg) in trees.items():
            local = shard_params(tree, mesh)
            out[f"{m}/{name}/logits"] = forward(local, idx, cfg, device="cpu", mesh=mesh)
            out[f"{m}/{name}/generate"] = torch.as_tensor(generate(
                local, cfg, prompt, 6, temperature=0.0, device="cpu", mesh=mesh))
            if name == "dyn":
                out[f"{m}/dyn/choices"] = dyn_choices(local, cfg, idx, mesh)
    return out


def mesh_quant_cli(rank, world, trees, idx, prompt, meshes, root, tiny, runs):
    """`mesh_quant_runs`, then `cli_runs(rank, world, root, tiny, runs)`."""
    out = mesh_quant_runs(rank, world, trees, idx, prompt, meshes)
    out.update(cli_runs(rank, world, root, tiny, runs))
    return out


def ring_backward(rank, world, q, k, v, ct, params, cfg, idx, ring_cases):
    """The gradients of the sequence-parallel paths over a tp axis of every rank:
    `ring_attention`'s dq, dk, dv of this rank's slices for the cotangent ``ct`` (f32
    and bf16); `forward_sp`'s parameter gradients (this rank's partial sums) of the
    next-token loss on ``idx``, both impls, and its logits under ``torch.no_grad()`` and
    with gradients; then `ring_quant_matmul` (the overlapped hops) on an fsdp axis beside
    the same hops run one after the other, and the bytes `RING_COPY` counted in the
    calls."""
    from lit_llama_ja_tpu_torch.parallel.collective_matmul import (
        RING_COPY,
        k_shard,
        ring_quant_matmul,
    )
    from lit_llama_ja_tpu_torch.parallel.mesh import Mesh
    from lit_llama_ja_tpu_torch.parallel.ring_attention import ring_attention
    from lit_llama_ja_tpu_torch.parallel.sp_forward import forward_sp
    from lit_llama_ja_tpu_torch.quant.linear import quant_matmul
    from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss

    mesh = _mesh(dict(fsdp=1, tp=world))
    Tl = q.shape[2] // world
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        mine = [t[:, :, rank * Tl:(rank + 1) * Tl].to(dtype).requires_grad_() for t in (q, k, v)]
        y = ring_attention(*mine, mesh)
        (y.float() * ct[:, :, rank * Tl:(rank + 1) * Tl]).sum().backward()
        tag = "" if dtype == torch.float32 else "_bf16"
        out.update({f"d{n}{tag}": t.grad for n, t in zip("qkv", mine)})

    def leaves(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", val

    for impl in ("allgather", "ring"):
        with torch.no_grad():
            out[f"logits_nograd_{impl}"] = forward_sp(params, idx, cfg, mesh, attn_impl=impl,
                                                      device="cpu")
        p = {}
        for name, t in leaves(params):
            node = p
            *path, last = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[last] = t.detach().clone().requires_grad_()
        logits = forward_sp(p, idx, cfg, mesh, attn_impl=impl, device="cpu")
        out[f"logits_grad_{impl}"] = logits.detach()
        cross_entropy_loss(logits[:, :-1], idx[:, 1:]).backward()
        out[f"grads_{impl}"] = {name: t.grad for name, t in leaves(p)}

    fsdp = _mesh(dict(fsdp=world, tp=1))
    for name, (x, qp, K) in ring_cases.items():
        shard = k_shard(qp, K, fsdp)
        before = RING_COPY["bytes"]
        out[f"ring_{name}"] = ring_quant_matmul(x, shard, fsdp, axis="fsdp",
                                                grouped=qp["scales"].shape[0] > 1)
        out[f"ring_copy_{name}"] = RING_COPY["bytes"] - before
        K_loc, y = K // world, None
        for i in range(world):  # the same hops, one after the other
            k_idx = (rank + i) % world
            blocks = k_shard(qp, K, Mesh({"dp": 1, "fsdp": world, "tp": 1}, k_idx,
                                         distributed=False))
            part = quant_matmul(x[:, k_idx * K_loc:(k_idx + 1) * K_loc],
                                {key: blocks[key][rank] for key in blocks}).float()
            y = part if y is None else y + part
        out[f"sequential_{name}"] = y.to(x.dtype)
    return out
