"""The port's speculative engines and its stripe engine on a ``(1, fsdp, tp)`` mesh of gloo
ranks on the CPU: `SpeculativePagedEngine(mesh=)` and `TreeSpeculativePagedEngine(mesh=)`
(the target sharded, the draft whole on every rank) and `Engine(mesh=)` at tp 2, fsdp 2
and, on 4 ranks, fsdp 2 × tp 2; and `serve_cli` with a draft (chain and tree) and with
``--paged false`` on those meshes.

Oracles: the port's one-rank engine on the same tree, requests and seed (token streams
and `stats()` equal; at fsdp, where each rank gathers the whole weights, the caches equal
in bits too, and the sampled streams equal); the JAX package's single-mesh stripe
`Engine` greedily; the one-rank CLI's printed requests (rank 0 prints, the others print
nothing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import _spec_engine, cli_runs, mesh_engine_runs, spawn
from torch_port_helpers import random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer.serving import Engine as JEngine

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.serving import Engine
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint

TCFG = dict(block_size=96, vocab_size=64, n_layer=4, n_head=4, n_embd=32)
DCFG = dict(block_size=96, vocab_size=64, n_layer=1, n_head=2, n_embd=16)
KW = dict(max_batch=4, n_pages=64, page_size=4)
MESHES = {2: {"tp2": (dict(fsdp=1, tp=2), 1), "fsdp2": (dict(fsdp=2, tp=1), 1)},
          4: {"fsdp2_tp2": (dict(fsdp=2, tp=2), 1)}}
TINY = dict(block_size=16, vocab_size=256, n_layer=2, n_head=4, n_embd=32)
TINY_DRAFT = dict(block_size=16, vocab_size=256, n_layer=1, n_head=2, n_embd=16)
SERVE = dict(tokenizer_path="unused", prompt="osaka", n_requests=2, max_new_tokens=6,
             max_seq_length=32, temperature=0.0, quantize_kv="int8", draft_k=3, device="cpu")
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)


def _tree(cfg, seed):
    c = JConfig(**cfg)
    return random_tree(np.random.default_rng(seed), c.n_layer, c.n_embd, c.n_hidden,
                       c.padded_vocab_size, std=0.3)


def _cases(rng):
    """name -> (mesh name, kind, engine kwargs, draft, requests, run kwargs)."""
    three = [(rng.integers(0, TCFG["vocab_size"], (n,)).astype(np.int32), 10) for n in (5, 9, 3)]
    chain, tree, stripe = dict(KW, draft_k=3), dict(KW, tree=(2, 2)), dict(max_batch=2)
    out = {}
    for m in ("tp2", "fsdp2", "fsdp2_tp2"):
        out[f"chain/{m}"] = (m, "chain", chain, "draft", three, {})
        out[f"tree/{m}"] = (m, "tree", dict(tree, quantize_kv="int8"), "draft", three, {})
        out[f"self/{m}"] = (m, "chain", dict(chain, quantize_kv="int8"), "self", three, {})
        for kv in (False, "int8"):
            out[f"stripe_{kv}/{m}"] = (m, "stripe", dict(stripe, quantize_kv=kv), None, three,
                                       {})
    out["chain_sampled/fsdp2"] = ("fsdp2", "chain", dict(chain, seed=3), "draft", three, SAMPLED)
    out["tree_sampled/fsdp2"] = ("fsdp2", "tree", dict(tree, seed=4), "draft", three, SAMPLED)
    return out


def _world(mesh_name):
    return 2 if mesh_name in MESHES[2] else 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs, as each spawned rank has: the
    one-rank engines run many small ops, which contend with the other test workers for
    the cores when every op fans out over all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, dtree = _tree(TCFG, 21), _tree(DCFG, 22)
    params, cfg = to_port(tree), LLaMAConfig(**TCFG)
    drafts = {"draft": (to_port(dtree), LLaMAConfig(**DCFG)), "self": (params, cfg)}
    cases = _cases(np.random.default_rng(23))
    root = tmp_path_factory.mktemp("mesh_serving")
    from lit_llama_ja_tpu_torch.core import config as tconfig

    crng = np.random.default_rng(1)
    for name, c in (("target", TINY), ("draft", TINY_DRAFT)):
        ccfg = tconfig.LLaMAConfig(**c)
        ctree = to_port(random_tree(crng, c["n_layer"], c["n_embd"], ccfg.n_hidden, 256,
                                    std=0.05))
        for key in ("wte", "lm_head"):  # a less uniform next-token distribution
            ctree[key]["weight"] = ctree[key]["weight"] * 5
        save_checkpoint(root / name, ctree, ccfg)
    serve = dict(SERVE, checkpoint_path=str(root / "target"))
    spec = dict(serve, draft_checkpoint_path=str(root / "draft"))
    one = {"chain": spec, "tree": dict(spec, draft_tree="2,2"), "stripe": dict(serve, paged=False)}
    clis = {2: [("serve-chain-tp", dict(one["chain"], tp=2)),
                ("serve-tree-tp", dict(one["tree"], tp=2)),
                ("serve-chain-fsdp", dict(one["chain"], fsdp=2)),
                ("serve-stripe-tp", dict(one["stripe"], tp=2)),
                ("serve-stripe-fsdp", dict(one["stripe"], fsdp=2)),
                ("serve-stripe-pp", dict(one["stripe"], pp_stages=2))],
            4: [("serve-tree-fsdp-tp", dict(one["tree"], fsdp=2, tp=2)),
                ("serve-stripe-fsdp-tp", dict(one["stripe"], fsdp=2, tp=2))]}
    ranks = {}
    for w in (2, 4):
        wcases = {k: v for k, v in cases.items() if v[0] in MESHES[w]}
        ranks[w] = spawn(mesh_engine_runs, w, root, params, cfg, drafts, wcases, MESHES[w],
                         (str(root), TINY, clis[w]),
                         # the JAX engines compile while the 2 ranks run
                         meanwhile=(lambda: _jax_stripe(tree, cases)) if w == 2 else None)
    ranks[2], jax_tokens = ranks[2]
    single = cli_runs(0, 1, str(root), TINY, [(f"serve-{k}", v) for k, v in one.items()])
    return tree, params, cfg, drafts, cases, ranks, single, jax_tokens


def _jax_stripe(tree, cases):
    """The JAX package's stripe `Engine`, greedy, over bf16 and int8 caches, on the
    stripe cases' requests (the same on every mesh)."""
    jt, out = jax.tree.map(jnp.asarray, tree), {}
    for kv in (False, "int8"):
        _, _, kw, _, requests, _ = cases[f"stripe_{kv}/tp2"]
        res = JEngine(jt, JConfig(**TCFG), max_batch=kw["max_batch"],
                      quantize_kv=bool(kv)).run(requests)
        out[kv] = [res[i].tolist() for i in sorted(res)]
    return out


def _one_rank(params, cfg, drafts, case):
    _, kind, kw, draft, requests, run_kw = case
    if kind == "stripe":
        eng = Engine(params, cfg, device="cpu", **kw)
    else:
        eng = _spec_engine(kind, params, cfg, drafts[draft], **kw)
    res = eng.run(requests, **run_kw)
    return [res[i].tolist() for i in sorted(res)], eng


def _check_case(runs, name):
    """The ranks' streams and stats against one rank's; at fsdp alone the caches too."""
    _, params, cfg, drafts, cases, ranks, *_ = runs
    case = cases[name]
    want, eng = _one_rank(params, cfg, drafts, case)
    for r, out in enumerate(ranks[_world(case[0])]):
        toks, stats, caches = out[name]
        assert [t.tolist() for t in toks] == want, (name, r)
        assert stats == eng.stats(), (name, r)
        if case[0] == "fsdp2":
            ones = {"cache": eng.cache} if case[1] == "stripe" else {"pool": eng.pool,
                                                                      "dpool": eng.dpool}
            for kind, cache in ones.items():
                for key in cache:
                    torch.testing.assert_close(caches[kind][key], cache[key], rtol=0, atol=0,
                                               msg=f"{name} {kind} {key}")
    return want


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2", "fsdp2_tp2"])
@pytest.mark.parametrize("kind", ["chain", "tree", "self"])
def test_spec_engines_on_a_tp_mesh_match_one_rank(runs, kind, mesh):
    """Both speculative engines honour ``mesh=``: the target's verify runs on this rank's
    slices and heads (the chain over an fp pool, the tree over an int8 pool, the
    self-draft chain over an int8 pool), the draft whole, and every rank emits the one-rank
    engine's tokens with its stats."""
    _check_case(runs, f"{kind}/{mesh}")


@pytest.mark.parametrize("kind", ["chain_sampled", "tree_sampled"])
def test_spec_engines_on_fsdp_sample_as_one_rank(runs, kind):
    """Sampled at fsdp 2 from the same seed: the one-rank engine's streams and caches."""
    _check_case(runs, f"{kind}/fsdp2")


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2", "fsdp2_tp2"])
@pytest.mark.parametrize("kv", [False, "int8"], ids=["bf16", "int8"])
def test_stripe_engine_on_a_mesh_matches_one_rank_and_jax(runs, kv, mesh):
    """`Engine(mesh=)` over bf16 and int8 caches of this rank's heads: the one-rank
    engine's streams and stats, and the JAX package's `Engine` greedily."""
    want = _check_case(runs, f"stripe_{kv}/{mesh}")
    assert want == runs[-1][kv]


def test_stripe_engine_refuses_a_pipeline_or_dp_mesh():
    from lit_llama_ja_tpu_torch.parallel.mesh import Mesh

    params, cfg = to_port(_tree(TCFG, 21)), LLaMAConfig(**TCFG)
    for shape in ({"dp": 2, "fsdp": 1, "tp": 1}, {"dp": 1, "fsdp": 1, "tp": 1, "pp": 2}):
        with pytest.raises(ValueError, match=r"\(1, fsdp, tp\) mesh"):
            Engine(params, cfg, device="cpu", mesh=Mesh(shape, rank=0, distributed=False))


@pytest.mark.parametrize("name,world,one", [
    ("serve-chain-tp", 2, "serve-chain"), ("serve-tree-tp", 2, "serve-tree"),
    ("serve-chain-fsdp", 2, "serve-chain"), ("serve-stripe-tp", 2, "serve-stripe"),
    ("serve-stripe-fsdp", 2, "serve-stripe"), ("serve-stripe-pp", 2, "serve-stripe"),
    ("serve-tree-fsdp-tp", 4, "serve-tree"), ("serve-stripe-fsdp-tp", 4, "serve-stripe")])
def test_serve_cli_on_a_mesh_matches_one_rank(runs, name, world, one):
    """``serve_cli`` with a draft at ``--tp 2``, ``--fsdp 2`` and ``--fsdp 2 --tp 2``
    (chain and ``--draft-tree 2,2``), and ``--paged false`` at those meshes and at
    ``--pp-stages 2`` (the stripe engine whole on every rank): rank 0 prints the one-rank
    CLI's requests, the other ranks nothing."""
    ranks, single = runs[5:7]
    assert "--- request 1 ---" in single[one]
    assert ranks[world][0][name] == single[one]
    assert all(out[name] == "" for out in ranks[world][1:])
