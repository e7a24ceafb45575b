"""The port's speculative serving over a pipeline (`lit_llama_ja_tpu_torch/parallel/pp_spec.py`,
`SpeculativePagedEngine(pp_mesh=)`, `TreeSpeculativePagedEngine(pp_mesh=)`, `serve_cli
--pp-stages` with a draft) on gloo ranks on the CPU, mirroring tests/test_pp_spec.py at
its tiny config: the chain at (pp 2, 2 micro-groups) and (pp 4, 2), over fp, int8 and
int4 pools, with adaptive K and sampled; the tree (2, 2) at pp 2 and (3, 1) at pp 4, on
an int8 pool and with ``pp_split=False``; both at pp 2 × tp 2; a self-draft (the target
drafting for itself) whose rounds are accepted whole across page boundaries; and the
CLI at pp 2 (chain and tree) and pp 2 × tp 2.

Oracles: the port's one-rank engine on the same tree, requests and seed: token streams
and `stats()` equal (greedy and sampled: every rank draws what one rank draws), each
stage's pool pages ``[:, 1:]`` equal in bits to its slice of the one-rank pool, and the
replicated draft pool equal to the one-rank draft pool (without tp: tp sums the
row-parallel products in another order); greedy, the plain one-rank `PagedEngine` and the
JAX package's single-mesh engines (tokens equal). The JAX pipeline programs are not run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import _spec_engine, cli_runs, mesh_engine_runs, spawn, spec_round_runs
from torch_port_helpers import random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer.spec_serving import SpeculativePagedEngine as JSpec
from lit_llama_ja_tpu.infer.tree_spec import TreeSpeculativePagedEngine as JTree

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.paged import (
    PagedEngine,
    commit_writes,
    init_page_pool,
    paged_forward,
    paged_forward_read,
)
from lit_llama_ja_tpu_torch.infer.spec_serving import _batched_spec_round
from lit_llama_ja_tpu_torch.infer.tree_spec import _tree_spec_round
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh
from lit_llama_ja_tpu_torch.parallel.pp_decode import shard_pool_pp

TCFG = dict(block_size=96, vocab_size=64, n_layer=4, n_head=4, n_embd=32)
DCFG = dict(block_size=96, vocab_size=64, n_layer=1, n_head=2, n_embd=16)
KW = dict(max_batch=4, n_pages=64, page_size=4)
MESHES = {2: {"pp2_m2": (dict(fsdp=1, pp=2), 2)},
          4: {"pp4_m2": (dict(fsdp=1, pp=4), 2), "pp2_tp2": (dict(fsdp=1, tp=2, pp=2), 2)}}
TINY = dict(block_size=16, vocab_size=256, n_layer=2, n_head=4, n_embd=32)
TINY_DRAFT = dict(block_size=16, vocab_size=256, n_layer=1, n_head=2, n_embd=16)
SERVE = dict(tokenizer_path="unused", prompt="osaka", n_requests=2, max_new_tokens=6,
             max_seq_length=32, temperature=0.0, quantize_kv="int8", draft_k=3, device="cpu")
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)


def _tree(cfg, seed):
    c = JConfig(**cfg)
    return random_tree(np.random.default_rng(seed), c.n_layer, c.n_embd, c.n_hidden,
                       c.padded_vocab_size, std=0.3)


def _requests(rng, lengths, new):
    return [(rng.integers(0, TCFG["vocab_size"], (n,)).astype(np.int32), new) for n in lengths]


def _cases(rng):
    """name -> (mesh name, kind, engine kwargs, draft, requests, run kwargs)."""
    three, two = _requests(rng, (5, 9, 3), 12), _requests(rng, (5, 9), 10)
    chain, tree = dict(KW, draft_k=3), dict(KW, tree=(2, 2))
    return {
        "chain": ("pp2_m2", "chain", chain, "draft", three, {}),
        "chain_int8": ("pp2_m2", "chain", dict(chain, quantize_kv="int8"), "draft", three, {}),
        "chain_int4": ("pp2_m2", "chain", dict(chain, quantize_kv="int4"), "draft", three, {}),
        "chain_adaptive": ("pp2_m2", "chain", dict(KW, draft_k=4, adaptive_k=True, k_min=1),
                           "draft", _requests(rng, (5, 5), 16), {}),
        "chain_sampled": ("pp2_m2", "chain", dict(chain, seed=3), "draft", three, SAMPLED),
        "self": ("pp2_m2", "chain", chain, "self", _requests(rng, (6, 3, 7, 10), 14), {}),
        "tree": ("pp2_m2", "tree", tree, "draft", three, {}),
        "tree_int8": ("pp2_m2", "tree", dict(tree, quantize_kv="int8"), "draft", three, {}),
        "tree_fused": ("pp2_m2", "tree", dict(tree, pp_split=False), "draft", three, {}),
        "tree_sampled": ("pp2_m2", "tree", dict(tree, seed=5), "draft", three, SAMPLED),
        # one short request: few attend widths, so few JAX programs to compile
        "chain_jax": ("pp2_m2", "chain", chain, "draft", _requests(rng, (5,), 8), {}),
        "tree_jax": ("pp2_m2", "tree", tree, "draft", _requests(rng, (5,), 8), {}),
        "chain_pp4": ("pp4_m2", "chain", chain, "draft", three, {}),
        "tree_pp4": ("pp4_m2", "tree", dict(KW, tree=(3, 1)), "draft", three, {}),
        "chain_tp": ("pp2_tp2", "chain", chain, "draft", two, {}),
        "tree_tp": ("pp2_tp2", "tree", tree, "draft", two, {}),
    }


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
    tree, dtree = _tree(TCFG, 11), _tree(DCFG, 12)
    params, cfg = to_port(tree), LLaMAConfig(**TCFG)
    drafts = {"draft": (to_port(dtree), LLaMAConfig(**DCFG)), "self": (params, cfg)}
    cases = _cases(np.random.default_rng(13))
    root = tmp_path_factory.mktemp("pp_spec")
    from lit_llama_ja_tpu_torch.core import config as tconfig

    crng = np.random.default_rng(0)
    for name, c in (("target", TINY), ("draft", TINY_DRAFT)):
        ccfg = tconfig.LLaMAConfig(**c)
        ctree = to_port(random_tree(crng, c["n_layer"], c["n_embd"], ccfg.n_hidden, 256,
                                    std=0.05))
        for key in ("wte", "lm_head"):  # a less uniform next-token distribution
            ctree[key]["weight"] = ctree[key]["weight"] * 5
        save_checkpoint(root / name, ctree, ccfg)
    serve = dict(SERVE, checkpoint_path=str(root / "target"),
                 draft_checkpoint_path=str(root / "draft"))
    clis = {2: [("serve-chain", dict(serve, pp_stages=2)),
                ("serve-tree", dict(serve, pp_stages=2, draft_tree="2,2"))],
            4: [("serve-chain", dict(serve, pp_stages=2, tp=2))]}
    verify = _verify_setup(params, cfg, np.random.default_rng(14))
    ranks = {}
    # the JAX engines compile while the 2 ranks run
    ranks[2], jax_tokens = spawn(mesh_engine_runs, 2, root, params, cfg, drafts,
                                 {k: v for k, v in cases.items() if v[0] in MESHES[2]},
                                 MESHES[2], (str(root), TINY, clis[2]), verify,
                                 meanwhile=lambda: _jax_tokens(tree, dtree, cases))
    ranks[4] = spawn(mesh_engine_runs, 4, root, params, cfg, drafts,
                     {k: v for k, v in cases.items() if v[0] in MESHES[4]}, MESHES[4],
                     (str(root), TINY, clis[4]), verify)
    single = cli_runs(0, 1, str(root), TINY, [("serve-chain", serve),
                                             ("serve-tree", dict(serve, draft_tree="2,2"))])
    return tree, dtree, params, cfg, drafts, cases, ranks, single, verify, jax_tokens


def _jax_tokens(tree, dtree, cases):
    """The JAX package's single-mesh chain (K 3) and tree (2, 2) engines, greedy, on the
    ``*_jax`` cases' requests."""
    jt, jd = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, dtree)
    out = {}
    for kind, jcls, jkw in (("chain", JSpec, dict(draft_k=3)), ("tree", JTree, dict(tree=(2, 2)))):
        res = jcls(jt, JConfig(**TCFG), draft_params=jd, draft_config=JConfig(**DCFG), **KW,
                   **jkw).run(cases[f"{kind}_jax"][4])
        out[kind] = [res[i].tolist() for i in sorted(res)]
    return out


def _verify_setup(params, cfg, rng):
    """Four slots prefilled on one rank (lengths 6, 9, 4 and 7, an fp pool), and a
    verify span of K + 1 = 4 tokens a slot at their next positions."""
    pool = init_page_pool(cfg, KW["n_pages"], KW["page_size"], torch.bfloat16, False,
                          device="cpu")
    lengths = np.array([6, 9, 4, 7], np.int32)
    tables = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    for b, n in enumerate(lengths):
        p = rng.integers(0, TCFG["vocab_size"], (n,))
        paged_forward(params, p[None], np.arange(n)[None], tables[b:b + 1], pool, cfg, False,
                      device="cpu")
    toks = rng.integers(0, TCFG["vocab_size"], (4, 4)).astype(np.int32)
    return pool, toks, lengths[:, None] + np.arange(4, dtype=np.int32)[None], tables


def _one_rank(params, cfg, drafts, case, record=None):
    """The one-rank engine of a case, run; ``record`` collects ``(pos, n_out, K)`` of
    every decoding slot of every round."""
    _, kind, kw, draft, requests, run_kw = case
    eng = _spec_engine(kind, params, cfg, drafts[draft],
                       **{k: v for k, v in kw.items() if k != "pp_split"})
    if record is not None:
        emit = eng._emit

        def recorded(tokens, n_out, track_prev):
            for slot, req in enumerate(eng.slot_req):
                if req is not None and slot not in eng.prefilling:
                    record.append((int(eng.pos[slot]), int(n_out[slot]), eng.K))
            return emit(tokens, n_out, track_prev)

        eng._emit = recorded
    res = eng.run(requests, **run_kw)
    return [res[i].tolist() for i in sorted(res)], eng


def _stage_slice(pool, dims, rank):
    mesh = Mesh({"dp": 1, "fsdp": 1, "tp": dims.get("tp", 1), "pp": dims["pp"]}, rank=rank)
    return shard_pool_pp(pool, mesh)


def _assert_pages_equal(got, want):
    for key in want:
        torch.testing.assert_close(got[key][:, 1:], want[key][:, 1:], rtol=0, atol=0,
                                   msg=key)


def _check_case(runs, name):
    _, _, params, cfg, drafts, cases, ranks, *_ = runs
    case = cases[name]
    want, eng = _one_rank(params, cfg, drafts, case)
    dims, _ = MESHES[_world(case[0])][case[0]]
    for r, out in enumerate(ranks[_world(case[0])]):
        toks, stats, caches = out[name]
        assert [t.tolist() for t in toks] == want, (name, r)
        assert stats == eng.stats(), (name, r)
        if dims.get("tp", 1) == 1:
            _assert_pages_equal(caches["pool"], _stage_slice(eng.pool, dims, r))
            _assert_pages_equal(caches["dpool"], eng.dpool)
    return want, eng


@pytest.mark.parametrize("name", ["chain", "chain_int8", "chain_int4", "chain_pp4",
                                  "chain_tp"])
def test_pp_spec_matches_single_rank(runs, name):
    """The chain engine at pp 2 (two micro-groups) over fp, int8 and int4 pools, at pp 4
    and at pp 2 × tp 2: the one-rank engine's tokens, stats and pages."""
    _check_case(runs, name)


@pytest.mark.parametrize("name", ["tree", "tree_int8", "tree_fused", "tree_pp4", "tree_tp"])
def test_pp_tree_matches_single_rank(runs, name):
    """The tree engine, (2, 2) at pp 2 (fp and int8 pools, ``pp_split=False``), (3, 1) at
    pp 4 and (2, 2) at pp 2 × tp 2: the one-rank engine's tokens, stats and pages, the
    target's path committed by each stage into its own layers."""
    _check_case(runs, name)


@pytest.mark.parametrize("name", ["chain_sampled", "tree_sampled"])
def test_pp_spec_sampled_matches_single_rank(runs, name):
    """Temperature 0.8, top-k 20, top-p 0.95 from the same seed: every rank draws what
    one rank draws, so the sampled streams are the one-rank engine's."""
    want, _ = _check_case(runs, name)
    assert all(0 <= t < TCFG["vocab_size"] for w in want for t in w)


def test_pp_spec_adaptive_k(runs):
    """``adaptive_k`` on a pipeline: the round takes each step's K; the random draft's
    low acceptance walks K down the ladder from 4, and the streams and stats equal the
    one-rank adaptive engine's."""
    want, eng = _check_case(runs, "chain_adaptive")
    assert all(len(w) == 5 + 16 for w in want)
    assert 1 <= eng.stats()["draft_k"] < 4, eng.stats()


@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_pp_spec_greedy_matches_plain_and_jax(runs, kind):
    """Greedy pp speculation emits the plain one-rank `PagedEngine`'s tokens (three
    requests) and the JAX package's single-mesh speculative engine's (one)."""
    _, _, params, cfg, _, cases, ranks, *_ = runs
    for name in (kind, f"{kind}_jax"):
        requests = cases[name][4]
        plain = PagedEngine(params, cfg, device="cpu", **KW).run(requests)
        got = [t.tolist() for t in ranks[2][0][name][0]]
        assert got == [plain[i].tolist() for i in sorted(plain)], name
    _check_case(runs, f"{kind}_jax")
    assert got == runs[-1][kind]


def test_pp_spec_self_draft_accepts_across_pages(runs):
    """The target drafting for itself (bf16 pools on both sides): acceptance above 0.5,
    rounds that emit K + 1 tokens with their writes crossing a page, and the pipeline's
    tokens, stats and pages equal to one rank's."""
    _, _, params, cfg, drafts, cases, *_ = runs
    rounds = []
    _one_rank(params, cfg, drafts, cases["self"], record=rounds)
    want, eng = _check_case(runs, "self")
    assert eng.stats()["acceptance_rate"] > 0.5, eng.stats()
    page = KW["page_size"]
    crossing = [(p, n) for p, n, K in rounds
                if n == K + 1 and p // page != (p + K) // page]
    assert crossing, rounds


def test_pp_engines_are_freed_by_their_last_reference(runs):
    """Every engine on a pipeline (chain and tree, pp 2, pp 4 and pp 2 × tp 2) holds no
    reference to itself: dropping it frees its pools at once, without the collector."""
    _, _, _, _, _, cases, ranks, *_ = runs
    for name, case in cases.items():
        for r, out in enumerate(ranks[_world(case[0])]):
            assert out[f"freed/{name}"], (name, r)


def test_serve_cli_pp_speculative_matches_one_rank(runs):
    """``serve_cli --pp-stages 2`` with a draft (chain and ``--draft-tree 2,2``) on 2
    ranks and ``--pp-stages 2 --tp 2`` on 4 print the one-rank CLI's requests; rank 0
    prints, the other ranks print nothing."""
    ranks, single = runs[6:8]
    for name, world in (("serve-chain", 2), ("serve-tree", 2), ("serve-chain", 4)):
        assert "--- request 1 ---" in single[name]
        assert ranks[world][0][name] == single[name], (name, world)
        assert all(out[name] == "" for out in ranks[world][1:])


@pytest.mark.parametrize("world,mesh", [(2, "pp2_m2"), (4, "pp4_m2")])
def test_pp_verify_matches_paged_forward(runs, world, mesh):
    """`make_pp_verify` at the chain's verify width: fused, the logits and each stage's
    pages of the one-rank `paged_forward` in bits; with ``defer_commit``, those of
    `paged_forward_read` and `commit_writes` (the pool read, then written)."""
    _, _, params, cfg, _, _, ranks, _, (pool, toks, pos, tables), _ = runs
    fused_pool = {k: v.clone() for k, v in pool.items()}
    want_fused = paged_forward(params, toks, pos, tables, fused_pool, cfg, False, device="cpu")[0]
    read_pool = {k: v.clone() for k, v in pool.items()}
    want_read, w, pi, of = paged_forward_read(params, toks, pos, tables, read_pool, cfg, False,
                                              device="cpu")
    commit_writes(read_pool, w, pi, of)
    dims, _ = MESHES[world][mesh]
    for r, out in enumerate(ranks[world]):
        for defer, want, want_pool in ((False, want_fused, fused_pool),
                                       (True, want_read, read_pool)):
            logits, got = out[f"verify/{mesh}/{defer}"]
            torch.testing.assert_close(logits, want, rtol=0, atol=0)
            _assert_pages_equal(got, _stage_slice(want_pool, dims, r))


@pytest.mark.parametrize("world,mesh", [(2, "pp2_m2"), (4, "pp4_m2")])
def test_pp_rounds_match_one_rank_rounds(runs, world, mesh):
    """`make_pp_spec_round` (K 3) and `make_pp_tree_round` ((2, 2)), sampled, on the
    verify setup's four slots: the one-rank rounds' tokens and counts, each stage's
    pages of the one-rank target pool, and the one-rank draft pool, in bits."""
    _, _, params, cfg, drafts, _, ranks, _, (pool, toks, pos, tables), _ = runs
    dparams, dcfg = drafts["draft"]
    rounds = {
        "chain": lambda tp, dp, prev, cur, p, tabs, tpool, dpool, gen, temps, top_k, top_p:
            _batched_spec_round(tp, dp, prev, cur, p, tabs, tpool, dpool, gen, temps, cfg, dcfg,
                                3, False, top_k, top_p, "cpu"),
        "tree": lambda tp, dp, cur, p, tabs, tpool, dpool, gen, temps, top_k, top_p:
            _tree_spec_round(tp, dp, cur, p, tpool, dpool, tabs, gen, temps, cfg, dcfg, (2, 2),
                             False, top_k, top_p, "cpu"),
    }
    want = spec_round_runs(rounds, params, dparams, dcfg, pool, toks, pos, tables)
    dims, _ = MESHES[world][mesh]
    for r, out in enumerate(ranks[world]):
        for kind, (tokens, n_out, tpool, dpool) in out[f"rounds/{mesh}"].items():
            wt, wn, wpool, wdpool = want[kind]
            assert torch.equal(tokens, wt) and torch.equal(n_out, wn), (kind, r)
            _assert_pages_equal(tpool, _stage_slice(wpool, dims, r))
            _assert_pages_equal(dpool, wdpool)
