"""The port's pipeline-parallel paged serving (`lit_llama_ja_tpu_torch/parallel/pp_decode.py`,
`PagedEngine(pp_mesh=)`, `serve_cli --pp-stages`) on gloo ranks on the CPU, mirroring
tests/test_pp_decode.py: the decode step at (pp, n_micro) in {(2, 1), (2, 2), (4, 2)},
six chained greedy steps, a sampled step, the prefill, the int8 pool, the two-dispatch
read and commit against the fused step, the engine (with chunked prefill and a shared
prefix), pp×tp engines over fp, int8 and int4 pools, and the serve CLI.

Oracles: the port's one-rank result on the same tree, inputs and seed: tokens equal
(greedy and sampled) and pool pages ``[:, 1:]`` equal in bits (page 0 is the trash
page), logits equal in bits; the JAX package's single-mesh engine and `paged_forward`
greedily (tokens equal, logits to 1e-4 absolute: f32 sums in another order over four
layers), as the JAX pp programs are not run case by case. Every rank's pool is its
stage's layers (and its tp heads), held to the same slice of the one-rank pool.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import cli_runs, pp_decode_runs, spawn
from torch_port_helpers import random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import paged as jpaged

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import paged as tpaged
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh
from lit_llama_ja_tpu_torch.parallel.pp_decode import pp_pool_specs, shard_pool_pp

CFG = dict(block_size=32, vocab_size=96, n_layer=4, n_head=4, n_embd=32)
PAGE, NPAGES = 4, 24
MESHES = {2: {"pp2_m1": (dict(fsdp=1, pp=2), 1), "pp2_m2": (dict(fsdp=1, pp=2), 2)},
          4: {"pp4_m2": (dict(fsdp=1, pp=4), 2), "pp2_tp2": (dict(fsdp=1, tp=2, pp=2), 2)}}
KVS = (False, "int8")
TINY = dict(block_size=16, vocab_size=256, n_layer=2, n_head=4, n_embd=32)
SERVE = dict(tokenizer_path="unused", prompt="osaka", n_requests=2, max_new_tokens=4,
             max_seq_length=32, temperature=0.0, quantize_kv="int8", device="cpu")


def _tree():
    c = JConfig(**CFG)
    return random_tree(np.random.default_rng(7), c.n_layer, c.n_embd, c.n_hidden,
                       c.padded_vocab_size, std=0.3)


def _prompts(rng, lengths):
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32) for n in lengths]


def _engine_cases(rng):
    """name -> (mesh name, engine kwargs, requests, run kwargs, prefix)."""
    four = [(p, 10) for p in _prompts(rng, (5, 11, 3, 8))]
    kw = dict(max_batch=4, n_pages=NPAGES, page_size=PAGE)
    chunk = dict(kw, prefill_chunk=8)
    long, prefix = _prompts(rng, (17,))[0], _prompts(rng, (9,))[0]
    two = [(p, 5) for p in _prompts(rng, (5, 9))]
    return {
        "fp": ("pp2_m2", kw, four, {}, None),
        "int8": ("pp2_m2", dict(kw, quantize_kv="int8"), four, {}, None),
        "fused": ("pp2_m2", dict(kw, pp_split=False), four, {}, None),
        "sampled": ("pp2_m2", dict(kw, seed=3), four, dict(temperature=0.8, top_k=20), None),
        "chunked": ("pp2_m2", chunk, [(long, 6)], {}, None),
        "chunked_prefix": ("pp2_m2", chunk, [(long, 6)], {}, prefix),
        "pp4": ("pp4_m2", kw, four, {}, None),
        **{f"tp_{kv}": ("pp2_tp2", dict(kw, quantize_kv=kv), two, {}, None)
           for kv in (False, "int8", "int4")},
    }


def _setup(params, cfg, rng):
    """Four slots prefilled (lengths 6, 9, 4 and 7) on one rank, for each pool kind, their
    tables holding real pages for the six chained steps (a position past a slot's pages
    would write the trash page, which the slots share); and a 7-token prefill span on an
    empty pool. Four slots, so that each of two micro-groups holds two rows: on the CPU
    a one-row matmul takes another kernel than a batched one, with other bits."""
    decode = {}
    lengths = (6, 9, 4, 7)
    for kv in KVS:
        pool = tpaged.init_page_pool(cfg, NPAGES, PAGE, torch.bfloat16, kv, device="cpu")
        tables = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
        cur = []
        for b, p in enumerate(_prompts(rng, lengths)):
            logits, pool = tpaged.paged_forward(params, p[None], np.arange(len(p))[None],
                                                tables[b:b + 1], pool, cfg, kv, device="cpu")
            cur.append(int(logits[0, -1].argmax()))
        decode[kv] = (pool, tables, np.array(lengths, np.int32), np.array(cur, np.int32))
    tables = np.zeros((1, 4), np.int32)
    tables[0, :2] = [1, 2]
    prompt = _prompts(rng, (7,))[0][None]
    prefill = {kv: (tpaged.init_page_pool(cfg, NPAGES, PAGE, torch.bfloat16, kv, device="cpu"),
                    prompt, np.arange(7, dtype=np.int32)[None], tables) for kv in KVS}
    return {"decode": decode, "prefill": prefill}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = _tree()
    params, cfg = to_port(tree), LLaMAConfig(**CFG)
    rng = np.random.default_rng(8)
    setup, cases = _setup(params, cfg, rng), _engine_cases(rng)
    root = tmp_path_factory.mktemp("pp_decode")
    crng = np.random.default_rng(0)
    from lit_llama_ja_tpu_torch.core import config as tconfig

    tiny = tconfig.LLaMAConfig(**TINY)
    ctree = to_port(random_tree(crng, 2, 32, tiny.n_hidden, 256, std=0.05))
    for key in ("wte", "lm_head"):  # a less uniform next-token distribution
        ctree[key]["weight"] = ctree[key]["weight"] * 5
    save_checkpoint(root / "fp", ctree, tiny)
    serve = dict(SERVE, checkpoint_path=str(root / "fp"))
    clis = {2: dict(serve, pp_stages=2), 4: dict(serve, pp_stages=2, tp=2)}
    ranks = {}
    for w in (2, 4):
        wcases = {k: v for k, v in cases.items() if v[0] in MESHES[w]}
        ranks[w] = spawn(pp_decode_runs, w, root, params, cfg, setup, wcases, MESHES[w],
                         str(root), TINY, clis[w])
    single = cli_runs(0, 1, str(root), TINY, [("serve", serve)])["serve"]
    return tree, params, cfg, setup, cases, ranks, single


def _stage_slice(pool, dims, rank):
    mesh = Mesh({"dp": 1, "fsdp": 1, "tp": dims.get("tp", 1), "pp": dims["pp"]}, rank=rank)
    return shard_pool_pp(pool, mesh)


def _assert_pages_equal(got, want):
    for key in want:
        torch.testing.assert_close(got[key][:, 1:], want[key][:, 1:], rtol=0, atol=0,
                                   msg=key)


def _one_rank_decode(params, cfg, setup, kv, n_steps=1, split=False):
    """Greedy decode steps on one rank: `paged_forward` (write, then attend), or with
    ``split`` `paged_forward_read` and `commit_writes` (the two-dispatch route, whose
    attention reads the fresh k/v beside the pool)."""
    pool, tables, pos, cur = setup["decode"][kv]
    pool = {k: v.clone() for k, v in pool.items()}
    toks = []
    for i in range(n_steps):
        if split:
            logits, w, pi, of = tpaged.paged_forward_read(params, cur[:, None], pos[:, None],
                                                          tables, pool, cfg, kv, device="cpu")
            tpaged.commit_writes(pool, w, pi, of)
        else:
            logits, pool = tpaged.paged_forward(params, cur[:, None], pos[:, None], tables,
                                                pool, cfg, kv, device="cpu")
        cur = tpaged.sample_next_token(logits[:, 0], torch.zeros(len(cur)), None).numpy()
        pos = pos + 1
        toks.append(torch.as_tensor(cur))
    return torch.stack(toks), pool


def test_pp_pool_specs_and_shard():
    pool = tpaged.init_page_pool(LLaMAConfig(**CFG), NPAGES, PAGE, torch.bfloat16, "int4",
                                 device="cpu")
    assert set(pp_pool_specs(pool).values()) == {("pp", None, "tp")}
    pool["k"] = torch.arange(pool["k"].numel(), dtype=torch.int32).view(pool["k"].shape)
    part = shard_pool_pp(pool, Mesh({"dp": 1, "fsdp": 1, "tp": 2, "pp": 2}, rank=3))
    assert torch.equal(part["k"], pool["k"][2:, :, 1:])  # stage 1, the second head pair


@pytest.mark.parametrize("world,mesh", [(2, "pp2_m1"), (2, "pp2_m2"), (4, "pp4_m2")])
@pytest.mark.parametrize("kv", KVS, ids=["fp", "int8"])
def test_pp_decode_step_matches_single_rank(runs, world, mesh, kv):
    """The fused step and six chained greedy steps against the one-rank `paged_forward`,
    the two-dispatch read and commit against the one-rank `paged_forward_read` and
    `commit_writes` (greedy tokens, the stage's pool pages), and the two routes' tokens
    against each other, at (pp, n_micro) (2, 1), (2, 2) and (4, 2)."""
    _, params, cfg, setup, _, ranks, _ = runs
    chain, _ = _one_rank_decode(params, cfg, setup, kv, n_steps=6)
    dims = MESHES[world][mesh][0]
    for route in ("fused", "split"):
        want_tok, want_pool = _one_rank_decode(params, cfg, setup, kv, split=route == "split")
        assert want_tok[0].tolist() == chain[0].tolist()
        for r, out in enumerate(ranks[world]):
            tok, pool = out[f"{mesh}/{kv}/{route}"]
            assert tok.tolist() == want_tok[0].tolist(), route
            _assert_pages_equal(pool, _stage_slice(want_pool, dims, r))
    for out in ranks[world]:
        assert out[f"{mesh}/{kv}/chain"].tolist() == chain.tolist()


def test_pp_decode_sampled_matches_single_rank(runs):
    """A sampled step (temperature 0.8, top-k 20, top-p 0.9) from the same generator seed
    gives the one rank's tokens on every rank."""
    _, params, cfg, setup, _, ranks, _ = runs
    pool, tables, pos, cur = setup["decode"][False]
    logits, _ = tpaged.paged_forward(params, cur[:, None], pos[:, None], tables,
                                     {k: v.clone() for k, v in pool.items()}, cfg, False,
                                     device="cpu")
    want = tpaged.sample_next_token(logits[:, 0], torch.full((4,), 0.8), 20, 0.9,
                                    torch.Generator().manual_seed(0))
    for world, mesh in ((2, "pp2_m1"), (2, "pp2_m2"), (4, "pp4_m2")):
        for out in ranks[world]:
            got = out[f"{mesh}/False/sampled"]
            assert got.tolist() == want.tolist()
            assert ((got >= 0) & (got < cfg.padded_vocab_size)).all()


@pytest.mark.parametrize("kv", KVS, ids=["fp", "int8"])
def test_pp_prefill_matches_paged_forward(runs, kv):
    """The fused prefill against `paged_forward`, the two-dispatch prefill against
    `paged_forward_read` and `commit_writes`: logits and pages in bits; and the JAX
    package's `paged_forward` on the fp pool."""
    tree, params, cfg, setup, _, ranks, _ = runs
    pool, toks, pos, tables = setup["prefill"][kv]
    want_lg, want_pool = tpaged.paged_forward(params, toks, pos, tables,
                                              {k: v.clone() for k, v in pool.items()}, cfg,
                                              kv, device="cpu")
    read_pool = {k: v.clone() for k, v in pool.items()}
    rlg, w, pi, of = tpaged.paged_forward_read(params, toks, pos, tables, read_pool, cfg, kv,
                                               device="cpu")
    tpaged.commit_writes(read_pool, w, pi, of)
    for world, mesh in ((2, "pp2_m1"), (4, "pp4_m2")):
        dims = MESHES[world][mesh][0]
        for r, out in enumerate(ranks[world]):
            lg, got = out[f"{mesh}/{kv}/prefill"]
            torch.testing.assert_close(lg, want_lg, rtol=0, atol=0)
            _assert_pages_equal(got, _stage_slice(want_pool, dims, r))
            lg, got = out[f"{mesh}/{kv}/prefill_split"]
            torch.testing.assert_close(lg, rlg, rtol=0, atol=0)
            _assert_pages_equal(got, _stage_slice(read_pool, dims, r))
    if not kv:
        jt = jax.tree.map(jnp.asarray, tree)
        jpool = jpaged.init_page_pool(JConfig(**CFG), NPAGES, PAGE, jnp.bfloat16, False)
        jlg, _ = jpaged.paged_forward(jt, jnp.asarray(toks), jnp.asarray(pos),
                                      jnp.asarray(tables), jpool, JConfig(**CFG), False)
        np.testing.assert_allclose(ranks[2][0]["pp2_m1/False/prefill"][0].numpy(),
                                   np.asarray(jlg), atol=1e-4, rtol=0)


ENGINE_NAMES = ["fp", "int8", "fused", "sampled", "chunked", "chunked_prefix", "pp4",
                "tp_False", "tp_int8", "tp_int4"]


@pytest.mark.parametrize("name", ENGINE_NAMES)
def test_paged_engine_pp_matches_single_rank(runs, name):
    """`PagedEngine(pp_mesh=...)` emits the one-rank engine's token streams (the same
    admission, chunked prefill, prefix pages and sampling seed), with equal `stats()`,
    and, without tp, ends with the same pool pages; pp 2 (two micro-groups), pp 4 and
    pp 2 × tp 2 (fp, int8 and int4 pools)."""
    _, params, cfg, _, cases, ranks, _ = runs
    mesh_name, kw, requests, run_kw, prefix = cases[name]
    world = 2 if mesh_name in MESHES[2] else 4
    dims = MESHES[world][mesh_name][0]
    kw = {k: v for k, v in kw.items() if k != "pp_split"}
    eng = tpaged.PagedEngine(params, cfg, device="cpu", **kw)
    if prefix is not None:
        run_kw = dict(run_kw, prefix_id=eng.register_prefix(prefix))
    res = eng.run(requests, **run_kw)
    want = [res[i].tolist() for i in sorted(res)]
    for r, out in enumerate(ranks[world]):
        toks, stats, pool = out[f"engine/{name}"]
        assert [t.tolist() for t in toks] == want
        assert stats == eng.stats()
        if dims.get("tp", 1) == 1:  # tp sums the row-parallel products in another order
            _assert_pages_equal(pool, _stage_slice(eng.pool, dims, r))


def test_paged_engine_pp_matches_jax(runs):
    """The JAX package's single-mesh engine, greedy, against the port's pp 2 engine."""
    tree, _, _, _, cases, ranks, _ = runs
    for name in ("fp", "int8"):
        _, kw, requests, _, _ = cases[name]
        jkw = dict(kw, quantize_kv=kw.get("quantize_kv") == "int8")
        res = jpaged.PagedEngine(jax.tree.map(jnp.asarray, tree), JConfig(**CFG),
                                 **jkw).run(requests)
        want = [res[i].tolist() for i in sorted(res)]
        for out in ranks[2]:
            assert [t.tolist() for t in out[f"engine/{name}"][0]] == want, name


def test_speculative_engines_refuse_a_pipeline():
    """Speculation on a pipeline is ported (tests/test_torch_pp_spec.py); both
    speculative engines still refuse, before any rank waits on another, what the plain
    engine refuses there: a dp = 2 mesh, a mesh beside the pipeline mesh, slots that do
    not split into the micro-groups, layers that do not split over the stages."""
    from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
    from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine

    params, cfg = to_port(_tree()), LLaMAConfig(**CFG)

    def pp(stages, dp=1):
        return Mesh({"dp": dp, "fsdp": 1, "tp": 1, "pp": stages}, rank=0, distributed=False)

    refused = [(dict(pp_mesh=pp(2, dp=2)), "dp must be 1"),
               (dict(pp_mesh=pp(2), mesh=pp(2)), "pass one mesh"),
               (dict(pp_mesh=pp(2), max_batch=4, pp_microbatches=3), "micro-groups"),
               (dict(pp_mesh=pp(3)), "does not split over pp=3")]
    for engine in (SpeculativePagedEngine, TreeSpeculativePagedEngine):
        for kw, match in refused:
            with pytest.raises(ValueError, match=match):
                engine(params, cfg, draft_params=params, draft_config=cfg, device="cpu", **kw)


def test_serve_cli_pp_matches_one_rank(runs):
    """``serve_cli --pp-stages 2`` on 2 ranks and ``--tp 2 --pp-stages 2`` on 4 print the
    one-rank CLI's requests (rank 0 prints)."""
    *_, ranks, single = runs
    assert "--- request 1 ---" in single
    for world in (2, 4):
        assert ranks[world][0]["serve"] == single
        assert all(out["serve"] == "" for out in ranks[world][1:])
