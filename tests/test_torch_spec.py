"""The PyTorch port's speculative decoding against the JAX package on the CPU: the tree
topology, greedy `speculative_generate` and the chain and tree speculative paged
engines token for token (the target-only tokens, as the JAX package's own tests
assert, and the JAX engines' acceptance counters), the rejection steps' output
distribution, and the generate and serve CLIs with a draft checkpoint.

Parameters come from numpy with a seed and feed both packages; everything runs in f32,
so greedy tokens are compared exactly. The comparisons with the JAX package run every
round's body under `torch_port_helpers.guarded_bodies` (no host read, no tensor built
from host data inside a body).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import spec_serving as jspec_serving
from lit_llama_ja_tpu.infer import tree_spec as jtree
from lit_llama_ja_tpu.infer.generate import generate as jgenerate
from lit_llama_ja_tpu.infer.speculative import speculative_generate as jspeculative_generate

from lit_llama_ja_tpu_torch.cli import generate_cli, serve_cli
from lit_llama_ja_tpu_torch.core import config as tconfig
from lit_llama_ja_tpu_torch.infer import spec_serving, tree_spec
from lit_llama_ja_tpu_torch.infer.generate import generate
from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer
from lit_llama_ja_tpu_torch.models.llama import init_params

from torch_port_helpers import guarded_bodies, random_tree, to_port  # noqa: F401 (a fixture)

TCFG = dict(block_size=96, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
DCFG = dict(block_size=96, vocab_size=64, n_layer=1, n_head=2, n_embd=16)


@pytest.fixture(scope="module")
def models():
    """{"target": (jax params, port params), "draft": (...)} from one numpy seed."""
    rng = np.random.default_rng(11)
    out = {}
    for name, cfg in (("target", TCFG), ("draft", DCFG)):
        jc = JConfig(**cfg)
        tree = random_tree(rng, cfg["n_layer"], cfg["n_embd"], jc.n_hidden,
                           jc.padded_vocab_size, std=0.3)
        jparams = jax.tree.map(jnp.asarray, tree)
        out[name] = (jparams, to_port(jparams))
    return out


def _prompts(rng, lengths):
    return [rng.integers(0, TCFG["vocab_size"], (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("branching", [(4, 2, 2), (1,), (2, 1, 1), (3, 2)])
def test_tree_topology_matches_jax(branching):
    want, got = jtree.tree_topology(branching), tree_spec.tree_topology(branching)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key == "levels":
            assert len(got[key]) == len(val)
            for a, b in zip(got[key], val):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got[key], val)


# -- speculative_generate ------------------------------------------------------------

@pytest.mark.parametrize("K,kv", [(1, False), (4, False), (3, "int8"), (3, "int4")])
def test_speculative_generate_greedy_matches_target(models, rng, guarded_bodies, K, kv):
    """Greedy speculation emits the target's own greedy tokens whatever the draft
    proposes, with a quantized target cache too; the rounds and accepted drafts are
    the JAX package's, and each round ran one guarded body."""
    (jt, tt), (jd, td) = models["target"], models["draft"]
    prompt = _prompts(rng, (7,))[0]
    tcfg, dcfg = tconfig.LLaMAConfig(**TCFG), tconfig.LLaMAConfig(**DCFG)
    want = generate(tt, tcfg, prompt, 20, temperature=0.0, quantize_kv=kv, device="cpu")
    stats, jstats = {}, {}
    before = guarded_bodies["n"]
    got = speculative_generate(tt, tcfg, td, dcfg, prompt, 20, K=K, temperature=0.0,
                               quantize_kv=kv, stats_out=stats, device="cpu")
    assert guarded_bodies["n"] - before == stats["rounds"] > 0
    np.testing.assert_array_equal(got, want)
    jgot = jspeculative_generate(jt, JConfig(**TCFG), jd, JConfig(**DCFG), prompt, 20, K=K,
                                 temperature=0.0, quantize_kv=kv, stats_out=jstats)
    np.testing.assert_array_equal(got, jgot)
    assert stats == jstats
    if not kv:
        np.testing.assert_array_equal(
            got, np.asarray(jgenerate(jt, JConfig(**TCFG), jnp.asarray(prompt), 20,
                                      temperature=0.0)))


def test_speculative_generate_self_draft_eos_and_sampling(models, rng):
    """A draft equal to the target accepts every draft; an eos stops mid-round; a
    tempered run is repeatable under one seed and stays in the vocabulary."""
    tt = models["target"][1]
    tcfg = tconfig.LLaMAConfig(**TCFG)
    prompt = _prompts(rng, (5,))[0]
    want = generate(tt, tcfg, prompt, 16, temperature=0.0, device="cpu")
    stats = {}
    got = speculative_generate(tt, tcfg, tt, tcfg, prompt, 16, K=4, temperature=0.0,
                               stats_out=stats, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert stats["acceptance"] == 1.0
    eos = int(want[len(prompt) + 2])
    out = speculative_generate(tt, tcfg, models["draft"][1], tconfig.LLaMAConfig(**DCFG),
                               prompt, 12, K=3, temperature=0.0, eos_id=eos, device="cpu")
    assert out[-1] == eos and len(out) == len(prompt) + 3

    def sampled():
        return speculative_generate(tt, tcfg, models["draft"][1], tconfig.LLaMAConfig(**DCFG),
                                    prompt, 10, K=2, temperature=0.8, top_k=20,
                                    generator=torch.Generator().manual_seed(3), device="cpu")

    a, b = sampled(), sampled()
    np.testing.assert_array_equal(a, b)
    assert len(a) == len(prompt) + 10 and (a >= 0).all() and (a < TCFG["vocab_size"]).all()


# -- the speculative paged engines ---------------------------------------------------

ENGINE = dict(max_batch=2, n_pages=48, page_size=4)
# name -> (engine class name, engine kwargs, prompt lengths, max_new_tokens). Over an
# int4 pool the tree engine commits k/v from one forward over every node, whose f32
# sums may put a value on the other side of an int4 level than the target-only
# engine's one-token forward does; the JAX tree engine then leaves the target-only
# tokens too, so that case is held to the JAX tree engine alone.
NOT_TARGET_ONLY = {"tree_int4_pool"}
SPEC_CASES = {
    "chain_k3": ("chain", dict(draft_k=3), (5, 9, 3), 12),
    "chain_k1": ("chain", dict(draft_k=1), (6,), 15),
    "chain_int8_pool": ("chain", dict(draft_k=3, quantize_kv="int8"), (5, 9, 3), 10),
    "chain_int4_pool": ("chain", dict(draft_k=3, quantize_kv="int4"), (6, 4), 10),
    "chain_chunked_prefill": ("chain", dict(draft_k=3, prefill_chunk=8), (21, 5), 8),
    "chain_adaptive_k": ("chain", dict(draft_k=4, adaptive_k=True), (5, 9, 3), 12),
    "chain_small_pool": ("chain", dict(draft_k=2, n_pages=10), (10, 10, 4), 12),
    "tree_2_2": ("tree", dict(tree=(2, 2)), (5, 9, 3), 12),
    "tree_4_2_2": ("tree", dict(tree=(4, 2, 2)), (6,), 12),
    "tree_int8_pool": ("tree", dict(tree=(2, 2), quantize_kv="int8"), (6, 4), 10),
    "tree_int4_pool": ("tree", dict(tree=(2, 2), quantize_kv="int4"), (6,), 10),
    "tree_chunked_prefill": ("tree", dict(tree=(2, 2), prefill_chunk=8), (21,), 8),
}
# The cases also run through the JAX engine, whose compiles take seconds each: one per
# engine and one per counter path (adaptive K, preemption), and the int4 tree.
JAX_CASES = {"chain_k3", "chain_adaptive_k", "chain_small_pool", "tree_2_2", "tree_int4_pool"}
ENGINES = {"chain": (jspec_serving.SpeculativePagedEngine, spec_serving.SpeculativePagedEngine),
           "tree": (jtree.TreeSpeculativePagedEngine, tree_spec.TreeSpeculativePagedEngine)}


def _port_engine(models, kind, **kw):
    tt, td = models["target"][1], models["draft"][1]
    return ENGINES[kind][1](tt, tconfig.LLaMAConfig(**TCFG), draft_params=td,
                            draft_config=tconfig.LLaMAConfig(**DCFG), device="cpu",
                            **{**ENGINE, **kw})


def _jax_engine(models, kind, **kw):
    jt, jd = models["target"][0], models["draft"][0]
    return ENGINES[kind][0](jt, JConfig(**TCFG), draft_params=jd, draft_config=JConfig(**DCFG),
                            **{**ENGINE, **kw})


def _plain_tokens(models, prompts, new, prefix=None, **kw):
    """The target-only tokens: the port's `PagedEngine` on the same requests, which
    `tests/test_torch_paged.py` holds token for token to the JAX package's."""
    kw = {**ENGINE, **{k: v for k, v in kw.items() if k in ("quantize_kv", "n_pages")}}
    eng = PagedEngine(models["target"][1], tconfig.LLaMAConfig(**TCFG), device="cpu", **kw)
    pid = eng.register_prefix(prefix) if prefix is not None else None
    return eng.run([(p, new) for p in prompts], prefix_id=pid)


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_engine_matches_jax(models, rng, guarded_bodies, case):
    """Greedy tokens equal to the target-only engine's; in `JAX_CASES` also equal to
    the JAX speculative engine's, with equal `stats()` (acceptance counters
    included); every round ran one guarded body."""
    kind, kw, lengths, new = SPEC_CASES[case]
    prompts = _prompts(rng, lengths)
    teng = _port_engine(models, kind, **kw)
    got = teng.run([(p, new) for p in prompts])
    assert guarded_bodies["n"] == teng.stats()["spec_rounds"] > 0
    assert sorted(got) == list(range(len(prompts)))
    if case not in NOT_TARGET_ONLY:
        plain = _plain_tokens(models, prompts, new, **kw)
        for rid in got:
            np.testing.assert_array_equal(got[rid], plain[rid])
    if case in JAX_CASES:
        jeng = _jax_engine(models, kind, **kw)
        want = jeng.run([(p, new) for p in prompts])
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
        assert teng.stats() == jeng.stats()
    assert teng.stats()["pages_used"] == 0
    if case == "chain_small_pool":
        assert teng.stats()["preempts"] > 0


@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_spec_engine_prefix_sharing_and_eos(models, rng, kind):
    """Requests over a registered prefix give the target-only tokens; an eos stops a
    request mid-round."""
    prefix = _prompts(rng, (9,))[0]
    conts = _prompts(rng, (4, 6))
    want = _plain_tokens(models, conts, 8, prefix=prefix)
    extra = dict(draft_k=3) if kind == "chain" else dict(tree=(2, 2))
    teng = _port_engine(models, kind, **extra)
    pid = teng.register_prefix(prefix)
    got = teng.run([(c, 8) for c in conts], prefix_id=pid)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats()["pages_used"] == 9 // ENGINE["page_size"]

    prompt = conts[0]
    ref = _plain_tokens(models, [prompt], 12)[0]
    eos = int(ref[len(prompt) + 2])
    teng = _port_engine(models, kind, eos_id=eos, **extra)
    out = teng.run([(prompt, 12)])[0]
    assert out[-1] == eos and len(out) == len(prompt) + 3


def test_spec_engine_self_draft_and_sampling(models, rng):
    """A draft equal to the target: every draft accepted in both engines. Tempered
    top-k/top-p sampling: in-vocabulary tokens of the asked length, repeatable under
    one seed."""
    tt = models["target"][1]
    tcfg = tconfig.LLaMAConfig(**TCFG)
    prompt = _prompts(rng, (5,))[0]
    want = _plain_tokens(models, [prompt], 12)[0]
    for cls, kw in ((spec_serving.SpeculativePagedEngine, dict(draft_k=3)),
                    (tree_spec.TreeSpeculativePagedEngine, dict(tree=(2, 2)))):
        eng = cls(tt, tcfg, draft_params=tt, draft_config=tcfg, device="cpu", **ENGINE, **kw)
        np.testing.assert_array_equal(eng.run([(prompt, 12)])[0], want)
        assert eng.stats()["acceptance_rate"] == 1.0
        outs = [cls(tt, tcfg, draft_params=models["draft"][1],
                    draft_config=tconfig.LLaMAConfig(**DCFG), seed=5, device="cpu", **ENGINE,
                    **kw).run([(prompt, 10)], temperature=0.8, top_k=20, top_p=0.95)[0]
                for _ in range(2)]
        np.testing.assert_array_equal(outs[0], outs[1])
        assert len(outs[0]) == len(prompt) + 10
        assert (outs[0] >= 0).all() and (outs[0] < TCFG["vocab_size"]).all()


# -- the rejection steps' output distribution ---------------------------------------

N_DRAWS = 20000


def _close_to(first, p):
    """Each bucket of the empirical distribution within 5 binomial sigma of ``p``."""
    emp = np.bincount(first, minlength=len(p)) / len(first)
    tol = 5 * np.sqrt(p * (1 - p) / len(first)) + 1e-3
    assert (np.abs(emp - p) < tol).all(), (emp, p)


def test_accept_steps_preserve_target_distribution():
    """Whatever the draft proposes, the first token a round emits follows the target's
    distribution: the chain's rejection step over 20,000 independent slots (K = 2),
    and the tree walk (branching (2, 2)) with siblings drawn i.i.d. from their
    parent's draft distribution."""
    V, B = 8, N_DRAWS
    r = np.random.default_rng(7)
    g = torch.Generator().manual_seed(0)
    temps = torch.ones(B)

    p_t = torch.from_numpy(r.dirichlet(np.ones(V), size=3).astype(np.float32))  # (K+1, V)
    p_d = torch.from_numpy(r.dirichlet(np.ones(V), size=2).astype(np.float32))  # (K, V)
    p_d_b = p_d[None].expand(B, 2, V).contiguous()
    drafts = torch.multinomial(p_d_b.reshape(-1, V), 1, generator=g).reshape(B, 2)
    tlogits = torch.log(p_t)[None].expand(B, 3, V)
    tokens, n_out = spec_serving._accept_chain(tlogits, drafts, p_d_b, temps, None, None, g)
    assert ((n_out >= 1) & (n_out <= 3)).all()
    _close_to(tokens[:, 0].numpy(), p_t[0].numpy())

    branching = (2, 2)
    topo = tree_spec.tree_topology(branching)
    NT = topo["n_nodes"]
    p_all = torch.from_numpy(r.dirichlet(np.ones(V), size=NT).astype(np.float32))
    q_all = torch.from_numpy(r.dirichlet(np.ones(V), size=NT).astype(np.float32))
    parents = torch.as_tensor(topo["parents"][1:]).long()
    toks = torch.zeros((B, NT), dtype=torch.long)
    toks[:, 1:] = torch.multinomial(q_all[parents], B, replacement=True, generator=g).T
    out, n_out, path, n_acc = tree_spec.tree_accept_walk(
        p_all[None].expand(B, NT, V), q_all[None].expand(B, NT, V), toks, branching, g, temps)
    assert (n_out == n_acc + 1).all() and (path[:, 0] == 0).all()
    _close_to(out[:, 0].numpy(), p_all[0].numpy())


# -- the CLIs with a draft checkpoint ------------------------------------------------

TINY = dict(block_size=32, vocab_size=320, n_layer=2, n_head=4, n_embd=64)
TINY_DRAFT = dict(block_size=32, vocab_size=320, n_layer=1, n_head=2, n_embd=32)
WORDS = ["tokyo", "kyoto", "osaka", "sakura", "yama", "kawa", "umi", "sora", "hana", "tori"]


@pytest.fixture
def setup(tmp_path, monkeypatch):
    """A tokenizer, a target and a draft checkpoint of random weights."""
    monkeypatch.setitem(tconfig.llama_configs, "tiny", TINY)
    monkeypatch.setitem(tconfig.llama_configs, "tiny-draft", TINY_DRAFT)
    rng = np.random.default_rng(0)
    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(" ".join(rng.choice(WORDS, size=12)) for _ in range(300)))
    tok = HFTokenizer.train(str(text), str(tmp_path), vocab_size=300)
    for name, seed in (("tiny", 0), ("tiny-draft", 1)):
        config = tconfig.LLaMAConfig.from_name(name)
        params = init_params(torch.Generator().manual_seed(seed), config, device="cpu")
        params = {k: ({kk: v * 5 for kk, v in sub.items()} if k in ("wte", "lm_head") else sub)
                  for k, sub in params.items()}  # a less uniform next-token distribution
        save_checkpoint(tmp_path / name, params, config)
    return tmp_path, tok


def test_generate_cli_speculative(setup, capsys):
    tmp, tok = setup
    common = dict(prompt="tokyo kyoto", checkpoint_path=str(tmp / "tiny"), tokenizer_path=tok,
                  max_new_tokens=8, temperature=0.0, quantize_kv="int8", device="cpu")
    generate_cli.main(**common)
    want = capsys.readouterr().out
    generate_cli.main(draft_checkpoint_path=str(tmp / "tiny-draft"), draft_k=3, **common)
    out = capsys.readouterr()
    assert out.out == want
    assert "speculative: acceptance" in out.err and "tokens/sec" in out.err


@pytest.mark.parametrize("kw", [dict(draft_k=3), dict(draft_k=4, adaptive_k=True),
                                dict(draft_tree="3,2"),
                                dict(draft_tree="2,2", quantize_kv="int8", prefill_chunk=2)])
def test_serve_cli_speculative(setup, capsys, kw):
    """The speculative engines serve the plain paged engine's greedy text."""
    tmp, tok = setup
    common = dict(prompt="sakura yama kawa", n_requests=3, checkpoint_path=str(tmp / "tiny"),
                  tokenizer_path=tok, max_new_tokens=6, max_batch=2, max_seq_length=32,
                  temperature=0.0, quantize_kv=kw.pop("quantize_kv", "int4"),
                  prefill_chunk=kw.pop("prefill_chunk", 0), device="cpu")
    serve_cli.main(**common)
    want = capsys.readouterr().out
    serve_cli.main(draft_checkpoint_path=str(tmp / "tiny-draft"), **common, **kw)
    out = capsys.readouterr()
    assert out.out == want and out.out.count("--- request ") == 3
    assert "3 requests" in out.err
