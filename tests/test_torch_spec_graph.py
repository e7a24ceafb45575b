"""The speculative rounds, the stripe engine's step and the perplexity loops as device
programs (`infer/speculative.spec_generate_round`, `infer/spec_serving.batched_spec_body`,
`infer/tree_spec.tree_spec_body`, `infer/serving.stripe_decode_and_sample`,
`infer/evaluate.decode_nll_body` and `window_nll_body`) on the CPU, where each body runs
in a host loop.

Every body runs under `torch_port_helpers.guarded_bodies` (no host read, no tensor built
from host data inside it), once a round, step, token or window. Adaptive K keys one
graph per rung of its ladder; the tree's device constants are built once an engine; a
sampled run is repeatable under one seed. The greedy tokens and perplexities of these
bodies are held to the JAX package in `tests/test_torch_spec.py`,
`tests/test_torch_serving.py` and `tests/test_torch_quant_generate.py`, under the same
guard. No JAX here: the cases compile nothing.
"""
import numpy as np
import pytest
import torch
from torch_port_helpers import guarded_bodies  # noqa: F401 (a fixture)

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import decode_graph, tree_spec
from lit_llama_ja_tpu_torch.infer.evaluate import decode_path_perplexity, perplexity
from lit_llama_ja_tpu_torch.infer.serving import Engine
from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine
from lit_llama_ja_tpu_torch.models.llama import init_params

TCFG = LLaMAConfig(block_size=64, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
DCFG = LLaMAConfig(block_size=64, vocab_size=64, n_layer=1, n_head=2, n_embd=16)
ENGINE = dict(max_batch=2, n_pages=40, page_size=4, device="cpu")


@pytest.fixture(scope="module")
def models():
    """Target and draft weights from a seed, the embedding and head scaled up so that
    the next-token distributions are far from uniform."""
    out = []
    for seed, cfg in ((0, TCFG), (1, DCFG)):
        p = init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        out.append({k: ({kk: v * 5 for kk, v in sub.items()} if k in ("wte", "lm_head")
                        else sub) for k, sub in p.items()})
    return out


def _prompts(n, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, (k,)).astype(np.int32) for k in lengths[:n]]


def _chain(models, **kw):
    return SpeculativePagedEngine(models[0], TCFG, draft_params=models[1], draft_config=DCFG,
                                  **{**ENGINE, **kw})


def _tree(models, **kw):
    return TreeSpeculativePagedEngine(models[0], TCFG, draft_params=models[1],
                                      draft_config=DCFG, **{**ENGINE, **kw})


@pytest.mark.parametrize("kind", ["spec_generate", "chain", "tree", "stripe", "decode_path",
                                  "perplexity"])
def test_each_body_runs_guarded_once_a_step(models, guarded_bodies, kind):
    """Each new body runs under the guard: once a round (`speculative_generate`, the
    chain and tree engines), a decode step (the stripe engine), a token (the decode-path
    perplexity) or a window (the perplexity), and its engine keys one graph a shape."""
    prompts = _prompts(2, (5, 9))
    if kind == "spec_generate":
        stats = {}
        speculative_generate(models[0], TCFG, models[1], DCFG, prompts[0], 12, K=3,
                             temperature=0.0, quantize_kv="int8", stats_out=stats,
                             device="cpu")
        assert guarded_bodies["n"] == stats["rounds"] > 0
    elif kind in ("chain", "tree"):
        eng = _chain(models, draft_k=3) if kind == "chain" else _tree(models, tree=(2, 2))
        eng.run([(p, 8) for p in prompts])
        assert guarded_bodies["n"] == eng.stats()["spec_rounds"] > 0
        assert all(key[0] & (key[0] - 1) == 0 for key in eng.decode_step.graphs)  # widths
    elif kind == "stripe":
        eng = Engine(models[0], TCFG, max_batch=2, quantize_kv="int8", device="cpu")
        eng.run([(p, 6) for p in prompts])
        assert guarded_bodies["n"] == eng.stats()["steps"] > 0
        assert list(eng.decode_step.graphs) == [(None, None)]
    else:
        tokens = np.random.default_rng(3).integers(0, 64, 100).astype(np.int32)
        if kind == "decode_path":
            ppl = decode_path_perplexity(models[0], TCFG, tokens, quantize_kv="int4",
                                         windows=2, window=12, device="cpu")
            assert guarded_bodies["n"] == 2 * 12
        else:
            ppl = perplexity(models[0], TCFG, tokens, window=24, device="cpu")
            assert guarded_bodies["n"] == (len(tokens) - 1) // 24
        assert np.isfinite(ppl) and ppl > 1


def test_bodies_match_their_eager_rounds(models):
    """The bodies keep what a round computed before: the windows of the perplexity
    through a caller's ``forward_fn`` (the eager route) give the default's value, and a
    reused, reset cache gives each decode-path window the value it has alone."""
    from lit_llama_ja_tpu_torch.models import llama

    tokens = np.random.default_rng(4).integers(0, 64, 73).astype(np.int32)
    eager = perplexity(models[0], TCFG, tokens, window=24, device="cpu",
                       forward_fn=lambda p, idx, c: llama.forward(p, idx, c, device="cpu"))
    assert perplexity(models[0], TCFG, tokens, window=24, device="cpu") == eager
    both = decode_path_perplexity(models[0], TCFG, tokens, quantize_kv="int8", windows=2,
                                  window=12, device="cpu")
    ix = np.random.default_rng(11).integers(0, len(tokens) - 13, size=2)
    alone = [decode_path_perplexity(models[0], TCFG, tokens[i: i + 13], quantize_kv="int8",
                                    windows=1, window=12, device="cpu") for i in ix]
    np.testing.assert_allclose(both, np.exp(np.mean(np.log(alone))), rtol=1e-6)


def test_adaptive_k_keys_one_graph_per_rung(models, guarded_bodies, monkeypatch):
    """Adaptive K moves over its ladder; every round runs the graph of its (width, K,
    top-k, top-p), one graph a key, and the rounds' K are the keys' K."""
    keys = []
    run = decode_graph.PagedStep.run

    def recorded(self, static, **host):
        keys.append((host["tables"].shape[1], *static))
        return run(self, static, **host)

    monkeypatch.setattr(decode_graph.PagedStep, "run", recorded)
    eng = _chain(models, draft_k=8, adaptive_k=True, k_min=1)
    eng.run([(p, 20) for p in _prompts(2, (5, 7))])
    graphs = eng.decode_step.graphs
    assert set(keys) == set(graphs) and len(keys) == eng.stats()["spec_rounds"]
    rungs = {key[1] for key in graphs}
    assert len(rungs) >= 2 and rungs <= set(eng._k_ladder), (rungs, eng._k_ladder)
    assert guarded_bodies["n"] == len(keys)


def test_tree_constants_are_built_once(models, monkeypatch):
    """A tree engine builds its topology's device constants once, at its start; its
    rounds only read them."""
    built = []
    init = tree_spec.TreeConsts.__init__

    def counted(self, *args, **kwargs):
        built.append(args)
        init(self, *args, **kwargs)

    monkeypatch.setattr(tree_spec.TreeConsts, "__init__", counted)
    eng = _tree(models, tree=(3, 2))
    eng.run([(p, 10) for p in _prompts(2, (6, 4))])
    assert eng.stats()["spec_rounds"] > 1 and len(built) == 1
    consts = eng.tree_consts
    assert consts.depths.tolist() == consts.topo["depths"].tolist()
    assert [lv.tolist() for lv in consts.levels] == [lv.tolist() for lv in consts.topo["levels"]]


@pytest.mark.parametrize("kind", ["spec_generate", "chain", "tree", "stripe"])
def test_sampled_runs_are_seeded(models, kind):
    """A tempered run through each body: the same seed gives the same tokens, another
    seed other tokens, all in the vocabulary."""
    prompts = _prompts(2, (6, 5))

    def run(seed):
        if kind == "spec_generate":
            return [speculative_generate(models[0], TCFG, models[1], DCFG, prompts[0], 12, K=3,
                                         temperature=1.0, top_k=40,
                                         generator=torch.Generator().manual_seed(seed),
                                         device="cpu")]
        if kind == "stripe":
            eng = Engine(models[0], TCFG, max_batch=2, seed=seed, device="cpu")
        else:
            eng = (_chain(models, draft_k=3, seed=seed) if kind == "chain"
                   else _tree(models, tree=(2, 2), seed=seed))
        out = eng.run([(p, 10) for p in prompts], temperature=1.0, top_p=0.9)
        return [out[r] for r in sorted(out)]

    a, b, c = run(1), run(1), run(2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(((x >= 0) & (x < TCFG.vocab_size)).all() for x in a)
