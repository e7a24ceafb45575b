"""The MoE family of the PyTorch port (`lit_llama_ja_tpu_torch/models/moe.py` and its
wiring into checkpoints, `generate` and `PagedEngine`) against the JAX package's
`models/moe.py` on the CPU: the same numpy inputs through both, at the JAX test's tiny
`MoEConfig` (`tests/test_moe.py`) with ample capacity, and at a capacity low enough
that assignments drop.

Tolerances: routing decisions (expert, slot, keep) equal, up to near-ties: a token
whose sorted router probabilities come within ``NEAR_TIE`` of each other around the
k-th place could flip between frameworks whose f32 products differ in the last ulp;
such tokens are counted and excluded, and none may show at these seeds. Gates and
routing statistics within 1e-6 (relative and absolute); logits and aux losses rtol 1e-4 / atol 1e-5 (f32 on
both sides, summed in other orders); one AdamW step's parameters within the dense
train parity's 1e-4; greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.infer.generate import generate as j_generate
from lit_llama_ja_tpu.infer.paged import PagedEngine as JPagedEngine
from lit_llama_ja_tpu.models import moe as jmoe
from lit_llama_ja_tpu.models.llama import init_kv_cache as j_init_kv_cache
from lit_llama_ja_tpu.train import step as jstep
from lit_llama_ja_tpu.train.lr import cosine_with_warmup as j_cosine

from lit_llama_ja_tpu_torch.infer.generate import generate
from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
from lit_llama_ja_tpu_torch.io.checkpoint import (
    flatten_tree,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import moe
from lit_llama_ja_tpu_torch.models.llama import cast_params, init_kv_cache
from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
from lit_llama_ja_tpu_torch.train.step import cast_floating, init_opt_state, make_adamw

from torch_port_helpers import flat_numpy

CFG = dict(block_size=16, vocab_size=96, n_layer=2, n_head=2, n_embd=16, n_expert=8,
           n_expert_active=2)
CAPACITY = {"ample": 8.0, "drop": 0.5}  # 0.5: 8 slots an expert for 64 assignments
NEAR_TIE = 1e-6
B, T = 2, 16
# one compiled program each, not one compile an eager op
j_route_tokens = jax.jit(jmoe.route_tokens, static_argnums=(2, 3))
j_moe_mlp = jax.jit(jmoe.moe_mlp, static_argnums=(2,))


def _configs(capacity):
    kw = dict(CFG, capacity_factor=CAPACITY[capacity])
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _tree(seed=0):
    """A numpy MoE tree in the shared layout: weights N(0, 0.1), the f32 router
    N(0, 1) (decisive routes), RMSNorm scales around 1."""
    rng = np.random.default_rng(seed)
    cfg = moe.MoEConfig(**CFG)
    L, D, H, V, E = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.padded_vocab_size, cfg.n_expert

    def w(*shape, std=0.1):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def scale(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "wte": {"weight": w(V, D, std=1.0)},
        "lm_head": {"weight": w(D, V)},
        "ln_f": {"scale": scale(D)},
        "blocks": {
            "rms_1": {"scale": scale(L, D)},
            "attn": {"c_attn": {"weight": w(L, D, 3 * D)}, "c_proj": {"weight": w(L, D, D)}},
            "rms_2": {"scale": scale(L, D)},
            "moe": {"router": {"weight": w(L, D, E, std=1.0)},
                    "c_fc1": {"weight": w(L, E, D, H)}, "c_fc2": {"weight": w(L, E, D, H)},
                    "c_proj": {"weight": w(L, E, H, D)}},
        },
    }


@pytest.fixture(scope="module")
def trees():
    tree = _tree()
    return tree, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


def _layer(tree, l=0):
    return jax.tree.map(lambda a: a[l], tree["blocks"]["moe"])


def _near_ties(probs, k):
    """Tokens whose sorted probabilities around the top k lie within NEAR_TIE."""
    s = -np.sort(-probs, axis=-1)[:, : k + 1]
    return np.min(s[:, :-1] - s[:, 1:], axis=-1) < NEAR_TIE


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_route_tokens_matches_jax(capacity, rng):
    jcfg, cfg = _configs(capacity)
    router = rng.standard_normal((16, 8)).astype(np.float32)
    xf = rng.standard_normal((B * T, 16)).astype(np.float32)
    k, C = cfg.n_expert_active, cfg.capacity(B * T)
    assert C == jcfg.capacity(B * T)
    jgate, jexp, jpos, jkeep, jstats = j_route_tokens(jnp.asarray(router), jnp.asarray(xf), k, C)
    gate, exp, pos, keep, stats = moe.route_tokens(torch.from_numpy(router),
                                                   torch.from_numpy(xf), k, C)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    near = _near_ties(np.asarray(probs), k)
    assert not near.any(), f"{int(near.sum())} near-ties at this seed"
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=0, atol=1e-6)
    for key in jstats:
        np.testing.assert_allclose(stats[key].numpy(), np.asarray(jstats[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    assert (float(stats["dropped"]) > 0) == (capacity == "drop")


def test_route_ties_go_to_the_lower_expert():
    """Equal router probabilities (a zero router): both packages pick experts 0 and 1,
    in that order, for every token, and fill their slots in k-major order."""
    _, cfg = _configs("ample")
    xf = np.random.default_rng(1).standard_normal((B * T, 16)).astype(np.float32)
    router = np.zeros((16, 8), np.float32)
    C = cfg.capacity(B * T)  # the shapes of test_route_tokens_matches_jax[ample]
    want = j_route_tokens(jnp.asarray(router), jnp.asarray(xf), 2, C)
    got = moe.route_tokens(torch.from_numpy(router), torch.from_numpy(xf), 2, C)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy(), np.tile([0, 1], (B * T, 1)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_mlp_matches_jax(trees, capacity, rng):
    tree, jtree, ttree = trees
    jcfg, cfg = _configs(capacity)
    x = rng.standard_normal((B, T, 16)).astype(np.float32)
    jy, jaux = j_moe_mlp(_layer(jtree), jnp.asarray(x), jcfg)
    y, aux = moe.moe_mlp({k: {n: t[0] for n, t in v.items()}
                          for k, v in ttree["blocks"]["moe"].items()}, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    if capacity == "drop":
        assert float(aux["dropped"]) > 0


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_forward_moe_matches_jax(trees, capacity, rng):
    tree, jtree, ttree = trees
    jcfg, cfg = _configs(capacity)
    idx = rng.integers(0, CFG["vocab_size"], (B, T))
    jlogits, jaux = jmoe.forward_moe(jtree, jnp.asarray(idx, jnp.int32), jcfg)
    for remat in (False, True):
        logits, aux = moe.forward_moe(ttree, torch.from_numpy(idx), cfg, device="cpu",
                                      remat=remat)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
        for key in jaux:
            np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_forward_moe_with_cache_matches_jax(trees, rng):
    """A prefill of 5 tokens, then 3 single-token steps; every step's logits."""
    tree, jtree, ttree = trees
    jcfg, cfg = _configs("ample")
    ids = rng.integers(0, CFG["vocab_size"], (1, 8))
    jcache = j_init_kv_cache(jcfg, 1, 8)
    cache = init_kv_cache(cfg, 1, 8, device="cpu")
    spans = [(0, 5), (5, 6), (6, 7), (7, 8)]
    for a, b in spans:
        pos = np.arange(a, b)
        jl, jcache = jmoe.forward_moe_with_cache(
            jtree, jnp.asarray(ids[:, a:b], jnp.int32), jnp.asarray(pos, jnp.int32), jcache,
            jcfg, prefill_attn=a == 0)
        tl, cache = moe.forward_moe_with_cache(
            ttree, torch.from_numpy(ids[:, a:b]), torch.from_numpy(pos), cache, cfg,
            prefill_attn=a == 0, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_loss_matches_jax(trees, capacity, rng):
    tree, jtree, ttree = trees
    jcfg, cfg = _configs(capacity)
    seq = rng.integers(0, CFG["vocab_size"], (B, T + 1))
    jtotal, jparts = jmoe.moe_loss(jtree, jnp.asarray(seq[:, :-1], jnp.int32),
                                   jnp.asarray(seq[:, 1:], jnp.int32), jcfg)
    total, parts = moe.moe_loss(ttree, torch.from_numpy(seq[:, :-1]),
                                torch.from_numpy(seq[:, 1:]), cfg, device="cpu")
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for key in jparts:
        np.testing.assert_allclose(float(parts[key]), float(jparts[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def test_moe_train_step_matches_jax(trees, rng):
    """Two optimizer steps of two micro-batches (update 0 runs at schedule(0) = 0):
    the losses and every parameter, router and experts included."""
    tree, jtree, _ = trees
    jcfg, cfg = _configs("drop")
    batches = [rng.integers(0, CFG["vocab_size"], (2, B, T + 1)) for _ in range(2)]

    jopt = jstep.make_adamw(j_cosine(1e-2, 1, 2, 1e-3))
    jtrain = jax.jit(jmoe.make_moe_train_step(jcfg, jopt))
    jparams, jstate = jtree, jstep.init_opt_state(jopt, jtree)
    opt = make_adamw(cosine_with_warmup(1e-2, 1, 2, 1e-3))
    train = moe.make_moe_train_step(cfg, opt, device="cpu")
    params = params_from_numpy(tree, device="cpu")
    state = init_opt_state(opt, params)
    for b in batches:
        jparams, jstate, jloss = jtrain(jparams, jstate, jnp.asarray(b, jnp.int32))
        params, state, loss = train(params, state, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flat_numpy(jparams)
    for path, got in flat_numpy(params).items():
        assert np.abs(want[path] - flat_numpy(tree)[path]).max() > 0, path
        np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-4, err_msg=path)


def test_compute_dtype_keeps_the_router_f32(trees):
    _, _, ttree = trees
    for cast in (cast_floating, cast_params):
        out = cast(ttree, torch.bfloat16)
        assert out["blocks"]["moe"]["router"]["weight"].dtype == torch.float32
        assert out["blocks"]["moe"]["c_fc1"]["weight"].dtype == torch.bfloat16


def test_checkpoint_round_trip_is_an_moe_config(trees, tmp_path):
    _, _, ttree = trees
    _, cfg = _configs("drop")
    save_checkpoint(tmp_path / "ckpt", ttree, cfg)
    params, loaded = load_checkpoint(tmp_path / "ckpt", device="cpu")
    assert isinstance(loaded, moe.MoEConfig) and loaded == cfg
    for path, v in flat_numpy(ttree).items():
        np.testing.assert_array_equal(flat_numpy(params)[path], v)
    opt = make_adamw(1e-3)
    save_train_state(tmp_path / "state", ttree, init_opt_state(opt, ttree), cfg, {"iter": 3})
    params, state, loaded, meta = load_train_state(tmp_path / "state", device="cpu")
    assert loaded == cfg and meta == {"iter": 3}
    assert set(flat_numpy(state["mu"])) == set(flat_numpy(ttree))


def test_generate_matches_jax(trees, rng):
    _, jtree, ttree = trees
    jcfg, cfg = _configs("drop")  # the decode capacity ignores capacity_factor
    for n in (5, 11):
        prompt = rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
        want = j_generate(jtree, jcfg, jnp.asarray(prompt), 6, temperature=0.0)
        got = generate(ttree, cfg, prompt, 6, temperature=0.0, device="cpu")
        np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_engine_matches_jax(trees, rng):
    """Three requests on two slots over an int8 pool (the serve CLI's K7 path, its plain
    version here): the port's engine serves the JAX engine's tokens."""
    _, jtree, ttree = trees
    jcfg, cfg = _configs("ample")
    prompts = [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32) for n in (5, 3, 7)]
    kw = dict(max_batch=2, n_pages=24, page_size=4)
    want = JPagedEngine(jtree, jcfg, quantize_kv=True, **kw).run([(p, 4) for p in prompts])
    got = PagedEngine(ttree, cfg, quantize_kv="int8", device="cpu", **kw).run(
        [(p, 4) for p in prompts])
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_params_from_numpy_carries_an_moe_tree():
    """A tree from the JAX package's `init_moe_params`: the router stays f32 and the
    expert stacks keep their (L, E, D, H) / (L, E, H, D) shapes."""
    jcfg, cfg = _configs("ample")
    jtree = jax.jit(jmoe.init_moe_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                                                  jnp.bfloat16)
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    L, E, D, H = cfg.n_layer, cfg.n_expert, cfg.n_embd, cfg.n_hidden
    m = tree["blocks"]["moe"]
    assert m["router"]["weight"].dtype == torch.float32
    assert m["router"]["weight"].shape == (L, D, E)
    assert m["c_fc1"]["weight"].shape == m["c_fc2"]["weight"].shape == (L, E, D, H)
    assert m["c_proj"]["weight"].shape == (L, E, H, D)
    assert m["c_fc1"]["weight"].dtype == torch.bfloat16
    ours = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                               device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in flatten_tree(ours).items()} == \
        {k: (v.shape, v.dtype) for k, v in flatten_tree(tree).items()}


def test_entry_points_need_the_card_unless_asked_for_the_cpu(trees, monkeypatch):
    _, _, ttree = trees
    _, cfg = _configs("ample")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids = torch.zeros((1, 3), dtype=torch.long)
    cache = init_kv_cache(cfg, 1, 4, device="cpu")
    calls = [
        lambda: moe.init_moe_params(torch.Generator().manual_seed(0), cfg),
        lambda: moe.forward_moe(ttree, ids, cfg),
        lambda: moe.forward_moe_with_cache(ttree, ids, torch.arange(3), cache, cfg),
        lambda: moe.moe_loss(ttree, ids, ids, cfg),
        lambda: moe.make_moe_train_step(cfg, make_adamw(1e-3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_quantizing_an_moe_checkpoint_raises_in_both_packages(trees, tmp_path, monkeypatch):
    """The JAX package's `load_model_any` quantizes the dense linears by name and finds
    no ``mlp`` in an MoE tree: KeyError('mlp') (LLM.int8 here; its GPTQ/RTN modes stop
    at the same lookup). The port keeps it, in both kinds of mode (ROADMAP.md, queue 3).
    The JAX side reads the tree from a stand-in of its Orbax `load_checkpoint`."""
    from lit_llama_ja_tpu.cli.generate_cli import load_model_any as j_load_model_any
    from lit_llama_ja_tpu.io import checkpoint as jckpt

    from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any

    _, jtree, ttree = trees
    jcfg, cfg = _configs("ample")
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda path: (jtree, jcfg))
    save_checkpoint(tmp_path / "port", ttree, cfg)
    with pytest.raises(KeyError, match="mlp"):
        j_load_model_any(tmp_path, "llm.int8")
    for mode in ("gptq.int4", "llm.int8"):
        with pytest.raises(KeyError, match="mlp"):
            load_model_any(tmp_path / "port", mode, device="cpu")
