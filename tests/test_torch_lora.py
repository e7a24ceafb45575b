"""Parity of the port's `models/lora.py` and the LoRA path of `models/llama.py` with the
JAX package's, on the CPU.

The LoRA leaves are drawn with numpy from a seed (B nonzero, so the branch shows) and
carried into both packages, whose PRNGs differ; `init_lora_params` is checked for its
shapes and bounds alone. Tolerance for f32 forwards: ``atol = 1e-5 * max|want|``.
Dropout is the port's own draw: it is checked for repeatability and its keep share,
never against JAX's PRNG.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import flat_numpy, random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import llama as jl
from lit_llama_ja_tpu.models import lora as jlora

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import llama as tl
from lit_llama_ja_tpu_torch.models import lora as tlora

CFG = dict(block_size=16, vocab_size=64, n_layer=3, n_head=4, n_embd=32)
R = 2


def lora_leaves(rng, L, D, r=R, g=2, alpha=4.0):
    return {"lora_A": (rng.standard_normal((L, D, g * r)) * 0.2).astype(np.float32),
            "lora_B": (rng.standard_normal((L, g, r, D)) * 0.2).astype(np.float32),
            "lora_alpha": np.full((L,), alpha, np.float32)}


@pytest.fixture
def trees(rng):
    config = LLaMAConfig(**CFG)
    base = random_tree(rng, config.n_layer, config.n_embd, config.n_hidden, config.vocab_size)
    tree = jlora.add_lora(base, lora_leaves(rng, config.n_layer, config.n_embd))
    return tree, jax.tree.map(jnp.asarray, tree), to_port(tree)


def close(got, want):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("enable", [(True, False, True), (True, True, True), (False, True, False)])
def test_lora_branch_matches_jax(rng, enable):
    D, g = 32, sum(enable)
    leaf = {k: v[0] for k, v in lora_leaves(rng, 1, D, g=g).items()}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    want = jlora.lora_branch(jax.tree.map(jnp.asarray, leaf), jnp.asarray(x), enable)
    got = tlora.lora_branch(params_from_numpy(leaf, "cpu"), torch.from_numpy(x), enable)
    assert got.shape == (2, 5, 3 * D)
    close(got, want)


def test_merge_extract_strip_match_jax(trees):
    _, jt, tt = trees
    for fn in ("merge_lora", "extract_lora", "strip_lora"):
        got, want = flat_numpy(getattr(tlora, fn)(tt)), flat_numpy(getattr(jlora, fn)(jt))
        assert sorted(got) == sorted(want), fn
        for k in want:
            close(got[k], want[k])
    assert "lora_A" in tt["blocks"]["attn"]["c_attn"]  # the input tree is left as it was


def test_forward_with_lora_matches_jax_and_the_merge(trees, rng):
    _, jt, tt = trees
    idx = rng.integers(0, CFG["vocab_size"], (2, 12))
    want = jl.forward(jt, jnp.asarray(idx), JConfig(**CFG))
    got = tl.forward(tt, torch.as_tensor(idx), LLaMAConfig(**CFG), device="cpu")
    close(got, want)
    merged = tl.forward(tlora.merge_lora(tt), torch.as_tensor(idx), LLaMAConfig(**CFG),
                        device="cpu")
    close(merged, want)


def test_lora_touches_q_and_v_only(trees, rng):
    _, _, tt = trees
    D = CFG["n_embd"]
    c_attn = {k: v[1] for k, v in tt["blocks"]["attn"]["c_attn"].items()}
    x = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    delta = tl.apply_linear(c_attn, x) - x @ c_attn["weight"]
    q, k, v = delta.split(D, dim=-1)
    assert q.abs().max() > 1e-3 and v.abs().max() > 1e-3
    assert torch.all(k == 0)
    w_delta = tlora.merge_lora(tt)["blocks"]["attn"]["c_attn"]["weight"] - \
        tt["blocks"]["attn"]["c_attn"]["weight"]
    assert torch.all(w_delta[..., D:2 * D] == 0) and w_delta[..., :D].abs().max() > 0


def test_dropout_off_is_no_dropout(trees, rng):
    _, _, tt = trees
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (2, 12)))
    cfg = LLaMAConfig(**CFG)
    plain = tl.forward(tt, idx, cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(tl.forward(tt, idx, cfg, device="cpu", dropout_generator=gen,
                                  dropout_rate=0.0), plain)
    assert torch.equal(tl.forward(tt, idx, cfg, device="cpu", dropout_rate=0.5), plain)


def test_dropout_is_repeatable_and_keeps_its_share():
    """A = I and B = I on the q section expose the branch's input after dropout: each
    entry of a ones input is 0 or 1 / (1 - rate); one seed gives one mask, another seed
    another, and the kept share is within 5 sigma of the binomial's."""
    D, r, rate = 32, 16, 0.3
    B = torch.zeros((2, r, D))
    B[0, :, :r] = torch.eye(r)
    leaf = {"lora_A": torch.eye(D), "lora_B": B, "lora_alpha": torch.tensor(float(r))}
    x = torch.ones((8, 50, D))

    def branch_input(seed):
        drawn = tlora.draw_seeds(torch.Generator().manual_seed(seed), ())
        return tlora.lora_branch(leaf, x, dropout_seed=drawn, dropout_rate=rate)[..., :r]

    a, b, c = branch_input(7), branch_input(7), branch_input(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / (1 - rate)))
    share, n = kept.float().mean().item(), kept.numel()
    assert abs(share - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5, share


def test_dropout_is_the_same_under_remat(trees, rng):
    """A recomputed block draws its mask again from its layer's seed: with one
    generator seed the logits and the LoRA gradients are the same with and without
    remat, and differ from the forward without dropout."""
    _, _, tt = trees
    cfg = LLaMAConfig(**CFG)
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (2, 12)))
    c_attn = tt["blocks"]["attn"]["c_attn"]
    leaves = [c_attn["lora_A"].requires_grad_(True), c_attn["lora_B"].requires_grad_(True)]
    out = []
    for remat in (False, True):
        logits = tl.forward(tt, idx, cfg, device="cpu", remat=remat, dropout_rate=0.4,
                            dropout_generator=torch.Generator().manual_seed(5))
        grads = torch.autograd.grad(logits.square().mean(), leaves)
        out.append((logits.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert torch.equal(g0, g1)
    with torch.no_grad():
        assert not torch.equal(tl.forward(tt, idx, cfg, device="cpu"), out[0][0])


def test_init_lora_params_shapes_and_bounds():
    cfg = LLaMAConfig(**CFG)
    p = tlora.init_lora_params(torch.Generator().manual_seed(0), cfg, r=4, alpha=8.0,
                               device="cpu")
    L, D = cfg.n_layer, cfg.n_embd
    assert p["lora_A"].shape == (L, D, 2 * 4) and p["lora_A"].dtype == torch.float32
    assert p["lora_B"].shape == (L, 2, 4, D) and torch.all(p["lora_B"] == 0)
    assert torch.equal(p["lora_alpha"], torch.full((L,), 8.0))
    bound = 1 / D ** 0.5
    a = p["lora_A"]
    assert a.abs().max() <= bound and a.min() < -0.9 * bound and a.max() > 0.9 * bound
    assert abs(a.mean().item()) < 0.1 * bound
    j = jlora.init_lora_params(jax.random.PRNGKey(0), JConfig(**CFG), r=4, alpha=8.0)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in j.items()}


def test_jax_lora_tree_arrives_leaf_for_leaf(trees):
    """`io/from_jax.params_from_numpy` carries a JAX tree with LoRA leaves as it is."""
    _, jt, _ = trees
    got = params_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    want = flat_numpy(jt)
    flat = flat_numpy(got)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
