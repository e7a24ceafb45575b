"""Parity of the port's `models/adapter.py` (LLaMA-Adapter v1 and v2) with the JAX
package's, on the CPU.

The adapter leaves are drawn with numpy from a seed, with nonzero gating (zero-init
gating would hide the prefix branch), and carried into both packages. Tolerance for
f32 forwards: ``atol = 1e-5 * max|want|``. The int4 base is the JAX package's RTN
quantization of the same tree (`torch_port_helpers.quantize_int4_tree`), which both
packages dequantize exactly on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import flat_numpy, quantize_int4_tree, random_tree, to_port

from lit_llama_ja_tpu.models import adapter as jad
from lit_llama_ja_tpu.models import llama as jl

from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import adapter as tad
from lit_llama_ja_tpu_torch.models import llama as tl

CFG = dict(block_size=16, vocab_size=64, n_layer=3, n_head=4, n_embd=32,
           adapter_prompt_length=5, adapter_start_layer=1)


def adapter_leaves(rng, cfg):
    return {"adapter_wte": rng.standard_normal(
                (cfg["n_layer"], cfg["adapter_prompt_length"], cfg["n_embd"])).astype(np.float32),
            "gating_factor": (rng.standard_normal((cfg["n_layer"], cfg["n_head"])) * 0.5
                              ).astype(np.float32)}


def v2_leaves(rng, tree):
    """Random scales around 1 and biases around 0 on every linear of a v2 tree."""
    out = jax.tree.map(np.asarray, tree)
    for path in [("blocks", m, n) for m, n in tad.V2_LINEARS] + [("lm_head",)]:
        node = out
        for p in path:
            node = node[p]
        node["adapter_scale"] = (1 + 0.2 * rng.standard_normal(node["adapter_scale"].shape)
                                 ).astype(np.float32)
        node["adapter_bias"] = (0.1 * rng.standard_normal(node["adapter_bias"].shape)
                                ).astype(np.float32)
    return out


def configs(**kw):
    cfg = {**CFG, **kw}
    return jad.AdapterConfig(**cfg), tad.AdapterConfig(**cfg)


def base_tree(rng):
    jcfg, _ = configs()
    return random_tree(rng, jcfg.n_layer, jcfg.n_embd, jcfg.n_hidden, jcfg.vocab_size)


def close(got, want):
    got, want = got.detach().float().numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def both(tree):
    return jax.tree.map(jnp.asarray, tree), to_port(tree)


@pytest.mark.parametrize("base", ["fp", "int4"])
def test_v1_forward_matches_jax(rng, base):
    jcfg, tcfg = configs()
    tree = base_tree(rng)
    if base == "int4":
        tree = jax.tree.map(np.asarray, quantize_int4_tree(jax.tree.map(jnp.asarray, tree)))
    tree = jad.add_adapter(tree, adapter_leaves(rng, CFG))
    jt, tt = both(tree)
    idx = rng.integers(0, CFG["vocab_size"], (2, 11))
    want = jad.adapter_forward(jt, jnp.asarray(idx), jcfg)
    got = tad.adapter_forward(tt, torch.as_tensor(idx), tcfg, device="cpu")
    close(got, want)


def test_layers_below_the_start_layer_are_unchanged(rng):
    """With the start layer past the last layer the adapter forward is the plain
    forward; with start layer 1, layer 0's gating changes nothing."""
    tree = jad.add_adapter(base_tree(rng), adapter_leaves(rng, CFG))
    _, tt = both(tree)
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (2, 11)))
    _, off = configs(adapter_start_layer=CFG["n_layer"])
    plain_cfg = tl.LLaMAConfig(**{f.name: getattr(off, f.name)
                                  for f in dataclasses.fields(tl.LLaMAConfig)})
    plain = tl.forward({k: v for k, v in tt.items()}, idx, plain_cfg, device="cpu")
    assert torch.equal(tad.adapter_forward(tt, idx, off, device="cpu"), plain)
    _, tcfg = configs()
    a = tad.adapter_forward(tt, idx, tcfg, device="cpu")
    tt["blocks"]["adapter"]["gating_factor"][0] += 5.0
    assert torch.equal(tad.adapter_forward(tt, idx, tcfg, device="cpu"), a)
    tt["blocks"]["adapter"]["gating_factor"][1] += 5.0
    assert not torch.equal(tad.adapter_forward(tt, idx, tcfg, device="cpu"), a)


@pytest.mark.parametrize("v2", [False, True])
def test_forward_with_cache_matches_jax(rng, v2):
    """A prefill with ``prefill_attn`` and 6 decode steps, the last 3 past the end of
    a 14-slot cache (roll-left eviction)."""
    jcfg, tcfg = configs()
    tree = jad.add_adapter(base_tree(rng), adapter_leaves(rng, CFG))
    if v2:
        tree = v2_leaves(rng, jad.add_adapter_v2(jax.tree.map(jnp.asarray, tree)))
    jt, tt = both(tree)
    B, T, S = 2, 11, 14
    jc = jl.init_kv_cache(jcfg, B, S, jnp.float32)
    tc = tl.init_kv_cache(tcfg, B, S, device="cpu")
    idx = rng.integers(0, CFG["vocab_size"], (B, T))
    want, jc = jad.adapter_forward_with_cache(jt, jnp.asarray(idx), jnp.arange(T), jc, jcfg,
                                              prefill_attn=True)
    got, tc = tad.adapter_forward_with_cache(tt, torch.as_tensor(idx), torch.arange(T), tc,
                                             tcfg, prefill_attn=True, device="cpu")
    close(got, want)
    for pos in range(T, T + 6):
        tok = rng.integers(0, CFG["vocab_size"], (B, 1))
        want, jc = jad.adapter_forward_with_cache(jt, jnp.asarray(tok), jnp.asarray([pos]), jc,
                                                  jcfg)
        got, tc = tad.adapter_forward_with_cache(tt, torch.as_tensor(tok), torch.tensor([pos]),
                                                 tc, tcfg, device="cpu")
        close(got, want)
    close(tc["k"], jc["k"])


def test_v2_forward_matches_jax(rng):
    jcfg, tcfg = configs()
    tree = jad.add_adapter(base_tree(rng), adapter_leaves(rng, CFG))
    tree = v2_leaves(rng, jad.add_adapter_v2(jax.tree.map(jnp.asarray, tree)))
    jt, tt = both(tree)
    idx = rng.integers(0, CFG["vocab_size"], (2, 11))
    close(tad.adapter_forward(tt, torch.as_tensor(idx), tcfg, device="cpu"),
          jad.adapter_forward(jt, jnp.asarray(idx), jcfg))


def test_v2_at_init_is_the_v1_model(rng):
    _, tcfg = configs()
    tt = to_port(jad.add_adapter(base_tree(rng), adapter_leaves(rng, CFG)))
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (2, 11)))
    torch.testing.assert_close(tad.adapter_forward(tad.add_adapter_v2(tt), idx, tcfg, device="cpu"),
                               tad.adapter_forward(tt, idx, tcfg, device="cpu"), rtol=0, atol=0)


def test_extracted_states_match_jax(rng):
    tree = jad.add_adapter(base_tree(rng), adapter_leaves(rng, CFG))
    jt, tt = both(tree)
    for fn in ("extract_adapter_state", "extract_adapter_v2_state"):
        j, t = jt, tt
        if fn.endswith("v2_state"):
            j, t = jad.add_adapter_v2(jt), tad.add_adapter_v2(tt)
        got, want = getattr(tad, fn)(t), getattr(jad, fn)(j)
        assert sorted(got) == sorted(want), fn
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for path in ("blocks/rms_1/scale", "ln_f/scale", "blocks/attn/c_attn/adapter_bias",
                 "blocks/adapter/gating_factor", "lm_head/adapter_scale", "wte/weight",
                 "blocks/attn/c_attn/weight", "blocks/adapter/adapter_wte"):
        assert tad.adapter_v2_trainable(path) == jad.adapter_v2_trainable(path), path
        assert tad.adapter_trainable(path) == jad.adapter_trainable(path), path


def test_v2_on_a_quantized_base_raises_in_both_packages(rng):
    """The reference sizes v2's leaves from each linear's plain weight: an int4 tree
    has none, and both packages raise KeyError('weight')."""
    q = quantize_int4_tree(jax.tree.map(jnp.asarray, base_tree(rng)))
    with pytest.raises(KeyError, match="weight"):
        jad.add_adapter_v2(q)
    with pytest.raises(KeyError, match="weight"):
        tad.add_adapter_v2(to_port(q))


def test_init_adapter_params_shapes_and_draw():
    jcfg, tcfg = configs(adapter_prompt_length=40, n_embd=64)
    p = tad.init_adapter_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    j = jad.init_adapter_params(jax.random.PRNGKey(0), jcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        k: (v.shape, torch.float32) for k, v in j.items()}
    assert torch.all(p["gating_factor"] == 0)
    w = p["adapter_wte"]
    assert abs(w.mean().item()) < 0.05 and abs(w.std().item() - 1) < 0.05


def test_jax_adapter_trees_arrive_leaf_for_leaf(rng):
    """`io/from_jax.params_from_numpy` carries v1 and v2 trees as they are."""
    tree = jad.add_adapter(base_tree(rng), adapter_leaves(rng, CFG))
    jt = v2_leaves(rng, jad.add_adapter_v2(jax.tree.map(jnp.asarray, tree)))
    got = flat_numpy(params_from_numpy(jt, device="cpu"))
    want = flat_numpy(jt)
    assert sorted(got) == sorted(want)
    assert "blocks/adapter/adapter_wte" in got and "lm_head/adapter_bias" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
