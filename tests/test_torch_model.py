"""Parity of the PyTorch port's LLaMA forward passes with the JAX package's, on the CPU.

One numpy parameter tree (plain f32, or RTN int4 of every linear) feeds both. The
cached forward is driven through a prefill with ``prefill_attn`` and then decode
steps that run past the cache end, so roll-left eviction is exercised, for the fp,
int8 and int4 KV caches. Tolerance: 1e-5 of the largest logit (f32 throughout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import quantize_int4_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import llama as jl

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.models import llama as tl

CFG = dict(block_size=32, vocab_size=96, n_layer=2, n_head=4, n_embd=64)
F32_REL = 1e-5


def assert_close(got, want, rel=F32_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def trees():
    params = jl.init_params(jax.random.PRNGKey(11), JConfig(**CFG))
    return {"fp": params, "int4": quantize_int4_tree(params, tile_cols=32)}


@pytest.mark.parametrize("weights", ["fp", "int4"])
def test_forward_matches(trees, rng, weights):
    ids = rng.integers(0, CFG["vocab_size"], size=(2, 11)).astype(np.int32)
    want = jl.forward(trees[weights], jnp.asarray(ids), JConfig(**CFG))
    got = tl.forward(to_port(trees[weights]), torch.from_numpy(ids).long(),
                     LLaMAConfig(**CFG), device="cpu")
    assert got.shape == want.shape
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("weights", ["fp", "int4"])
@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_forward_with_cache_matches(trees, rng, weights, kv):
    jc, tc = JConfig(**CFG), LLaMAConfig(**CFG)
    S, P, steps = 12, 8, 6  # decode positions 8..13 run past the 12-slot cache
    jp, tp = trees[weights], to_port(trees[weights])
    ids = rng.integers(0, CFG["vocab_size"], size=(1, P + steps)).astype(np.int32)
    jcache = jl.init_kv_cache(jc, 1, S, quantized=kv)
    tcache = tl.init_kv_cache(tc, 1, S, quantized=kv, device="cpu")
    for key in jcache:
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))

    want, jcache = jl.forward_with_cache(
        jp, jnp.asarray(ids[:, :P]), jnp.arange(P, dtype=jnp.int32), jcache, jc,
        prefill_attn=True,
    )
    got, tcache = tl.forward_with_cache(
        tp, torch.from_numpy(ids[:, :P]).long(), torch.arange(P), tcache, tc,
        prefill_attn=True, device="cpu",
    )
    assert_close(got.numpy(), want)
    for pos in range(P, P + steps):
        want, jcache = jl.forward_with_cache(
            jp, jnp.asarray(ids[:, pos : pos + 1]), jnp.array([pos], jnp.int32), jcache, jc
        )
        got, tcache = tl.forward_with_cache(
            tp, torch.from_numpy(ids[:, pos : pos + 1]).long(), torch.tensor([pos]),
            tcache, tc, device="cpu",
        )
        assert_close(got.numpy(), want)
    # the caches agree after the evictions too. Quantized entries may differ by one
    # level where k or v sits on a rounding boundary (the two frameworks' f32
    # projections differ in the last bits); the quantizers themselves are
    # byte-identical on identical inputs (test_torch_ops).
    for key in jcache:
        got, want = tcache[key].numpy(), np.asarray(jcache[key])
        if want.dtype == np.uint8:  # int4: compare the two nibble levels
            got = np.stack([got & 0xF, got >> 4]).astype(np.int16)
            want = np.stack([want & 0xF, want >> 4]).astype(np.int16)
        if want.dtype in (np.int8, np.int16):
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, key
        else:
            assert_close(got, want)


def test_init_params_shapes_and_std():
    tc = LLaMAConfig(**CFG)
    g = torch.Generator().manual_seed(0)
    tp = tl.init_params(g, tc, device="cpu")
    jp = jl.init_params(jax.random.PRNGKey(0), JConfig(**CFG))
    flat_t = {k: v.shape for k, v in _flatten(tp)}
    flat_j = {k: tuple(v.shape) for k, v in _flatten(jp)}
    assert flat_t == flat_j
    assert tl.param_count(tp) == jl.param_count(jp)
    std = 0.02 / (2 * tc.n_layer) ** 0.5
    w = tp["blocks"]["mlp"]["c_fc1"]["weight"]
    assert abs(w.std().item() - std) < 0.05 * std
    assert (tp["blocks"]["rms_1"]["scale"] == 1).all()


def test_normalize_kv_mode():
    for v in (None, False, True, "none", "FP", "bf16", "int8", "INT4"):
        assert tl.normalize_kv_mode(v) == jl.normalize_kv_mode(v)
    with pytest.raises(ValueError):
        tl.normalize_kv_mode("in4")


def test_lora_leaves_raise():
    """LoRA leaves are ported (tests/test_torch_lora.py): a complete set adds the
    branch, and a leaf dict with ``lora_A`` but no ``lora_B`` raises, naming it."""
    x = torch.ones((1, 2, 4))
    leaf = {"weight": torch.zeros((4, 12)), "lora_A": torch.ones((4, 2)),
            "lora_B": torch.ones((2, 1, 4)), "lora_alpha": torch.tensor(2.0)}
    y = tl.apply_linear(leaf, x)
    assert torch.equal(y[..., 4:8], torch.zeros((1, 2, 4)))  # k has no LoRA group
    assert torch.equal(y[..., :4], torch.full((1, 2, 4), 8.0))  # 4 * 1 * alpha / r
    with pytest.raises(KeyError, match="lora_B"):
        tl.apply_linear({"weight": torch.zeros((4, 4)), "lora_A": torch.zeros((4, 2))}, x)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v
