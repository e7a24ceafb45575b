"""Greedy generation of the PyTorch port equals the JAX package's token for token,
on the CPU, for int4 weights and each KV-cache mode: bucketed prefill, roll-left
eviction past the cache and EOS truncation included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_helpers import quantize_int4_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import generate as jgen
from lit_llama_ja_tpu.models import llama as jl

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import generate as tgen

CFG = dict(block_size=48, vocab_size=96, n_layer=2, n_head=4, n_embd=64)


@pytest.fixture(scope="module")
def params():
    p = quantize_int4_tree(jl.init_params(jax.random.PRNGKey(5), JConfig(**CFG)))
    return p, to_port(p)


@pytest.mark.parametrize("n", [1, 16, 17, 100, 1000])
def test_bucket_length(n):
    assert tgen.bucket_length(n) == jgen.bucket_length(n)


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_greedy_tokens_identical(params, rng, kv):
    jp, tp = params
    prompt = rng.integers(0, CFG["vocab_size"], size=(7,)).astype(np.int32)
    # the 16-slot prefill bucket sizes the cache; 14 new tokens run past it
    kw = dict(temperature=0.0, quantize_kv=kv, max_seq_length=12)
    want = np.asarray(jgen.generate(jp, JConfig(**CFG), jnp.asarray(prompt), 14, **kw))
    got = tgen.generate(tp, LLaMAConfig(**CFG), prompt, 14, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32

    eos = int(want[len(prompt) + 3])  # stop at (the first occurrence of) this token
    want_eos = np.asarray(jgen.generate(jp, JConfig(**CFG), jnp.asarray(prompt), 14,
                                        eos_id=eos, **kw))
    got_eos = tgen.generate(tp, LLaMAConfig(**CFG), prompt, 14, eos_id=eos, device="cpu",
                            **kw)
    np.testing.assert_array_equal(got_eos, want_eos)
    assert got_eos[-1] == eos and len(got_eos) <= len(prompt) + 4


def test_default_cache_size_and_sampling_runs(params, rng):
    """Default max_seq_length (min(T + new, block_size)) and a seeded sampled run."""
    import torch

    jp, tp = params
    prompt = rng.integers(0, CFG["vocab_size"], size=(20,)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, JConfig(**CFG), jnp.asarray(prompt), 5,
                                    temperature=0.0))
    got = tgen.generate(tp, LLaMAConfig(**CFG), prompt, 5, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tgen.generate(tp, LLaMAConfig(**CFG), prompt, 5, temperature=0.8, top_k=20,
                      top_p=0.9, generator=g1, device="cpu")
    b = tgen.generate(tp, LLaMAConfig(**CFG), prompt, 5, temperature=0.8, top_k=20,
                      top_p=0.9, generator=g2, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < CFG["vocab_size"] + 32)).all()
