"""Generation and evaluation of the PyTorch port through the int8, int2, int3 and mixed
packs, against the JAX package on the CPU.

Greedy tokens must equal the JAX package's token for token. Perplexities agree within
1e-4 relative (f32 on both sides), except through the int4 KV cache: 1e-3, because a
k or v entry on a rounding boundary may quantize one level apart in the two packages
(ROADMAP.md, queue 3). The perplexities run their window and token bodies under
`torch_port_helpers.guarded_bodies`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_helpers import guarded_bodies, quantize_rtn_tree, to_port  # noqa: F401

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import evaluate as jeval
from lit_llama_ja_tpu.infer import generate as jgen
from lit_llama_ja_tpu.models import llama as jl
from lit_llama_ja_tpu.quant import pipeline as jpipe

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import evaluate as teval
from lit_llama_ja_tpu_torch.infer import generate as tgen

CFG = dict(block_size=48, vocab_size=96, n_layer=2, n_head=4, n_embd=64)
PPL_REL = 1e-4
PPL_INT4_KV_REL = 1e-3
MIX = {"attn": 4, "mlp": 2, "head": 4}


@pytest.fixture(scope="module")
def fp_params():
    return jl.init_params(jax.random.PRNGKey(5), JConfig(**CFG))


def _tree(fp, kind):
    if kind == "int8":
        return jpipe.int8_quantize_model(fp, outliers=True)
    if kind == "int8-dyn":
        return jpipe.int8_quantize_model(fp, outliers="dynamic")
    if kind == "mix":
        return quantize_rtn_tree(fp, MIX, 32)
    return quantize_rtn_tree(fp, {"int2": 2, "int3": 3, "int2-g32": 2}[kind],
                             32 if kind.endswith("g32") else -1)


@pytest.mark.parametrize("kind", ["int8", "int8-dyn", "int2", "int2-g32", "int3", "mix"])
def test_greedy_tokens_identical(fp_params, rng, kind):
    jp = _tree(fp_params, kind)
    tp = to_port(jp)
    prompt = rng.integers(0, CFG["vocab_size"], size=(7,)).astype(np.int32)
    kw = dict(temperature=0.0, max_seq_length=12)  # 14 new tokens run past the cache
    want = np.asarray(jgen.generate(jp, JConfig(**CFG), jnp.asarray(prompt), 14, **kw))
    got = tgen.generate(tp, LLaMAConfig(**CFG), prompt, 14, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stream():
    return np.random.default_rng(7).integers(0, CFG["vocab_size"], size=(120,)).astype(np.int32)


@pytest.mark.parametrize("kind", ["fp", "int8", "int3"])
def test_perplexity_matches(fp_params, stream, guarded_bodies, kind):
    jp = fp_params if kind == "fp" else _tree(fp_params, kind)
    want = jeval.perplexity(jp, JConfig(**CFG), stream, window=32)
    got = teval.perplexity(to_port(jp), LLaMAConfig(**CFG), stream, window=32, device="cpu")
    np.testing.assert_allclose(got, want, rtol=PPL_REL)
    assert guarded_bodies["n"] == (len(stream) - 1) // 32  # a body a window


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_decode_path_perplexity_matches(fp_params, stream, guarded_bodies, kv):
    jp = _tree(fp_params, "int2-g32")
    kw = dict(quantize_kv=kv, windows=2, window=16)
    want = jeval.decode_path_perplexity(jp, JConfig(**CFG), stream, **kw)
    got = teval.decode_path_perplexity(to_port(jp), LLaMAConfig(**CFG), stream, device="cpu",
                                       **kw)
    np.testing.assert_allclose(got, want, rtol=PPL_INT4_KV_REL if kv == "int4" else PPL_REL)
    assert guarded_bodies["n"] == 2 * 16  # a body a token


def test_decode_path_perplexity_needs_a_window():
    with pytest.raises(ValueError, match="window\\+1"):
        teval.decode_path_perplexity({}, LLaMAConfig(**CFG), np.zeros(8, np.int32), window=16,
                                     device="cpu")
