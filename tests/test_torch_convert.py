"""The PyTorch port's checkpoint converters against the JAX package's
(`lit_llama_ja_tpu/io/convert.py`, whose own tests are the oracle), on the CPU.

The same numpy state dicts go to both; the port returns torch tensors where the JAX
package returns numpy arrays, and the values agree exactly. Load-time quantization
is compared byte for byte, except ``llm.int8-dyn``, which the JAX package's streaming
loader rejects (ROADMAP.md, queue 3): the port's streamed tree is compared with its
own `quantize_int8_dynamic` applied after loading.
"""
import numpy as np
import pytest
import torch
from torch_port_helpers import flat_numpy, random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.io import convert as jconv

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.io import convert as tconv
from lit_llama_ja_tpu_torch.quant.pipeline import int8_quantize_model

CFG = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=32)


@pytest.fixture(scope="module")
def lit_sd():
    """A lit-llama state dict of numpy arrays (from the JAX package's exporter)."""
    cfg = JConfig(**CFG)
    tree = random_tree(np.random.default_rng(4), cfg.n_layer, cfg.n_embd, cfg.n_hidden,
                       cfg.padded_vocab_size)
    return {k: np.asarray(v, np.float32) for k, v in jconv.native_to_lit_state_dict(tree).items()}


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def assert_trees_equal(got, want):
    g, w = flat_numpy(got), flat_numpy(want)
    assert set(g) == set(w)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def assert_quantized_equal(got, want):
    """Leaf for leaf, in the stored dtype."""
    g, w = _flat(got), _flat(to_port(want))
    assert set(g) == set(w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        assert torch.equal(g[key], w[key]), key


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_lit_to_native_and_back(lit_sd):
    got, cfg = tconv.lit_state_dict_to_native(_torch_sd(lit_sd), LLaMAConfig(**CFG))
    want, _ = jconv.lit_state_dict_to_native(lit_sd, JConfig(**CFG))
    assert cfg == LLaMAConfig(**CFG)
    assert got["blocks"]["attn"]["c_attn"]["weight"].dtype == torch.float32
    assert_trees_equal(got, want)
    back = tconv.native_to_lit_state_dict(got)
    assert set(back) == set(lit_sd)
    for k, v in lit_sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("mode", ["llm.int8", "llm.int8-rtn", "gptq.int4", "rtn.int3-g32",
                                  "gptq.int8", "gptq.mix-g32"])
def test_streaming_quantized_load_matches_jax(lit_sd, mode):
    got, _ = tconv.lit_state_dict_to_native(_torch_sd(lit_sd), LLaMAConfig(**CFG),
                                            quantize=mode)
    want, _ = jconv.lit_state_dict_to_native(lit_sd, JConfig(**CFG), quantize=mode)
    assert_quantized_equal(got, want)


def test_streaming_int8_dyn_matches_posthoc(lit_sd):
    got, _ = tconv.lit_state_dict_to_native(_torch_sd(lit_sd), LLaMAConfig(**CFG),
                                            quantize="llm.int8-dyn")
    full, _ = tconv.lit_state_dict_to_native(_torch_sd(lit_sd), LLaMAConfig(**CFG))
    want = int8_quantize_model(full, outliers="dynamic")
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w) and "blocks/mlp/c_proj/dyn_threshold" in g
    for key in w:
        assert torch.equal(g[key], w[key]), key


def test_load_lit_checkpoint(tmp_path, lit_sd):
    path = tmp_path / "lit-llama.pth"
    torch.save(_torch_sd(lit_sd), path)
    got, cfg = tconv.load_lit_checkpoint(path, LLaMAConfig(**CFG), dtype=torch.bfloat16)
    want, _ = jconv.load_lit_checkpoint(path, JConfig(**CFG))
    assert got["wte"]["weight"].dtype == torch.bfloat16
    g, w = flat_numpy(got), flat_numpy(want)
    for key in w:  # bf16 rounding of the f32 values
        np.testing.assert_allclose(g[key], w[key], rtol=2**-8, atol=0, err_msg=key)


def test_meta_shard_merge(rng):
    D, H = 8, 16

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)

    full = {"wq": mk(D, D), "wk": mk(D, D), "wv": mk(D, D), "wo": mk(D, D), "w1": mk(H, D),
            "w2": mk(D, H), "w3": mk(H, D), "tok": mk(10, D), "out": mk(10, D)}

    def shard(i):
        def h(w, d):
            return np.split(w, 2, axis=d)[i]
        return {
            "tok_embeddings.weight": h(full["tok"], 1), "output.weight": h(full["out"], 0),
            "norm.weight": np.ones(D, np.float32), "rope.freqs": np.ones(4, np.float32),
            "layers.0.attention.wq.weight": h(full["wq"], 0),
            "layers.0.attention.wk.weight": h(full["wk"], 0),
            "layers.0.attention.wv.weight": h(full["wv"], 0),
            "layers.0.attention.wo.weight": h(full["wo"], 1),
            "layers.0.feed_forward.w1.weight": h(full["w1"], 0),
            "layers.0.feed_forward.w2.weight": h(full["w2"], 1),
            "layers.0.feed_forward.w3.weight": h(full["w3"], 0),
            "layers.0.attention_norm.weight": np.ones(D, np.float32),
            "layers.0.ffn_norm.weight": np.ones(D, np.float32),
        }

    got = tconv.meta_checkpoints_to_lit([_torch_sd(shard(0)), _torch_sd(shard(1))])
    want = jconv.meta_checkpoints_to_lit([shard(0), shard(1)])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_hf_round_trip_matches_jax(lit_sd):
    """native -> HF (q/k permuted, qkv split, vocab trimmed) -> lit -> native."""
    jcfg, tcfg = JConfig(**CFG), LLaMAConfig(**CFG)
    tree, _ = tconv.lit_state_dict_to_native(_torch_sd(lit_sd), tcfg)
    jtree, _ = jconv.lit_state_dict_to_native(lit_sd, jcfg)
    hf = tconv.native_to_hf_state_dict(tree, tcfg)
    jhf = jconv.native_to_hf_state_dict(jtree, jcfg)
    assert set(hf) == set(jhf)
    for k in jhf:
        np.testing.assert_array_equal(hf[k].numpy(), jhf[k], err_msg=k)
    lit = tconv.hf_state_dict_to_lit(hf, tcfg)
    jlit = jconv.hf_state_dict_to_lit({k: torch.from_numpy(np.ascontiguousarray(v))
                                       for k, v in jhf.items()}, jcfg)
    for k in jlit:
        np.testing.assert_array_equal(lit[k].numpy(), jlit[k], err_msg=k)
    back, _ = tconv.lit_state_dict_to_native(lit, tcfg)
    assert_trees_equal(back, tree)
