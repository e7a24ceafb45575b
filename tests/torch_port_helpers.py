"""Shared fixtures for the parity tests of the PyTorch port (`tests/test_torch_*.py`):
one numpy parameter tree feeds the JAX package and the port."""
import jax
import jax.numpy as jnp
import numpy as np

from lit_llama_ja_tpu.quant.linear import quantize_colblock

from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy

LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc1"), ("mlp", "c_fc2"),
           ("mlp", "c_proj"))


def quantize_int4_tree(params, tile_cols=-1):
    """RTN int4 of every linear of a JAX param tree (stacked blocks quantized per
    layer, then restacked), with the JAX package's `quantize_colblock`."""
    blocks = dict(params["blocks"])
    for mod, name in LINEARS:
        w = params["blocks"][mod][name]["weight"]
        per_layer = [quantize_colblock(w[i], bits=4, tile_cols=tile_cols)
                     for i in range(w.shape[0])]
        stacked = {k: jnp.stack([p[k] for p in per_layer]) for k in per_layer[0]}
        blocks[mod] = {**blocks[mod], name: stacked}
    out = dict(params)
    out["blocks"] = blocks
    out["lm_head"] = quantize_colblock(params["lm_head"]["weight"], bits=4,
                                       tile_cols=tile_cols)
    return out


def to_port(params):
    """JAX param tree -> the port's tree of CPU tensors, via numpy."""
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
