"""Shared fixtures for the parity tests of the PyTorch port (`tests/test_torch_*.py`):
one numpy parameter tree feeds the JAX package and the port."""
import jax
import jax.numpy as jnp
import numpy as np

from lit_llama_ja_tpu.quant.linear import quantize_colblock, resolve_bits, resolve_groupsize

from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy

LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc1"), ("mlp", "c_fc2"),
           ("mlp", "c_proj"))


def quantize_rtn_tree(params, bits=4, tile_cols=-1):
    """RTN quantization of every linear of a JAX param tree (stacked blocks quantized
    per layer, then restacked) with the JAX package's `quantize_colblock`; ``bits`` is
    an int or a mixed-mode dict, whose groupsize reaches the sub-4-bit projections."""
    blocks = dict(params["blocks"])
    for mod, name in LINEARS:
        w = params["blocks"][mod][name]["weight"]
        nb = resolve_bits(bits, f"{mod}.{name}")
        gs = resolve_groupsize(bits, f"{mod}.{name}", tile_cols)
        per_layer = [quantize_colblock(w[i], bits=nb, tile_cols=gs) for i in range(w.shape[0])]
        stacked = {k: jnp.stack([p[k] for p in per_layer]) for k in per_layer[0]}
        blocks[mod] = {**blocks[mod], name: stacked}
    out = dict(params)
    out["blocks"] = blocks
    out["lm_head"] = quantize_colblock(params["lm_head"]["weight"],
                                       bits=resolve_bits(bits, "lm_head"),
                                       tile_cols=resolve_groupsize(bits, "lm_head", tile_cols))
    return out


def quantize_int4_tree(params, tile_cols=-1):
    """RTN int4 of every linear of a JAX param tree."""
    return quantize_rtn_tree(params, 4, tile_cols)


def to_port(params):
    """JAX param tree -> the port's tree of CPU tensors, via numpy."""
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def random_tree(rng, n_layer, n_embd, n_hidden, vocab, std=0.1):
    """A numpy f32 param tree in the layout both packages share, from ``rng``: weights
    N(0, std) (larger than the init's, so a few optimizer steps move the loss) and
    RMSNorm scales around 1."""
    L, D, H, V = n_layer, n_embd, n_hidden, vocab

    def w(*shape):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def scale(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "wte": {"weight": w(V, D)},
        "lm_head": {"weight": w(D, V)},
        "ln_f": {"scale": scale(D)},
        "blocks": {
            "rms_1": {"scale": scale(L, D)},
            "attn": {"c_attn": {"weight": w(L, D, 3 * D)}, "c_proj": {"weight": w(L, D, D)}},
            "rms_2": {"scale": scale(L, D)},
            "mlp": {"c_fc1": {"weight": w(L, D, H)}, "c_fc2": {"weight": w(L, D, H)},
                    "c_proj": {"weight": w(L, H, D)}},
        },
    }


def flat_numpy(tree, prefix=""):
    """``{"a/b": numpy array}`` of a tree of jax arrays or torch tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_numpy(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "detach"):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}
