"""The port's checkpoint I/O (`io/checkpoint.py`): its own on-disk format round-trips
every leaf exactly, writes the JAX package's ``config.json`` and ``quant_format.json``
rules, refuses a packed-int4 tree with another pack stamp, and shares the ``.npz``
layout of small flat states with the JAX package in both directions."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch_port_helpers import flat_numpy, random_tree

from lit_llama_ja_tpu.io import checkpoint as jckpt

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.io import checkpoint as tckpt
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.quant.linear import INT4_PACK_VERSION, quantize_colblock

CFG = LLaMAConfig(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=16)


def _params(seed=0):
    tree = random_tree(np.random.default_rng(seed), CFG.n_layer, CFG.n_embd, CFG.n_hidden,
                       CFG.padded_vocab_size)
    params = params_from_numpy(tree, device="cpu")
    params["ln_f"]["scale"] = params["ln_f"]["scale"].bfloat16()  # a bf16 leaf too
    return params


def _assert_trees_equal(a, b):
    fa, fb = tckpt.flatten_tree(a), tckpt.flatten_tree(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_round_trip_and_config(tmp_path):
    params = _params()
    tckpt.save_checkpoint(tmp_path / "ckpt", params, CFG)
    assert json.loads((tmp_path / "ckpt" / "config.json").read_text()) == dataclasses.asdict(CFG)
    assert not (tmp_path / "ckpt" / "quant_format.json").exists()  # not a quantized tree
    back, cfg = tckpt.load_checkpoint(tmp_path / "ckpt", device="cpu")
    _assert_trees_equal(back, params)
    assert cfg == CFG
    tckpt.save_checkpoint(tmp_path / "bare", params)  # no config: none is stored
    assert tckpt.load_checkpoint(tmp_path / "bare", device="cpu")[1] is None


def test_train_state_round_trip(tmp_path):
    from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw

    params = _params(1)
    opt_state = init_opt_state(make_adamw(1e-3), params, lambda p: "attn" in p)
    opt_state["count"] = torch.tensor(7)
    tckpt.save_train_state(tmp_path / "state", params, opt_state, CFG, meta={"iter": 6})
    p2, s2, cfg, meta = tckpt.load_train_state(tmp_path / "state", device="cpu")
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, opt_state)
    assert cfg == CFG and meta == {"iter": 6} and s2["count"].device.type == "cpu"


def _int4_tree():
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32))
    return {"lm_head": quantize_colblock(w, bits=4), "wte": {"weight": torch.zeros(4, 16)}}


def test_quant_format_stamp_and_refusal(tmp_path):
    tree = _int4_tree()
    tckpt.save_checkpoint(tmp_path / "q", tree, CFG)
    stamp = json.loads((tmp_path / "q" / "quant_format.json").read_text())
    assert stamp == {"int4_pack": INT4_PACK_VERSION} == {"int4_pack": "hi-biased-v2"}
    _assert_trees_equal(tckpt.load_checkpoint(tmp_path / "q", device="cpu")[0], tree)
    for stored in ("v1", None):  # an older stamp, and none at all
        if stored is None:
            (tmp_path / "q" / "quant_format.json").unlink()
        else:
            (tmp_path / "q" / "quant_format.json").write_text(json.dumps({"int4_pack": stored}))
        with pytest.raises(ValueError, match="pack format"):
            tckpt.load_checkpoint(tmp_path / "q", device="cpu")


def test_int8_tree_loads_without_stamp(tmp_path):
    """Full-K rows are not the int4 pack, so the stamp does not apply."""
    tree = {"lm_head": {"qweight": torch.zeros((16, 8), dtype=torch.int8),
                        "scales": torch.ones((1, 8)), "zeros": torch.zeros((1, 8))}}
    tckpt.save_checkpoint(tmp_path / "q8", tree, CFG)
    (tmp_path / "q8" / "quant_format.json").unlink()
    _assert_trees_equal(tckpt.load_checkpoint(tmp_path / "q8", device="cpu")[0], tree)


@pytest.mark.parametrize("loader", ["load_checkpoint", "load_train_state"])
def test_orbax_directory_names_the_bridge(tmp_path, loader):
    """The JAX package's Orbax checkpoint writes ``<dir>/params/``; the port's loaders
    say what it is and name the bridge instead of a bare missing params.pt."""
    (tmp_path / "params").mkdir()
    with pytest.raises(FileNotFoundError,
                       match=r"Orbax checkpoint of the JAX package.*from_jax\.params_from_numpy"):
        getattr(tckpt, loader)(tmp_path, device="cpu")


def test_npz_states_cross_between_packages(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"blocks": {"attn": {"lora_A": rng.standard_normal((2, 4, 3)).astype(np.float32)}},
            "lm_head": {"scale": rng.standard_normal(5).astype(np.float32)}}
    jckpt.save_state_npz(tmp_path / "jax.npz", tree)
    got = tckpt.load_state_npz(tmp_path / "jax.npz", device="cpu")
    for k, v in flat_numpy(got).items():
        np.testing.assert_array_equal(v, flat_numpy(tree)[k])
    port_tree = params_from_numpy(tree, device="cpu")
    tckpt.save_state_npz(tmp_path / "port.npz", port_tree)
    back = jckpt.load_state_npz(tmp_path / "port.npz")
    assert sorted(jckpt.flatten_tree(back)) == sorted(tckpt.flatten_tree(port_tree))
    for k, v in jckpt.flatten_tree(back).items():
        np.testing.assert_array_equal(v, flat_numpy(tree)[k])


def test_flatten_keys_and_model_name():
    params = _params()
    flat = tckpt.flatten_tree(params)
    # the JAX package's flatten_tree gives the same keys for the same tree
    assert sorted(flat) == sorted(jckpt.flatten_tree(jckpt.unflatten_tree(flat_numpy(params))))
    _assert_trees_equal(tckpt.unflatten_tree(flat), params)
    assert tckpt.infer_model_name(780) == jckpt.infer_model_name(780) == "125M"
