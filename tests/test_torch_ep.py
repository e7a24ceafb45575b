"""The port's expert parallelism (`parallel/ep.py`) on 2 and 4 gloo ranks, mirroring
the ep cases of tests/test_moe.py: `forward_moe_ep` against the single-device
`forward_moe` and JAX's `forward_moe_ep`, and one `make_moe_train_step_ep` step against
the single-device MoE step of the JAX package with ``optax.adamw(1e-3)``.

The capacity leaves room for every token (capacity factor 8), so the sharded result is
the single-device one up to the summation order. Tolerances, the JAX tests': logits
2e-4 relative and 2e-5 absolute, the load-balance loss 1e-4 relative, the step's loss
1e-5 relative and its parameters 2e-4 relative and 2e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_dist_ranks import expert_parallel, spawn
from torch_port_helpers import flat_numpy, to_port

from lit_llama_ja_tpu.models.moe import MoEConfig as JMoEConfig
from lit_llama_ja_tpu.models.moe import forward_moe as j_forward_moe
from lit_llama_ja_tpu.models.moe import init_moe_params, moe_loss
from lit_llama_ja_tpu.parallel.ep import ep_param_specs as j_ep_param_specs
from lit_llama_ja_tpu.parallel.ep import forward_moe_ep as j_forward_moe_ep
from lit_llama_ja_tpu.parallel.ep import shard_params_ep as j_shard_params_ep
from lit_llama_ja_tpu.parallel.mesh import make_mesh as j_make_mesh

from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
from lit_llama_ja_tpu_torch.models.moe import MoEConfig, forward_moe
from lit_llama_ja_tpu_torch.parallel.ep import ep_param_specs

CFG = dict(block_size=16, vocab_size=96, n_layer=2, n_head=2, n_embd=16, n_expert=8,
           n_expert_active=2, capacity_factor=8.0)


def test_ep_specs_match_jax():
    """Only the expert leaves split (dim 1, after L); everything else replicates."""
    jp = init_moe_params(jax.random.PRNGKey(0), JMoEConfig(**CFG))
    got = flatten_tree(ep_param_specs(to_port(jp)))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(j_ep_param_specs(jp))[0]}
    assert got.keys() == want.keys()
    for path, spec in got.items():
        assert spec == tuple(want[path]), path
        assert spec == ((None, "ep") if "/moe/c_" in path else ())


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    world = request.param
    jp = init_moe_params(jax.random.PRNGKey(0), JMoEConfig(**CFG))
    rng = np.random.default_rng(world)
    idx = rng.integers(0, CFG["vocab_size"], (4, 8))
    batch = rng.integers(0, CFG["vocab_size"], (4, 9))
    outs = spawn(expert_parallel, world, tmp_path_factory.mktemp("ep"), to_port(jp),
                 MoEConfig(**CFG), torch.as_tensor(idx), torch.as_tensor(batch), 1e-3)
    return world, jp, idx, batch, outs


def test_forward_ep_matches_single_device_and_jax(runs):
    world, jp, idx, _, outs = runs
    want, want_aux = forward_moe(to_port(jp), torch.as_tensor(idx), MoEConfig(**CFG),
                                 device="cpu")
    mesh = j_make_mesh(ep=world, devices=jax.devices()[:world])
    jgot, jaux = j_forward_moe_ep(j_shard_params_ep(jp, mesh), jnp.asarray(idx),
                                  JMoEConfig(**CFG), mesh)
    for out in outs:
        assert out["local_fc1"].tolist()[:2] == [CFG["n_layer"], CFG["n_expert"] // world]
        np.testing.assert_allclose(out["logits"].numpy(), want.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jgot), rtol=2e-4,
                                   atol=2e-5)
        assert float(out["aux"]["dropped"]) == pytest.approx(0.0, abs=1e-6)
        np.testing.assert_allclose(float(out["aux"]["load_balance"]),
                                   float(want_aux["load_balance"]), rtol=1e-4)
        np.testing.assert_allclose(float(out["aux"]["load_balance"]),
                                   float(jaux["load_balance"]), rtol=1e-4)


def test_ep_train_step_matches_single_device_jax(runs):
    """The JAX oracle is the unsharded step (`moe_loss` + optax.adamw(1e-3)), as in
    tests/test_moe.py; the router, whose gradient flows through the averaged routing
    statistics, is among the leaves held."""
    _, jp, _, batch, outs = runs
    opt = optax.adamw(1e-3)
    b = jnp.asarray(batch)
    ref_l, ref_g = jax.value_and_grad(
        lambda p: moe_loss(p, b[:, :-1], b[:, 1:], JMoEConfig(**CFG))[0])(jp)
    upd, _ = opt.update(ref_g, opt.init(jp), jp)
    want = flat_numpy(optax.apply_updates(jp, upd))
    for out in outs:
        np.testing.assert_allclose(float(out["loss"]), float(ref_l), rtol=1e-5)
        got = flat_numpy(out["params"])
        for path in ("blocks/moe/c_fc1/weight", "blocks/attn/c_attn/weight",
                     "lm_head/weight", "blocks/moe/router/weight"):
            np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=2e-5,
                                       err_msg=path)
