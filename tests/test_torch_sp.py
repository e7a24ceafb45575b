"""The port's sequence parallelism on 2 and 4 gloo ranks: `sequence_parallel_attention`
(both impls), `ring_attention` and `forward_sp` (mirroring tests/test_sp_attention.py,
tests/test_ring_attention.py and tests/test_sp_forward.py).

Oracles: the dense causal attention and the JAX package's functions on the tests'
virtual devices; `forward_sp` also against the port's one-rank forward. Tolerances, as
the JAX tests: attention 2e-5 absolute (f32, another summation order), the forward
2e-4; a bf16 ring against the f32 oracle 3e-2 (bf16 inputs and probabilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import seq_parallel, spawn
from torch_port_helpers import to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models.llama import forward as j_forward
from lit_llama_ja_tpu.models.llama import init_params as j_init_params
from lit_llama_ja_tpu.ops.attention import causal_attention as j_causal
from lit_llama_ja_tpu.parallel.mesh import make_mesh as j_make_mesh
from lit_llama_ja_tpu.parallel.sp_attention import sequence_parallel_attention as j_sp
from lit_llama_ja_tpu.parallel.sp_forward import forward_sp as j_forward_sp

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.models.llama import forward

CFG = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=32)


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    world = request.param
    rng = np.random.default_rng(world)
    q, k, v = (rng.standard_normal((2, 4, 48, 8)).astype(np.float32) for _ in range(3))
    jparams = j_init_params(jax.random.PRNGKey(world), JConfig(**CFG))
    idx_short = rng.integers(0, 64, (2, 16))
    idx_long = rng.integers(0, 64, (1, 2 * CFG["block_size"]))  # past block_size
    outs = spawn(seq_parallel, world, tmp_path_factory.mktemp("sp"),
                 *(torch.as_tensor(t) for t in (q, k, v)), to_port(jparams),
                 LLaMAConfig(**CFG), torch.as_tensor(idx_short), torch.as_tensor(idx_long))
    mesh = j_make_mesh(dp=1, fsdp=1, tp=world, devices=jax.devices()[:world])
    return world, (q, k, v), jparams, idx_short, idx_long, outs, mesh


def _joined(outs, key):
    return np.concatenate([o[key].float().numpy() for o in outs], axis=2)


def test_sp_attention_matches_dense_and_jax(runs):
    world, (q, k, v), _, _, _, outs, mesh = runs
    want = np.asarray(j_causal(*(jnp.asarray(t) for t in (q, k, v))))
    for key in ("allgather", "ring", "ring_direct"):
        np.testing.assert_allclose(_joined(outs, key), want, atol=2e-5, err_msg=key)
    jag = np.asarray(j_sp(*(jnp.asarray(t) for t in (q, k, v)), mesh, impl="allgather"))
    jring = np.asarray(j_sp(*(jnp.asarray(t) for t in (q, k, v)), mesh, impl="ring"))
    np.testing.assert_allclose(_joined(outs, "allgather"), jag, atol=2e-5)
    np.testing.assert_allclose(_joined(outs, "ring"), jring, atol=2e-5)


def test_ring_bf16_inputs(runs):
    """bf16 q/k/v stay bf16 out; the f32 statistics keep them near the f32 oracle."""
    _, (q, k, v), _, _, _, outs, _ = runs
    assert all(o["ring_bf16"].dtype == torch.bfloat16 for o in outs)
    want = np.asarray(j_causal(*(jnp.asarray(t) for t in (q, k, v))))
    np.testing.assert_allclose(_joined(outs, "ring_bf16"), want, atol=3e-2)


def test_forward_sp_matches_standard_and_jax(runs):
    world, _, jparams, idx_short, idx_long, outs, mesh = runs
    port = to_port(jparams)
    want = forward(port, torch.as_tensor(idx_short), LLaMAConfig(**CFG), device="cpu")
    jwant = np.asarray(j_forward_sp(jparams, jnp.asarray(idx_short), JConfig(**CFG), mesh))
    for out in outs:
        for impl in ("allgather", "ring"):
            got = out[f"sp_{impl}"]
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
            np.testing.assert_allclose(got.numpy(), jwant, atol=2e-4)


def test_forward_sp_beyond_block_size(runs):
    """T = 2 x block_size: the RoPE table extends; the first block_size positions equal
    the standard forward on the prefix, and the whole equals JAX's `forward_sp`."""
    world, _, jparams, _, idx_long, outs, mesh = runs
    B = CFG["block_size"]
    prefix = np.asarray(j_forward(jparams, jnp.asarray(idx_long[:, :B]), JConfig(**CFG)))
    jwant = np.asarray(j_forward_sp(jparams, jnp.asarray(idx_long), JConfig(**CFG), mesh,
                                    attn_impl="ring"))
    for out in outs:
        for impl in ("allgather", "ring"):
            got = out[f"sp_long_{impl}"].numpy()
            assert got.shape == (1, 2 * B, LLaMAConfig(**CFG).padded_vocab_size)
            np.testing.assert_allclose(got[:, :B], prefix, atol=2e-4)
            np.testing.assert_allclose(got, jwant, atol=2e-4)
