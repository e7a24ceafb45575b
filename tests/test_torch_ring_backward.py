"""The backward of the port's sequence parallelism and the ring matmul's overlapped hops,
on 2 and 4 gloo ranks (`tests/test_torch_dist_ranks.ring_backward`).

* `ring_attention`: each rank's dq, dk and dv for a fixed cotangent, joined along the
  sequence, against ``jax.grad`` of the JAX package's `ring_attention` on 2 of the
  tests' virtual devices (one compile serves both worlds, as for `forward_sp`): 2e-5
  absolute in f32 (the forward's tolerance: another summation
  order), 3e-2 for bf16 inputs (bf16 probabilities and products).
* `forward_sp`, both impls: every parameter's gradients summed over the ranks (each
  rank's are partial sums) against ``jax.grad`` of the same next-token loss through
  JAX's `forward_sp`, within 1e-5 of the leaf's max |grad| (f32; the ranks' partial
  sums add in another order). Under ``torch.no_grad()`` the logits equal in bits those
  computed with gradients on.
* `ring_quant_matmul` with the overlapped hops: equal in bits to the same hops run one
  after the other on the rank, and no column-blocking copy in a call (`k_shard` made
  it once).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import ring_backward, spawn
from torch_port_helpers import to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models.llama import init_params as j_init_params
from lit_llama_ja_tpu.parallel.mesh import make_mesh as j_make_mesh
from lit_llama_ja_tpu.parallel.ring_attention import ring_attention as j_ring_attention
from lit_llama_ja_tpu.parallel.sp_forward import forward_sp as j_forward_sp
from lit_llama_ja_tpu.train.loss import cross_entropy_loss as j_cross_entropy

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.quant.linear import quantize_colblock, quantize_int8_absmax

CFG = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
ATTN_TOL, BF16_TOL, GRAD_TOL = 2e-5, 3e-2, 1e-5


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _ring_cases(world):
    rng = np.random.default_rng(100 + world)

    def w(K, N):
        return torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32) * 0.1)

    return {"int4": (torch.as_tensor(rng.normal(size=(8, 64)), dtype=torch.float32),
                     quantize_colblock(w(64, 32), bits=4, tile_cols=-1), 64),
            "int4_grouped": (torch.as_tensor(rng.normal(size=(3, 128)), dtype=torch.float32),
                             quantize_colblock(w(128, 16), bits=4, tile_cols=32), 128),
            "int8": (torch.as_tensor(rng.normal(size=(4, 32)), dtype=torch.float32),
                     quantize_int8_absmax(w(32, 48)), 32)}


def inputs():
    """The attention inputs and cotangent, the JAX params and the token ids of both
    worlds."""
    rng = np.random.default_rng(30)
    q, k, v, ct = (rng.standard_normal((2, 4, 48, 8)).astype(np.float32) for _ in range(4))
    jparams = j_init_params(jax.random.PRNGKey(0), JConfig(**CFG))
    return (q, k, v, ct), jparams, rng.integers(0, 64, (2, 16))


@functools.lru_cache(maxsize=None)
def jax_refs():
    """``jax.grad`` of JAX's `ring_attention` and of the next-token loss through JAX's
    `forward_sp` (both impls) on 2 virtual devices: the reference of both worlds (the
    compiles take most of this file's time; the math does not depend on the number of
    blocks beyond the f32 summation order that the tolerances allow)."""
    (q, k, v, ct), jparams, idx = inputs()
    mesh = j_make_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])

    def attn_loss(qq, kk, vv):
        return jnp.sum(j_ring_attention(qq, kk, vv, mesh) * ct)

    grads = jax.grad(attn_loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    refs = {f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}
    jidx = jnp.asarray(idx)
    for impl in ("allgather", "ring"):
        def loss(p, impl=impl):
            logits = j_forward_sp(p, jidx, JConfig(**CFG), mesh, attn_impl=impl)
            return j_cross_entropy(logits[:, :-1], jidx[:, 1:])

        refs[f"grads_{impl}"] = _flat(jax.grad(loss)(jparams))
    return refs


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    """Every rank's results; the JAX references compile while the first world's ranks
    run."""
    world = request.param
    (q, k, v, ct), jparams, idx = inputs()
    outs, refs = spawn(ring_backward, world, tmp_path_factory.mktemp("ringbwd"),
                       *(torch.as_tensor(t) for t in (q, k, v, ct)), to_port(jparams),
                       LLaMAConfig(**CFG), torch.as_tensor(idx), _ring_cases(world),
                       meanwhile=jax_refs)
    return world, outs, refs


def _joined(outs, key):
    return np.concatenate([o[key].float().numpy() for o in outs], axis=2)


@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_ring_attention_grads_match_jax(runs, grad):
    _, outs, refs = runs
    np.testing.assert_allclose(_joined(outs, grad), refs[grad], atol=ATTN_TOL)
    assert all(o[f"{grad}_bf16"].dtype == torch.bfloat16 for o in outs)
    np.testing.assert_allclose(_joined(outs, f"{grad}_bf16"), refs[grad], atol=BF16_TOL)


@pytest.mark.parametrize("impl", ["allgather", "ring"])
def test_forward_sp_summed_grads_match_jax(runs, impl):
    """Each rank's gradients are partial sums: their sum over the axis is the gradient."""
    _, outs, refs = runs
    want = refs[f"grads_{impl}"]
    assert set(want) == set(outs[0][f"grads_{impl}"])
    for name, w in want.items():
        got = sum(o[f"grads_{impl}"][name].numpy() for o in outs)
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=f"{impl} {name}")
        # one rank alone is not the gradient: the partial sums are split
        assert not np.allclose(outs[0][f"grads_{impl}"][name].numpy(), w,
                               atol=GRAD_TOL * np.abs(w).max()) or np.abs(w).max() == 0


@pytest.mark.parametrize("impl", ["allgather", "ring"])
def test_forward_sp_no_grad_is_unchanged(runs, impl):
    _, outs, _ = runs
    for o in outs:
        assert torch.equal(o[f"logits_nograd_{impl}"], o[f"logits_grad_{impl}"])
        assert not o[f"logits_nograd_{impl}"].requires_grad


@pytest.mark.parametrize("case", ["int4", "int4_grouped", "int8"])
def test_ring_matmul_overlap_is_the_sequential_sum(runs, case):
    world, outs, _ = runs
    cases = _ring_cases(world)
    x, qp, _ = cases[case]
    n_loc = qp["qweight"].shape[-1] // world
    for rank, o in enumerate(outs):
        got = o[f"ring_{case}"]
        assert got.shape == (x.shape[0], n_loc * world)
        assert torch.equal(got[:, rank * n_loc:(rank + 1) * n_loc], o[f"sequential_{case}"])
        assert o[f"ring_copy_{case}"] == 0
    assert all(torch.equal(o[f"ring_{case}"], outs[0][f"ring_{case}"]) for o in outs)
