"""Parity of the port's flash-attention backward (the plain version of K6 and the
autograd function `flash_attention`, on CPU tensors) with the JAX package's Pallas
custom VJP in interpret mode, and of the port's differentiable `causal_attention`
with the JAX one. f32 inputs from a numpy seed; atol = rtol = 2e-3, the tolerance of
the JAX package's own gradient tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.ops import attention as jatt
from lit_llama_ja_tpu.ops.pallas.flash_attention import flash_attention as j_flash

from lit_llama_ja_tpu_torch.ops import attention as tatt
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
)

TOL = dict(atol=2e-3, rtol=2e-3)


def _inputs(rng, B, nh, T, hd):
    return [rng.standard_normal((B, nh, T, hd)).astype(np.float32) for _ in range(4)]


def _autograd(fn, q, k, v, g):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), torch.from_numpy(g))


# the shapes of the JAX package's flash gradient tests (B, nh, T, hd, Pallas block)
@pytest.mark.parametrize("B,nh,T,hd,bq", [(1, 2, 128, 32, 64), (1, 2, 256, 64, 64),
                                          (1, 2, 512, 64, 128)])
def test_backward_matches_pallas_vjp(rng, B, nh, T, hd, bq):
    q, k, v, g = _inputs(rng, B, nh, T, hd)
    _, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, bq, bq, True),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = flash_attention_fwd_ref(tq, tk, tv)
    plain = flash_attention_bwd_ref(tq, tk, tv, o, lse, tg)
    before = flash_attention_bwd.launches
    wrapped = flash_attention_bwd(tq, tk, tv, o, lse, tg)  # CPU tensors: the plain version
    assert flash_attention_bwd.launches == before  # a plain run is not a kernel launch
    through_autograd = _autograd(flash_attention, q, k, v, g)
    for got in (plain, wrapped, through_autograd):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("fn", ["causal_attention", "flash_attention"])
def test_gradients_match_jax_causal_attention_ragged(rng, fn):
    """hd 78 (the 125M config) at T = 130, which no 64-row tile divides."""
    q, k, v, g = _inputs(rng, 2, 2, 130, 78)
    _, vjp = jax.vjp(jatt.causal_attention, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    port_fn = tatt.causal_attention if fn == "causal_attention" else flash_attention
    for a, b in zip(_autograd(port_fn, q, k, v, g), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_backward_keeps_dtype_and_takes_strided_views(rng):
    """bf16 in, bf16 out; q, k, v as views of one projection and a transposed dO,
    the layouts autograd hands over in the model."""
    B, T, nh, hd = 1, 20, 2, 16
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, nh, hd)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.from_numpy(rng.standard_normal((B, T, nh, hd)).astype(np.float32)).transpose(1, 2)
    o, lse = flash_attention_fwd_ref(q, k, v)
    want = flash_attention_bwd_ref(*(t.contiguous() for t in (q, k, v, o)), lse, do.contiguous())
    for a, b in zip(flash_attention_bwd(q, k, v, o, lse, do), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    bf = [t.bfloat16() for t in (q, k, v, o)]
    for a in flash_attention_bwd(*bf, lse, do.bfloat16()):
        assert a.dtype == torch.bfloat16 and a.shape == (B, nh, T, hd)
