"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both. Tolerances: f32 paths
agree to 1e-5 of the largest magnitude; the KV-cache quantizers must give the same
bytes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lit_llama_ja_tpu.ops import attention as jatt
from lit_llama_ja_tpu.ops.norms import rmsnorm as j_rmsnorm
from lit_llama_ja_tpu.ops.pallas.flash_attention import _flash_forward, flash_attention
from lit_llama_ja_tpu.ops.rope import apply_rope as j_apply_rope
from lit_llama_ja_tpu.ops.rope import build_rope_cache as j_build_rope_cache
from lit_llama_ja_tpu.ops.sampling import sample_token as j_sample_token
from lit_llama_ja_tpu.ops.sampling import top_p_filter as j_top_p_filter

from lit_llama_ja_tpu_torch.ops import attention as tatt
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.ops.rope import apply_rope, build_rope_cache
from lit_llama_ja_tpu_torch.ops.sampling import sample_token, top_p_filter

F32_REL = 1e-5


def assert_close(got, want, rel=F32_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def t(a):
    return torch.from_numpy(np.array(a))


def test_rmsnorm(rng):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    s = rng.standard_normal((48,)).astype(np.float32)
    assert_close(rmsnorm(t(x), t(s), 1e-5).numpy(), j_rmsnorm(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("T,hd", [(16, 8), (7, 78)])
def test_rope(rng, T, hd):
    assert_close(build_rope_cache(64, hd).numpy(), j_build_rope_cache(64, hd))
    x = rng.standard_normal((2, T, 3, hd)).astype(np.float32)
    cache = np.asarray(j_build_rope_cache(T, hd))
    assert_close(apply_rope(t(x), t(cache)).numpy(),
                 j_apply_rope(jnp.asarray(x), jnp.asarray(cache)))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9])
def test_top_p_filter(rng, top_p):
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 2
    got = top_p_filter(t(logits), top_p).numpy()
    want = np.asarray(j_top_p_filter(jnp.asarray(logits), top_p))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert_close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want))


def test_sample_token_greedy_and_filters(rng):
    logits = rng.standard_normal((64,)).astype(np.float32)
    assert int(sample_token(t(logits), 0.0)) == int(
        j_sample_token(None, jnp.asarray(logits), 0.0)
    )
    # top-k = 1 and a tiny nucleus both leave only the argmax to draw
    g = torch.Generator().manual_seed(0)
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        assert int(sample_token(t(logits), 0.7, generator=g, **kw)) == int(logits.argmax())


def test_quantize_kv_bytes_identical(rng):
    k = rng.standard_normal((1, 4, 6, 16)).astype(np.float32)
    v = rng.standard_normal((1, 4, 6, 16)).astype(np.float32)
    k[0, 1, 2] = 0.0  # an all-zero slot takes scale 1
    got = tatt.quantize_kv(t(k), t(v))
    want = jatt.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    for g_, w_ in zip(got, want):
        assert g_.dtype in (torch.int8, torch.float32)
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("head_axis,shape", [(1, (1, 4, 6, 16)), (-2, (1, 6, 4, 16))])
def test_quantize_kv4_bytes_identical(rng, head_axis, shape):
    k = rng.standard_normal(shape).astype(np.float32) * 2
    v = rng.standard_normal(shape).astype(np.float32)
    got = tatt.quantize_kv4(t(k), t(v), head_axis=head_axis)
    want = jatt.quantize_kv4(jnp.asarray(k), jnp.asarray(v), head_axis=head_axis)
    for g_, w_ in zip(got, want):
        assert g_.dtype in (torch.uint8, torch.float32)
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def _qkv(rng, B, nh, T, hd, S=None):
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    k = rng.standard_normal((B, nh, S or T, hd)).astype(np.float32)
    v = rng.standard_normal((B, nh, S or T, hd)).astype(np.float32)
    return q, k, v


def test_decode_attention_variants(rng):
    B, nh, T, S, hd = 1, 4, 3, 10, 16
    q, k, v = _qkv(rng, B, nh, T, hd, S)
    pos = np.array([5, 6, 7], np.int32)
    assert_close(tatt.decode_attention(t(q), t(k), t(v), t(pos)).numpy(),
                 jatt.decode_attention(*map(jnp.asarray, (q, k, v, pos))))
    kq, ks, vq, vs = (np.asarray(a) for a in jatt.quantize_kv(jnp.asarray(k), jnp.asarray(v)))
    assert_close(
        tatt.decode_attention_quant(t(q), t(kq), t(ks), t(vq), t(vs), t(pos)).numpy(),
        jatt.decode_attention_quant(*map(jnp.asarray, (q, kq, ks, vq, vs, pos))),
    )
    kq, ks, vq, vs = (np.asarray(a) for a in
                      jatt.quantize_kv4(jnp.asarray(k), jnp.asarray(v), head_axis=1))
    assert_close(
        tatt.decode_attention_quant4(t(q), t(kq), t(ks), t(vq), t(vs), t(pos)).numpy(),
        jatt.decode_attention_quant4(*map(jnp.asarray, (q, kq, ks, vq, vs, pos))),
    )
    assert_close(tatt.prefix_attention(t(q), t(k), t(v)).numpy(),
                 jatt.prefix_attention(*map(jnp.asarray, (q, k, v))))


@pytest.mark.parametrize("hd", [64, 78])
def test_flash_ref_matches_jax_flash_kernel(rng, hd):
    """The plain version of the port's kernel against the Pallas kernel in interpret
    mode (o and lse), at T = 96: a multiple of the Pallas block (32) but not of the
    port's 64-row tile."""
    B, nh, T, bq = 1, 2, 96, 32
    q, k, v = _qkv(rng, B, nh, T, hd)
    o, lse = flash_attention_fwd_ref(t(q), t(k), t(v))
    jo, jlse = _flash_forward(*map(jnp.asarray, (q, k, v)), bq, bq, True)
    assert_close(o.numpy(), jo)
    assert_close(lse.numpy(), jlse)
    assert_close(o.numpy(), flash_attention(*map(jnp.asarray, (q, k, v)), bq, bq, True))
    # lse against a numpy logsumexp of the scaled causal scores
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(hd)
    s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    np_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert_close(lse.numpy(), np_lse)


@pytest.mark.parametrize("T,hd", [(77, 64), (33, 78), (1, 128)])
def test_causal_attention_matches_jax(rng, T, hd):
    q, k, v = _qkv(rng, 2, 2, T, hd)
    want = jatt.causal_attention(*map(jnp.asarray, (q, k, v)))
    assert_close(tatt.causal_attention(t(q), t(k), t(v)).numpy(), want)
    # the kernel's wrapper on CPU tensors runs the plain version
    o, lse = flash_attention_fwd(t(q), t(k), t(v))
    assert_close(o.numpy(), want)
    assert lse.shape == (2, 2, T) and lse.dtype == torch.float32


def test_causal_attention_bf16_within_tolerance(rng):
    """bf16 inputs: the port and JAX round in different places; 2e-2 of max|want|."""
    q, k, v = _qkv(rng, 1, 2, 40, 64)
    to_bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tatt.causal_attention(to_bf(q), to_bf(k), to_bf(v)).float().numpy()
    want = jatt.causal_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert_close(got, np.asarray(want, np.float32), rel=2e-2)
