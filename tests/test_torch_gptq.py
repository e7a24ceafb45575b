"""Parity of the PyTorch port's GPTQ solver and quantization pipeline with the JAX
package's, on the CPU.

The same W and H (made with numpy) go to both solvers, both in float32 with sums
in different orders, so a level that sits on a rounding boundary may differ: levels
must agree on at least 99.9% of the entries, scales and zeros within 1e-4 relative.
Whole-model quantization is compared by the logits of the quantized trees (1e-3
relative to the largest logit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import llama as jl
from lit_llama_ja_tpu.quant import gptq as jg
from lit_llama_ja_tpu.quant import pipeline as jpipe

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.models import llama as tl
from lit_llama_ja_tpu_torch.quant import gptq as tg
from lit_llama_ja_tpu_torch.quant import pipeline as tpipe
from lit_llama_ja_tpu_torch.quant.linear import parse_quant_mode, unpack_levels

LEVEL_AGREE = 0.999
PARAM_REL = 1e-4
LOGIT_REL = 1e-3
CFG = dict(block_size=32, vocab_size=96, n_layer=2, n_head=4, n_embd=64)


def t(a):
    return torch.from_numpy(np.array(a))


def test_hessian_update(rng):
    K = 48
    H, n = init = tg.init_hessian(K)
    jH, jn = jg.init_hessian(K)
    assert H.shape == init[0].shape == (K, K)
    for b in (3, 5, 2):
        x = rng.standard_normal((b, 7, K)).astype(np.float32)
        H, n = tg.hessian_update(H, n, t(x))
        jH, jn = jg.hessian_update(jH, jn, jnp.asarray(x))
    assert float(n) == float(jn) == 10.0
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jH)).max())


def test_hessian_accumulates_in_float64(rng):
    """Activations dominated by one direction, each row repeated (repeated calibration
    text): H must be the float64 X^T X, since float32 rounding of its largest
    eigenvalue can exceed the solver's damping on the card."""
    K = 96
    base = 1.0 + 1e-3 * rng.standard_normal((40, K)).astype(np.float32)
    x = np.tile(base, (64, 1))
    H, n = tg.hessian_update(*tg.init_hessian(K), t(x))
    x64 = x.astype(np.float64)
    want = 2.0 / x.shape[0] * (x64.T @ x64)
    assert H.dtype == torch.float64 and float(n) == x.shape[0]
    np.testing.assert_allclose(H.numpy(), want, rtol=1e-12)


def _problem(rng, K=252, N=48):
    w = rng.standard_normal((N, K)).astype(np.float32)
    a = rng.standard_normal((512, K)).astype(np.float32)
    a[:, : K // 4] *= 3.0  # anisotropic, correlated inputs
    a[:, 5] = 0.0  # a dead input column
    return w, (2.0 / 512 * (a.T @ a)).astype(np.float32)


@pytest.mark.parametrize("bits,groupsize,actorder", [
    (2, -1, True), (3, -1, True), (4, -1, True), (8, -1, True),
    (4, 64, False), (2, 64, False), (3, 32, False),
])
def test_gptq_solve_matches(rng, bits, groupsize, actorder):
    """K = 252 with blocks of 128: a ragged last block of 124 columns, whose last
    group window clamps back into the block by 4 columns (as ``lax.dynamic_slice``
    clamps it) and so reads 4 quantized columns. Those sit on the old grid, so a new
    zero can land exactly on a rounding tie; a longer overlap makes such ties, decided
    by the last bit of f32 sums, likely."""
    w, H = _problem(rng)
    kw = dict(bits=bits, groupsize=groupsize, actorder=actorder)
    q, s, z, err = tg.gptq_solve(t(w), t(H), **kw)
    jq, js, jz, jerr = jg.gptq_solve(jnp.asarray(w), jnp.asarray(H), **kw)
    agree = (q.numpy() == np.asarray(jq)).mean()
    assert agree >= LEVEL_AGREE, agree
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=PARAM_REL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=PARAM_REL, atol=PARAM_REL)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-2)


@pytest.mark.parametrize("bits,groupsize", [(3, 64), (8, -1)])
def test_gptq_quantize_linear_packs(rng, bits, groupsize):
    w, H = _problem(rng)
    kw = dict(bits=bits, groupsize=groupsize, actorder=groupsize == -1)
    got, _ = tg.gptq_quantize_linear(t(w.T), t(H), **kw)
    want, _ = jg.gptq_quantize_linear(jnp.asarray(w.T), jnp.asarray(H), **kw)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
    levels = unpack_levels(got, 252).numpy()
    jlevels = unpack_levels(to_port(want), 252).numpy()
    assert (levels == jlevels).mean() >= LEVEL_AGREE


@pytest.fixture(scope="module")
def model():
    jp = jl.init_params(jax.random.PRNGKey(3), JConfig(**CFG))
    jp = jax.tree.map(lambda a: a * 8.0 if a.ndim >= 2 else a, jp)  # weights ~N(0, 0.1)
    return jp, to_port(jp)


def _logits(jparams, tparams, ids):
    want = np.asarray(jl.forward(jparams, jnp.asarray(ids), JConfig(**CFG)))
    got = tl.forward(tparams, torch.from_numpy(ids).long(), LLaMAConfig(**CFG),
                     device="cpu").numpy()
    return got, want


def test_gptq_quantize_model_matches(model, rng):
    """The mixed mode: int4 attention and head with actorder, int2 MLP in 32-row
    groups; calibration windows stream in two micro-batches."""
    jp, tp = model
    _, bits, gs = parse_quant_mode("gptq.mix-g32")
    calib = rng.integers(0, CFG["vocab_size"], size=(4, 16)).astype(np.int32)
    kw = dict(bits=bits, groupsize=gs, micro_batch=2, progress=False)
    times = []
    got_p = tpipe.gptq_quantize_model(tp, LLaMAConfig(**CFG), calib, solve_times=times, **kw)
    want_p = jpipe.gptq_quantize_model(jp, JConfig(**CFG), jnp.asarray(calib), **kw)
    assert len(times) == 5 * CFG["n_layer"] + 1
    assert "qweight_hi" not in got_p["blocks"]["mlp"]["c_fc1"]
    ids = rng.integers(0, CFG["vocab_size"], size=(2, 11)).astype(np.int32)
    got, want = _logits(want_p, got_p, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_REL * np.abs(want).max())


@pytest.mark.parametrize("outliers", [True, False, "dynamic"])
def test_int8_quantize_model_matches(model, rng, outliers):
    jp, tp = model
    got_p = tpipe.int8_quantize_model(tp, outliers=outliers)
    want_p = jpipe.int8_quantize_model(jp, outliers=outliers)
    assert got_p["blocks"]["attn"]["c_attn"]["qweight"].dtype == torch.int8
    ids = rng.integers(0, CFG["vocab_size"], size=(2, 11)).astype(np.int32)
    got, want = _logits(want_p, got_p, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_REL * np.abs(want).max())
    # the input tree is left as it was
    assert "weight" in tp["blocks"]["attn"]["c_attn"]
