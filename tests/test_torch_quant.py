"""Parity of the PyTorch port's int4 quantization with the JAX package's, on the CPU.

Packing is compared byte for byte. The plain version of the port's int4 kernel is
held against the JAX Pallas kernel in interpret mode with its exact ``bf16`` unpack
(which rounds activations to bf16, hence 2e-2 of max|want|, as the JAX kernel tests
use) and against the JAX dequantize-and-matmul in f32 (1e-5 of max|want|).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lit_llama_ja_tpu.ops.pallas.quant_matmul import quant_matmul_int4 as j_qmm4
from lit_llama_ja_tpu.quant import linear as jlin

from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    quant_matmul_int4,
    quant_matmul_int4_ref,
)
from lit_llama_ja_tpu_torch.quant import linear as tlin


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_pack_unpack_bytes_identical(rng):
    q = rng.integers(0, 16, size=(24, 10)).astype(np.uint8)
    packed = tlin.pack_int4(t(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jlin.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tlin.unpack_int4(packed).numpy(), q)
    stacked = np.stack([np.asarray(packed)] * 3)  # a leading layer axis passes through
    np.testing.assert_array_equal(
        tlin.unpack_int4(t(stacked)).numpy(), np.asarray(jlin.unpack_int4(jnp.asarray(stacked)))
    )
    assert tlin.INT4_PACK_VERSION == jlin.INT4_PACK_VERSION


@pytest.mark.parametrize("sym", [False, True])
def test_find_qparams(rng, sym):
    w = rng.standard_normal((32, 12)).astype(np.float32)
    w[:, 3] = 0.0  # degenerate channel
    s, z = tlin.find_qparams(t(w), 4, sym)
    js, jz = jlin.find_qparams(jnp.asarray(w), 4, sym)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


@pytest.mark.parametrize("K,tile", [(64, -1), (256, 64), (200, 64), (780, 64)])
def test_quantize_colblock_and_dequant(rng, K, tile):
    """Whole-column and grouped scales, including a ragged last group."""
    w = rng.standard_normal((K, 24)).astype(np.float32)
    got = tlin.quantize_colblock(t(w), bits=4, tile_cols=tile)
    want = jlin.quantize_colblock(jnp.asarray(w), bits=4, tile_cols=tile)
    for key in ("qweight", "scales", "zeros"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert tlin.infer_bits_params(got, K) == jlin.infer_bits_params(want, K) == 4
    assert_close(tlin.dequantize_with_k(got, K).numpy(), jlin.dequantize_with_k(want, K),
                 1e-6)


def test_pack_prequantized_matches(rng):
    q = rng.integers(0, 16, size=(16, 8)).astype(np.float32)
    s = rng.random((2, 8)).astype(np.float32)
    z = rng.integers(0, 16, size=(2, 8)).astype(np.float32)
    got = tlin.pack_prequantized(t(q), t(s), t(z), 4)
    want = jlin.pack_prequantized(jnp.asarray(q), jnp.asarray(s), jnp.asarray(z), 4)
    for key in ("qweight", "scales", "zeros"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("rows,K", [(16, 16), (8, 16), (1032, 4096), (3, 5)])
def test_infer_bits(rows, K):
    qw = np.zeros((rows, 4), np.uint8)
    try:
        want = jlin.infer_bits(jnp.asarray(qw), K)
    except ValueError:
        with pytest.raises(ValueError):
            tlin.infer_bits(t(qw), K)
        return
    assert tlin.infer_bits(t(qw), K) == want


@pytest.mark.parametrize("M", [1, 7, 16])
def test_int4_ref_matches_jax_kernel_and_dequant(rng, M):
    K, N = 256, 256
    w = rng.standard_normal((K, N)).astype(np.float32)
    p = jlin.quantize_colblock(jnp.asarray(w), bits=4, tile_cols=64)  # 4 groups
    x = rng.standard_normal((M, K)).astype(np.float32)
    tp = {k: t(np.asarray(v)) for k, v in p.items()}
    got = quant_matmul_int4_ref(t(x), tp["qweight"], tp["scales"], tp["zeros"]).numpy()
    exact = np.asarray(jnp.asarray(x) @ jlin.dequantize_with_k(p, K))
    assert_close(got, exact, 1e-5)
    kernel = j_qmm4(jnp.asarray(x), p["qweight"], p["scales"], p["zeros"], block_m=8,
                    block_n=128, interpret=True, out_dtype=jnp.float32, unpack="bf16")
    assert_close(got, np.asarray(kernel), 2e-2)
    # the wrapper and the dispatch run the plain version on CPU tensors
    np.testing.assert_array_equal(
        quant_matmul_int4(t(x), tp["qweight"], tp["scales"], tp["zeros"]).numpy(), got
    )
    np.testing.assert_array_equal(tlin.quant_matmul(t(x)[None], tp).numpy()[0], got)


def test_unported_formats_raise(rng):
    """Every quantized format runs now: int8 (plain and with LLM.int8 outliers), int2
    and int3 packs go to their kernels' plain versions on the CPU and match the JAX
    package. What a linear still cannot be in the port, a LoRA or adapter-v2 leaf
    (ROADMAP.md, queue 1 slice 5b), raises."""
    from lit_llama_ja_tpu_torch.models.llama import apply_linear

    w = jnp.asarray(rng.standard_normal((64, 8)).astype(np.float32))
    x = rng.standard_normal((2, 64)).astype(np.float32)
    for jp in (jlin.quantize_int8_absmax(w), jlin.quantize_colblock(w, bits=2),
               jlin.quantize_colblock(w, bits=3), jlin.quantize_int8_dynamic(w),
               jlin.quantize_int8_outlier(w)):
        tp = {k: t(np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v))
              for k, v in jp.items()}
        want = np.asarray(jlin.quant_matmul(jnp.asarray(x), jp))
        assert_close(tlin.quant_matmul(t(x), tp).numpy(), want, 1e-5)
    np.testing.assert_array_equal(
        tlin.quantize_colblock(t(np.asarray(w)), bits=8)["qweight"].numpy(),
        np.asarray(jlin.quantize_colblock(w, bits=8)["qweight"]))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        apply_linear({"weight": torch.zeros((64, 8)), "adapter_bias": torch.zeros(8)},
                     torch.zeros((1, 64)))


@pytest.mark.parametrize("bits", [4, 8, 2, 3])
def test_stacked_layer_views_pass_the_launch_checks(bits):
    """Each layer of a stacked (L, ...) tree is a view at an offset of the stack. At
    the 125M model's shapes (K 780 into N 2340, 780 and 2304) an int4 layer starts
    8 bytes past a 16-byte boundary; the kernels' checks take any such view, and
    still refuse a view that their widest loads could not read."""
    from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import prepare_launch
    from lit_llama_ja_tpu_torch.quant.pipeline import _stack

    x = torch.zeros((1, 780), dtype=torch.bfloat16)
    for N in (2340, 780, 2304):
        w = torch.zeros((3, 780, N))
        stack = _stack([tlin.quantize_colblock(w[i], bits=bits, tile_cols=64)
                            for i in range(3)])
        for i in range(3):
            layer = {k: v[i] for k, v in stack.items()}
            prepare_launch("test", x, N, **layer)
    qweight = torch.zeros(8 * 2304 + 4, dtype=torch.uint8)[4:].view(8, 2304)
    with pytest.raises(ValueError, match="8-byte aligned"):
        prepare_launch("test", x, 2304, qweight=qweight)
