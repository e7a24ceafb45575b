"""Parity of the PyTorch port's int8, int2 and int3 quantization with the JAX package's,
on the CPU.

Packs are compared byte for byte, the mode grammar entry for entry. Dequantization
and `quant_matmul` of every format (LLM.int8 static and dynamic outliers included)
are held to 1e-5 of max|want| against the JAX package's CPU path in f32. The plain
versions of K3, K4 and K5 are held against the Pallas kernels in interpret mode with
their exact ``bf16`` unpacks (and ``bf16_groupdeq`` for grouped int2), which round
activations to bf16: 2e-2 of max|want|, as the JAX kernel tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port

from lit_llama_ja_tpu.ops.pallas.quant_matmul import quant_matmul_int8 as j_qmm8
from lit_llama_ja_tpu.ops.pallas.quant_matmul_sub4 import (
    quant_matmul_int2 as j_qmm2,
    quant_matmul_int3 as j_qmm3,
)
from lit_llama_ja_tpu.quant import linear as jlin

from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import quant_matmul_int8, quant_matmul_int8_ref
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul_sub4 import (
    quant_matmul_int2,
    quant_matmul_int2_ref,
    quant_matmul_int3,
    quant_matmul_int3_ref,
)
from lit_llama_ja_tpu_torch.quant import linear as tlin

F32_REL = 1e-5
KERNEL_REL = 2e-2


def t(a):
    return torch.from_numpy(np.array(a))


def assert_same_leaves(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], np.asarray(want[key])
        if g.dtype == torch.bfloat16:
            g, w = g.float(), w.astype(np.float32)
        assert g.numpy().dtype == w.dtype, key
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


def assert_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# Packs and grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,g", [(8, -1), (780, -1), (780, 64), (2048, -1), (2304, 64),
                                 (11008, -1), (4090, 96)])
def test_sub4_pad_rows(K, g):
    assert tlin.sub4_pad_rows(K, g) == jlin.sub4_pad_rows(K, g)


@pytest.mark.parametrize("K", [64, 780, 2304])
def test_pack_int2_int3_bytes(rng, K):
    q2 = rng.integers(0, 4, size=(K, 12)).astype(np.uint8)
    got = tlin.pack_int2(t(q2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlin.pack_int2(jnp.asarray(q2))))
    np.testing.assert_array_equal(tlin.unpack_int2(got).numpy()[:K], q2)
    q3 = rng.integers(0, 8, size=(K, 12)).astype(np.uint8)
    got3 = tlin.pack_int3(t(q3))
    assert_same_leaves(got3, jlin.pack_int3(jnp.asarray(q3)))
    np.testing.assert_array_equal(
        tlin.unpack_int3(got3["qweight"], got3["qweight_hi"]).numpy()[:K], q3)
    stacked = {k: torch.stack([v] * 2) for k, v in got3.items()}  # a layer axis passes
    np.testing.assert_array_equal(
        tlin.unpack_int3(stacked["qweight"], stacked["qweight_hi"]).numpy(),
        np.asarray(jlin.unpack_int3(jnp.asarray(stacked["qweight"].numpy()),
                                    jnp.asarray(stacked["qweight_hi"].numpy()))))


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("K", [64, 780, 2304])
@pytest.mark.parametrize("g", [-1, 64])
def test_quantize_colblock_bytes(rng, bits, K, g):
    w = rng.standard_normal((K, 20)).astype(np.float32)
    got = tlin.quantize_colblock(t(w), bits, tile_cols=g)
    want = jlin.quantize_colblock(jnp.asarray(w), bits, tile_cols=g)
    assert_same_leaves(got, want)
    assert tlin.infer_bits_params(got, K) == jlin.infer_bits_params(want, K) == bits


@pytest.mark.parametrize("fn", ["quantize_int8_absmax", "quantize_int8_outlier",
                                "quantize_int8_dynamic"])
def test_quantize_int8_bytes(rng, fn):
    w = rng.standard_normal((300, 24)).astype(np.float32)
    w[:, 5] = 0.0  # a dead channel: scale 1
    assert_same_leaves(getattr(tlin, fn)(t(w)), getattr(jlin, fn)(jnp.asarray(w)))


@pytest.mark.parametrize("bits,K,g", [(2, 780, 64), (3, 780, 64), (3, 2304, -1), (8, 64, -1),
                                      (2, 100, 32)])
def test_pack_prequantized_bytes(rng, bits, K, g):
    """GPTQ's packing: grouped sub-4-bit packs pad K to whole groups and append unit
    scales and zero zeros for the added groups."""
    n_groups = 1 if g == -1 else -(-K // g)
    q = rng.integers(0, 2**bits, size=(K, 8)).astype(np.float32)
    s = rng.random((n_groups, 8)).astype(np.float32)
    z = rng.integers(0, 2**bits, size=(n_groups, 8)).astype(np.float32)
    got = tlin.pack_prequantized(t(q), t(s), t(z), bits, groupsize=g)
    want = jlin.pack_prequantized(jnp.asarray(q), jnp.asarray(s), jnp.asarray(z), bits,
                                  groupsize=g)
    assert_same_leaves(got, want)


MODES = ["gptq.int4", "gptq.int3", "rtn.int2-g64", "gptq.int8-g128", "llm.int8",
         "llm.int8-rtn", "llm.int8-dyn", "gptq.mix", "gptq.mix-g32", "rtn.mix-a4m2h4",
         "gptq.mix-a3m2h8-g64", "gptq.mix-a4m4h4", "gptq.mix-a4m4h4-g64",
         "gptq.mix-a4m8h4-g64"]


@pytest.mark.parametrize("mode", MODES)
def test_quant_mode_grammar(mode):
    got = tlin.parse_quant_mode(mode)
    assert got == jlin.parse_quant_mode(mode)
    _, bits, gs = got
    for name in ("attn.c_attn", "attn.c_proj", "mlp.c_fc1", "mlp.c_proj", "lm_head"):
        assert tlin.resolve_bits(bits, name) == jlin.resolve_bits(bits, name)
        assert tlin.resolve_groupsize(bits, name, gs) == jlin.resolve_groupsize(bits, name, gs)
    assert tlin.mixed_mode_tag(bits) == jlin.mixed_mode_tag(bits)


def test_equal_width_mix_collapses_and_keeps_groupsize():
    """The mix quirk (`quant/linear.py:80-81`, ROADMAP.md queue 3): a mix whose widths
    are all equal collapses to the uniform int, so its ``-g64`` groups every
    projection, while a true mix of >= 4-bit widths keeps whole-row scales on them."""
    assert tlin.parse_quant_mode("gptq.mix-a4m4h4-g64") == ("gptq", 4, 64)
    _, bits, gs = tlin.parse_quant_mode("gptq.mix-a4m4h4-g64")
    assert all(tlin.resolve_groupsize(bits, n, gs) == 64
               for n in ("attn.c_attn", "mlp.c_fc1", "lm_head"))
    _, bits, gs = tlin.parse_quant_mode("gptq.mix-a4m8h4-g64")
    assert bits == {"attn": 4, "mlp": 8, "head": 4} and gs == 64
    assert all(tlin.resolve_groupsize(bits, n, gs) == -1
               for n in ("attn.c_attn", "mlp.c_fc1", "lm_head"))


@pytest.mark.parametrize("mode", ["gptq.int5", "awq.int4", "gptq.mix-a5m2h4"])
def test_quant_mode_grammar_rejects(mode):
    with pytest.raises(ValueError):
        jlin.parse_quant_mode(mode)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tlin.parse_quant_mode(mode)


# ---------------------------------------------------------------------------
# Dequantize and matmul against the JAX CPU path
# ---------------------------------------------------------------------------

def _pack(kind, w):
    wj = jnp.asarray(w)
    if kind == "absmax":
        return jlin.quantize_int8_absmax(wj)
    if kind == "outlier":
        return jlin.quantize_int8_outlier(wj, outlier_frac=0.02)
    if kind == "dynamic":
        return jlin.quantize_int8_dynamic(wj, threshold=3.0, max_outlier_frac=0.05)
    bits, g = kind
    return jlin.quantize_colblock(wj, bits, tile_cols=g)


KINDS = ["absmax", "outlier", "dynamic", (8, -1), (8, 64), (4, 64), (3, -1), (3, 64),
         (2, -1), (2, 64)]


@pytest.mark.parametrize("kind", KINDS, ids=str)
def test_dequant_and_quant_matmul_match_jax(rng, kind):
    K = 780
    w = rng.standard_normal((K, 40)).astype(np.float32)
    jp = _pack(kind, w)
    tp = to_port(jp)
    if "dyn_threshold" not in jp:
        assert_close(tlin.dequantize_with_k(tp, K).numpy(), jlin.dequantize_with_k(jp, K),
                     F32_REL)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    x[..., 11] *= 8.0  # an activation outlier column for the dynamic split
    got = tlin.quant_matmul(t(x), tp)
    want = jlin.quant_matmul(jnp.asarray(x), jp)
    assert_close(got.numpy(), want, F32_REL)


RAGGED_ROUND_TRIP_MIN = 1.0  # max |w - dequant(quant(w))| at K = 780, g64, unit normals
ALIGNED_ROUND_TRIP_MAX = 0.5  # the same at K = 768, where groups and tiles agree


@pytest.mark.parametrize("bits", [4, 8])
def test_ragged_group_rule_pinned(rng, bits):
    """K = 780 with 64-row groups: quantize_colblock makes 13 groups of 64 rows, but
    dequantization expands them in tiles of ceil(780/13) = 60 rows (`_expand_tiles`),
    so K-row 60 already reads group 1. The port keeps the JAX package's rule, and with
    it the defect (ROADMAP.md, queue 3): rows 60-63, 120-127, ... dequantize with the
    next group's scale and zero, so the round trip errs by more than a quantization
    step there, which it does not at K = 768."""
    K = 780
    w = rng.standard_normal((K, 16)).astype(np.float32)
    tp = tlin.quantize_colblock(t(w), bits, tile_cols=64)
    assert tp["scales"].shape[0] == 13
    deq = tlin.dequantize_with_k(tp, K)
    levels = tlin.unpack_levels(tp, K)
    s, z = tp["scales"], tp["zeros"]
    np.testing.assert_allclose(deq[60].numpy(), ((levels[60] - z[1]) * s[1]).numpy())
    np.testing.assert_allclose(deq[59].numpy(), ((levels[59] - z[0]) * s[0]).numpy())
    assert_close(deq.numpy(), jlin.dequantize_with_k(jlin.quantize_colblock(
        jnp.asarray(w), bits, tile_cols=64), K), F32_REL)
    ragged = (deq - t(w)).abs().max().item()
    w768 = t(w[:768])
    aligned = (tlin.dequantize_with_k(tlin.quantize_colblock(w768, bits, tile_cols=64), 768)
               - w768).abs().max().item()
    print(f"int{bits} round-trip max error: K=780 g64 {ragged:.3f}, K=768 g64 {aligned:.3f}")
    assert ragged > RAGGED_ROUND_TRIP_MIN and aligned < ALIGNED_ROUND_TRIP_MAX


# ---------------------------------------------------------------------------
# Plain K3 / K4 / K5 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

PALLAS = dict(interpret=True, out_dtype=jnp.float32, block_m=8, block_n=128)


@pytest.mark.parametrize("kind", ["absmax", (8, -1), (8, 64)], ids=str)
@pytest.mark.parametrize("M", [1, 9])
def test_int8_ref_matches_pallas(rng, kind, M):
    K, N = 256, 128
    jp = _pack(kind, rng.standard_normal((K, N)).astype(np.float32))
    x = rng.standard_normal((M, K)).astype(np.float32)
    tp = to_port(jp)
    got = quant_matmul_int8_ref(t(x), tp["qweight"], tp["scales"], tp["zeros"])
    kernel = j_qmm8(jnp.asarray(x), jp["qweight"], jp["scales"], jp["zeros"], unpack="bf16",
                    **PALLAS)
    assert_close(got.numpy(), kernel, KERNEL_REL)
    assert torch.equal(quant_matmul_int8(t(x), tp["qweight"], tp["scales"], tp["zeros"]), got)


@pytest.mark.parametrize("bits,g,unpack", [(2, -1, "bf16"), (2, 64, "bf16"),
                                           (2, 64, "bf16_groupdeq"), (3, -1, "bf16"),
                                           (3, 64, "bf16")])
@pytest.mark.parametrize("K", [256, 200])
def test_sub4_ref_matches_pallas(rng, bits, g, unpack, K):
    """K = 200 stores 200 rows ungrouped and 256 with 64-row groups: the pad rows meet
    zero activations in both versions."""
    N, M = 32, 4
    jp = _pack((bits, g), rng.standard_normal((K, N)).astype(np.float32))
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    tp = to_port(jp)
    kw = dict(PALLAS, block_n=None, unpack=unpack, block_k=8 if bits == 3 else 16)
    if bits == 2:
        got = quant_matmul_int2_ref(t(x), tp["qweight"], tp["scales"], tp["zeros"])
        kernel = j_qmm2(jnp.asarray(x), jp["qweight"], jp["scales"], jp["zeros"], **kw)
        wrapped = quant_matmul_int2(t(x), tp["qweight"], tp["scales"], tp["zeros"])
    else:
        got = quant_matmul_int3_ref(t(x), tp["qweight"], tp["qweight_hi"], tp["scales"],
                                    tp["zeros"])
        kernel = j_qmm3(jnp.asarray(x), jp["qweight"], jp["qweight_hi"], jp["scales"],
                        jp["zeros"], **kw)
        wrapped = quant_matmul_int3(t(x), tp["qweight"], tp["qweight_hi"], tp["scales"],
                                    tp["zeros"])
    assert_close(got.numpy(), kernel, KERNEL_REL)
    assert torch.equal(wrapped, got)  # the wrapper runs the plain version on the CPU


def test_new_wrappers_refuse_malformed_inputs():
    x = torch.zeros((1, 64))
    s = torch.ones((1, 8))
    with pytest.raises(ValueError, match="int8 or uint8"):
        quant_matmul_int8(x, torch.zeros((64, 8)), s, s)
    with pytest.raises(ValueError, match="K=64"):
        quant_matmul_int8(x, torch.zeros((60, 8), dtype=torch.int8), s, s)
    with pytest.raises(ValueError, match="scales/zeros"):
        quant_matmul_int8(x, torch.zeros((64, 8), dtype=torch.int8), torch.ones((65, 8)), s)
    with pytest.raises(ValueError, match="packs 32 rows"):
        quant_matmul_int2(x, torch.zeros((8, 8), dtype=torch.uint8), s, s)
    with pytest.raises(ValueError, match="qweight_hi"):
        quant_matmul_int3(x, torch.zeros((16, 8), dtype=torch.uint8),
                          torch.zeros((4, 8), dtype=torch.uint8), s, s)
