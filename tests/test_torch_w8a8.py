"""K3's W8A8 mode in the port (`ops/cuda/quant_matmul.py`: `quant_matmul_int8(...,
unpack="int8dot")`, `quant_matmul_int8_w8a8`, its plain version and `w8a8_plan`) against
the JAX kernel's ``unpack="int8dot"`` (`lit_llama_ja_tpu/ops/pallas/quant_matmul.py`) in
interpret mode, on the CPU; and the JAX int8 kernel's unread K-rows at K = 780.

Tolerance: `torch_port_helpers.check_a8_rows`, row by row against max|want| of the case's
output: within 1e-5 where the port's int8 activation levels equal those of the JAX
formula, 3e-3 for a row with a level flipped at a .5 tie (at most one a group). Rows of
every M <= 64 go to JAX stacked in one call of 62 rows; above 64 rows the JAX plan takes
tiles of 2048 K-rows, not 256, and 65 rows go in a call of their own.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.ops.pallas.quant_matmul import _plan_tiles as j_plan_tiles
from lit_llama_ja_tpu.ops.pallas.quant_matmul import quant_matmul_int8 as j_qmm8
from lit_llama_ja_tpu.quant.linear import quantize_colblock, quantize_int8_absmax

from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm
from torch_port_helpers import EXACT_TOL, FLIP_TOL, check_a8_rows, emulate_a8

N = 96
MS = (1, 5, 16, 40)
HIGH_M = 65
# (K, groupsize): int8 absmax whole column (-1), uint8 asymmetric in 128-row groups, the
# 125M's K = 780 in 13 uint8 groups (the JAX plan's slices of 60 rows); whole-column
# K = 780 runs only above 64 rows (see test_jax_int8_kernel_leaves_rows_unread)
LOW_PACKS = [(512, -1), (512, 128), (780, 64)]
HIGH_PACKS = LOW_PACKS + [(780, -1)]


@functools.lru_cache(maxsize=None)
def _pack(K, groupsize):
    rng = np.random.default_rng(K + groupsize)
    w = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32))
    jp = (quantize_int8_absmax(w) if groupsize == -1
          else quantize_colblock(w, bits=8, tile_cols=groupsize))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(K, M, seed=0):
    return np.random.default_rng(seed + 7 * K + M).standard_normal((M, K)).astype(np.float32)


def _jax(x, jp, unpack="int8dot"):
    return np.asarray(j_qmm8(jnp.asarray(x), jp["qweight"], jp["scales"], jp["zeros"],
                             interpret=True, out_dtype=jnp.float32, unpack=unpack))


def _port(x, tp, unpack="int8dot"):
    return qm.quant_matmul_int8(torch.from_numpy(x), tp["qweight"], tp["scales"],
                                tp["zeros"], unpack=unpack).numpy()


def test_packs_are_signed_and_unsigned():
    assert _pack(512, -1)[1]["qweight"].dtype == torch.int8
    assert _pack(512, 128)[1]["qweight"].dtype == torch.uint8


@pytest.mark.parametrize("K,groupsize", LOW_PACKS)
def test_w8a8_matches_jax_interpret(K, groupsize):
    """Every M of `MS` through the port, each against the JAX kernel on the same rows
    (one JAX call of the rows stacked: the rows are independent at M <= 64)."""
    jp, tp = _pack(K, groupsize)
    xs = [_x(K, M) for M in MS]
    wants = np.split(_jax(np.concatenate(xs), jp), np.cumsum(MS)[:-1])
    for M, x, want in zip(MS, xs, wants):
        got = _port(x, tp)
        assert got.shape == (M, N) and got.dtype == np.float32
        plan = qm.w8a8_plan(K, tp["scales"].shape[0], M)
        check_a8_rows(got, want, x, plan, (K, groupsize, M))


@pytest.mark.parametrize("K,groupsize", HIGH_PACKS)
def test_w8a8_above_64_rows_matches_jax_interpret(K, groupsize):
    """65 rows against the JAX kernel's own call on them, with one large activation
    column (its group's scale decides its neighbours' levels)."""
    jp, tp = _pack(K, groupsize)
    x = _x(K, HIGH_M, seed=1)
    x[:, 7] *= 30.0
    plan = qm.w8a8_plan(K, tp["scales"].shape[0], HIGH_M)
    check_a8_rows(_port(x, tp), _jax(x, jp), x, plan, (K, groupsize, HIGH_M))


def test_exact_route_is_not_w8a8():
    """The exact wrapper sits more than 3e-3 max|want| from JAX's W8A8 on rows with a
    large column, while the W8A8 route is within the row rule: the tests see the mode."""
    jp, tp = _pack(512, 128)
    x = _x(512, 5, seed=2)
    x[:, 3] *= 50.0
    want = _jax(x, jp)
    assert np.abs(_port(x, tp, None) - want).max() > FLIP_TOL * np.abs(want).max()
    check_a8_rows(_port(x, tp), want, x, qm.w8a8_plan(512, 4, 5), "exact vs W8A8")


def test_w8a8_zero_groups_and_rows():
    """llm.int8-dyn zeroes its outlier columns before the bulk product: a group of x all
    zero (here a whole 256-element group, and whole rows) adds exactly nothing, against
    the JAX kernel too; no NaN from the amax floor."""
    jp, tp = _pack(512, -1)
    x = _x(512, 4, seed=3)
    x[1, 256:] = 0.0
    x[2] = 0.0
    got = _port(x, tp)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], 0.0)
    check_a8_rows(got, _jax(x, jp), x, qm.w8a8_plan(512, 1, 4), "zero groups")


# (K, G, M): whole columns, groups of 128 (two a tile at M <= 64), the 125M's 13 groups,
# the 7B's K = 4096 and 11008 (tiles of 256 K-rows at M <= 64; 2048 and 256 above)
PLANS = [(512, 1, 1), (512, 1, 65), (512, 4, 1), (512, 4, 100), (780, 13, 1), (780, 13, 65),
         (780, 1, 65), (4096, 1, 1), (4096, 1, 512), (11008, 1, 1), (11008, 1, 512),
         (4096, 32, 64), (4096, 32, 512)]


@pytest.mark.parametrize("K,G,M", PLANS)
def test_w8a8_plan_is_the_jax_plan(K, G, M):
    plan = qm.w8a8_plan(K, G, M)
    bk, gpt = j_plan_tiles(K, G, 256 if M <= 64 else 2048)
    assert plan.group == bk // gpt and plan.n_act == K // bk * gpt and plan.k_read == K
    assert plan.n_act == G * plan.rep


def test_jax_int8_kernel_leaves_rows_unread():
    """The reference's defect (ROADMAP queue 3): at K = 780 and M <= 64, `_plan_tiles(780,
    1, 256)` gives tiles of 8 K-rows, and the JAX kernel's 97 tiles never read K-rows
    776-779, in either mode. Its exact path equals the product over the first 776 rows
    and is far from the full one; the port's W8A8 plan refuses the case (and the tp-2
    shard's K = 390), while the port's exact K3 reads every row."""
    K, n = 780, 128
    rng = np.random.default_rng(780)
    w = rng.standard_normal((K, n)).astype(np.float32)
    jp = quantize_int8_absmax(jnp.asarray(w))
    x = rng.standard_normal((1, K)).astype(np.float32)
    assert j_plan_tiles(K, 1, 256) == (8, 1) and K // 8 * 8 == 776
    got = np.asarray(j_qmm8(jnp.asarray(x), jp["qweight"], jp["scales"], jp["zeros"],
                            interpret=True, out_dtype=jnp.float32, unpack="bf16"))
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    q = np.asarray(jp["qweight"], np.float64)
    s = np.asarray(jp["scales"], np.float64)
    first = (xb[:, :776] @ q[:776]) * s
    full = (xb @ q) * s
    assert np.abs(got - first).max() <= EXACT_TOL * np.abs(first).max()
    assert np.abs(got - full).max() > 1e-2 * np.abs(full).max()
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    exact = qm.quant_matmul_int8(torch.from_numpy(x), tp["qweight"], tp["scales"],
                                 tp["zeros"]).double().numpy()
    full_f32 = (x.astype(np.float64) @ q) * s  # the port's CPU route keeps x in f32
    np.testing.assert_allclose(exact, full_f32, rtol=0, atol=EXACT_TOL * np.abs(full).max())
    for k_rows in (780, 390):
        with pytest.raises(ValueError, match="does not cover"):
            qm.w8a8_plan(k_rows, 1, 1)
    with pytest.raises(ValueError, match="does not cover"):
        qm.quant_matmul_int8(torch.from_numpy(x), tp["qweight"], tp["scales"], tp["zeros"],
                             unpack="int8dot")


@pytest.mark.parametrize("unpack", ["int8dot_bc", "int8dot_bias", "bf16_u8", "INT8DOT"])
def test_unknown_unpack_names_raise(unpack):
    _, tp = _pack(512, -1)
    with pytest.raises(ValueError, match="unknown unpack"):
        qm.quant_matmul_int8(torch.zeros((1, 512)), tp["qweight"], tp["scales"], tp["zeros"],
                             unpack=unpack)


@pytest.mark.parametrize("K,groupsize", [(512, -1), (512, 128)])
def test_exact_names_keep_the_exact_route(K, groupsize):
    _, tp = _pack(K, groupsize)
    x = torch.from_numpy(_x(K, 5))
    want = qm.quant_matmul_int8(x, tp["qweight"], tp["scales"], tp["zeros"])
    got = qm.quant_matmul_int8(x, tp["qweight"], tp["scales"], tp["zeros"], unpack="bf16")
    assert torch.equal(got, want)
    assert torch.equal(want, qm.quant_matmul_int8_ref(x, tp["qweight"], tp["scales"],
                                                      tp["zeros"]))


def test_w8a8_out_dtype_and_leading_dims():
    _, tp = _pack(512, 128)
    x = torch.from_numpy(_x(512, 6)).reshape(2, 3, 512)
    f32 = qm.quant_matmul_int8_w8a8(x.bfloat16(), tp["qweight"], tp["scales"], tp["zeros"],
                                    out_dtype=torch.float32)
    assert f32.shape == (2, 3, N) and f32.dtype == torch.float32
    assert torch.equal(f32, qm.quant_matmul_int8_w8a8(x, tp["qweight"], tp["scales"],
                                                      tp["zeros"]))
    b16 = qm.quant_matmul_int8_w8a8(x.bfloat16(), tp["qweight"], tp["scales"], tp["zeros"])
    assert b16.dtype == torch.bfloat16 and torch.equal(b16, f32.bfloat16())


# (M, K, N, G, signed): groups of 60 split over blocks and ragged in K (a k32 step shared
# by two groups), a column tail, uint8 levels, tiles of 2048 rows above 64 rows
EMULATED = [(3, 120, 40, 2, True), (5, 120, 36, 2, False), (2, 256, 32, 1, False),
            (66, 256, 32, 1, True)]


@pytest.mark.parametrize("M,K,n,G,signed", EMULATED)
def test_kernel_emulation_matches_plain_version(M, K, n, G, signed):
    """`torch_port_helpers.emulate_a8` with the int8 and uint8 decoders of
    ``csrc/quant_matmul_a8.cu`` against the plain version."""
    rng = np.random.default_rng(M + K + n)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qw = (rng.integers(-127, 128, (K, n)).astype(np.int8) if signed
          else rng.integers(0, 256, (K, n)).astype(np.uint8))
    s = (rng.random((G, n)) * 0.01 + 0.005).astype(np.float32)
    z = (np.zeros((G, n)) if signed else rng.integers(0, 256, (G, n))).astype(np.float32)
    want = qm.quant_matmul_int8_w8a8_ref(*(torch.from_numpy(t) for t in (x, qw, s, z))).numpy()
    plan = qm.w8a8_plan(K, G, M)
    got = emulate_a8(x, [qw.view(np.uint8)], s, z, plan, "int8" if signed else "uint8",
                     0.0 if signed else 128.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_TOL * np.abs(want).max())


# (M, K, N, G): the launch plans of the 7B decode and prefill shapes and the 125M groups
LAUNCH = [(1, 4096, 4096, 1), (1, 11008, 4096, 1), (1, 4096, 32000, 1), (64, 4096, 12288, 1),
          (65, 4096, 4096, 1), (512, 11008, 4096, 1), (17, 780, 2340, 13)]


@pytest.mark.parametrize("M,K,n,G", LAUNCH)
def test_w8a8_launch_plan(M, K, n, G):
    plan = qm.w8a8_plan(K, G, M)
    lp = qm.a8_launch_plan(M, plan.k_read, n, plan.n_act, 132, [0])
    assert lp.Mpad >= M and lp.Mpad % (16 * lp.mt) == 0 and lp.Kpad == -(-K // 32) * 32
    assert 1 <= lp.ksplit <= min(plan.n_act, qm.A8_MAX_SPLIT)
    blocks = -(-n // qm.A8_COLS) * (lp.Mpad // (16 * lp.mt))
    assert lp.ksplit in (plan.n_act, qm.A8_MAX_SPLIT) or \
        blocks * lp.ksplit >= qm.A8_BLOCKS_PER_SM * 132
