"""K1's W4A8 modes in the port (`ops/cuda/quant_matmul.py`: `quant_matmul_int4(...,
unpack=)`, `quant_matmul_int4_w4a8`, its plain version and `w4a8_plan`) against the
JAX kernel's ``unpack="int8dot*"`` modes (`lit_llama_ja_tpu/ops/pallas/quant_matmul.py`)
in interpret mode, on the CPU.

Tolerance, row by row, against max|want| of the case's output. The int8 activations
are recomputed in numpy from the JAX kernel's formula (f32 ``127 / max(amax, 1e-30)``,
``round_half_even(x * rsx)``). A row whose port levels all equal them is within 1e-5
(the same integer sums; the epilogue's f32 order alone differs between the four
names). A row may differ from them only by levels whose ``x * rsx`` lies within 4 ulp
of a .5 tie, at most one a group, and is then within 3e-3 (one level flipped moves a
row by about 1e-3). Anything else fails. The exact route on the same inputs is more
than 3e-3 away from JAX's W4A8, so these tests tell the mode from the exact path.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.ops.pallas.quant_matmul import _plan_tiles as j_plan_tiles
from lit_llama_ja_tpu.ops.pallas.quant_matmul import quant_matmul_int4 as j_qmm4
from lit_llama_ja_tpu.quant.linear import quantize_colblock as j_quantize_colblock

from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm
from torch_port_helpers import EXACT_TOL, FLIP_TOL, emulate_a8
from torch_port_helpers import check_a8_rows as check_rows

NAMES = qm.W4A8_MODES
MS = (1, 5, 16, 40)
N = 96
# (K, groupsize): whole-column and grouped packs, and the 125M's K = 780 whole and in
# groups of 64 (13 scale rows: the JAX plan's ragged slices of 60)
PACKS = [(256, -1), (256, 32), (1024, -1), (1024, 128), (780, -1), (780, 64)]


@functools.lru_cache(maxsize=None)
def _pack(K, groupsize):
    rng = np.random.default_rng(K + groupsize)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jp = j_quantize_colblock(jnp.asarray(w), bits=4, tile_cols=groupsize)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(K, M, seed=0):
    return np.random.default_rng(seed + 7 * K + M).standard_normal((M, K)).astype(np.float32)


def _jax(x, jp, name):
    return np.asarray(j_qmm4(jnp.asarray(x), jp["qweight"], jp["scales"], jp["zeros"],
                             interpret=True, out_dtype=jnp.float32, unpack=name))


def _port(x, tp, name):
    return qm.quant_matmul_int4(torch.from_numpy(x), tp["qweight"], tp["scales"],
                                tp["zeros"], unpack=name).numpy()


GRID = [(2048, 1), (2048, 32), (5504, 1), (5504, 86), (390, 1), (390, 13), (128, 1),
        (128, 4), (512, 8), (1024, 3), (1536, 12), (16000, 1)]


@pytest.mark.parametrize("Kq,G", GRID)
def test_plan_tiles_is_the_jax_plan(Kq, G):
    assert qm.plan_tiles(Kq, G, qm.W4A8_BLOCK_K[0]) == j_plan_tiles(Kq, G, 512)
    assert qm.plan_tiles(Kq, G, qm.W4A8_BLOCK_K[1]) == j_plan_tiles(Kq, G, 1024)


# the activation groups (K elements) of the 7B and 125M shapes, by the JAX plan
GROUPS = [(2048, 1, 1024), (2048, 32, 128), (5504, 1, 256), (5504, 86, 128), (390, 1, 780),
          (390, 13, 60)]


@pytest.mark.parametrize("Kq,G,group", GROUPS)
def test_w4a8_plan_groups(Kq, G, group):
    plan = qm.w4a8_plan(Kq, G, 64)
    assert plan.group == group and plan.n_act * plan.group == 2 * Kq
    assert plan.n_act == G * plan.rep  # every activation group has one scale row
    bk, gpt = j_plan_tiles(Kq, G, 512)
    assert plan.group == 2 * bk // gpt


def test_w4a8_plan_refuses_what_the_jax_kernel_cannot_run():
    with pytest.raises(ValueError, match="does not cover"):
        qm.w4a8_plan(1000, 3, 1)  # tiles of 333 rows leave one row out


# the plans on both sides of 64 rows: the JAX function's block_k is 512 packed rows at
# M <= 64 and 1024 above
PLAN_MS = [(1, 512), (64, 512), (65, 1024), (512, 1024)]


@pytest.mark.parametrize("M,block_k", PLAN_MS)
@pytest.mark.parametrize("Kq,G", [(2048, 1), (1024, 1), (5504, 1), (2048, 32), (390, 13)])
def test_w4a8_plan_follows_m(M, block_k, Kq, G):
    plan = qm.w4a8_plan(Kq, G, M)
    bk, gpt = j_plan_tiles(Kq, G, block_k)
    assert plan.group == 2 * bk // gpt and plan.n_act == Kq // bk * gpt


@pytest.mark.parametrize("K", [2048, 4096])
def test_w4a8_above_64_rows_matches_jax_interpret(K):
    """65 rows of a whole-column pack against the JAX function's own call on the same 65
    rows, with one large activation column: above 64 rows the JAX plan rounds x in
    groups of 2048 K elements, not 1024, so the large column sets the scale of twice as
    many neighbours (the M <= 64 groups put the row 5e-2 of max|want| off)."""
    jp, tp = _pack(K, -1)
    x = _x(K, 65, seed=1)
    x[:, 5] *= 40.0
    want = _jax(x, jp, "int8dot_bias")
    got = _port(x, tp, "int8dot_bias")
    plan = qm.w4a8_plan(K // 2, 1, 65)
    assert plan.group == 2048
    check_rows(got, want, x, plan, (K, 65))


@functools.lru_cache(maxsize=None)
def stacked_jax(K, groupsize, name):
    """JAX's W4A8 on the rows of every M of `MS` stacked (the rows are independent, and
    one interpret-mode call a case keeps the file fast): one array per M."""
    jp, _ = _pack(K, groupsize)
    out = _jax(np.concatenate([_x(K, M) for M in MS]), jp, name)
    return np.split(out, np.cumsum(MS)[:-1])


@pytest.mark.parametrize("K,groupsize", PACKS)
@pytest.mark.parametrize("name", NAMES)
def test_w4a8_matches_jax_interpret(K, groupsize, name):
    """Every M of `MS` through the port, each against the JAX kernel on the same rows."""
    _, tp = _pack(K, groupsize)
    xs = [_x(K, M) for M in MS]
    for M, x, want in zip(MS, xs, stacked_jax(K, groupsize, name)):
        got = _port(x, tp, name)
        assert got.shape == (M, N) and got.dtype == np.float32
        plan = qm.w4a8_plan(K // 2, tp["scales"].shape[0], M)
        check_rows(got, want, x, plan, (K, groupsize, name, M))


@pytest.mark.parametrize("K,groupsize", PACKS)
def test_exact_route_is_not_w4a8(K, groupsize):
    """The exact wrapper sits more than 3e-3 max|want| from JAX's W4A8 on the same rows,
    while the W4A8 route is within the row rule: the tests see the mode."""
    _, tp = _pack(K, groupsize)
    x = np.concatenate([_x(K, M) for M in MS])
    want = np.concatenate(stacked_jax(K, groupsize, "int8dot_bias"))
    exact = qm.quant_matmul_int4(torch.from_numpy(x), tp["qweight"], tp["scales"],
                                 tp["zeros"]).numpy()
    assert np.abs(exact - want).max() > FLIP_TOL * np.abs(want).max()
    plan = qm.w4a8_plan(K // 2, tp["scales"].shape[0], x.shape[0])
    check_rows(_port(x, tp, "int8dot_fused"), want, x, plan, (K, groupsize))


@pytest.mark.parametrize("name", NAMES)
def test_w4a8_zero_rows(name):
    """All-zero rows give zeros and no NaN (the amax floor), as the JAX kernel's
    `tests/test_pallas_kernels.py::test_int4_int8dot_zero_rows`; a zero row beside
    others leaves them as they were."""
    jp, tp = _pack(256, -1)
    x = np.zeros((3, 256), np.float32)
    x[1] = _x(256, 1)[0]
    got = _port(x, tp, name)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[[0, 2]], 0.0)
    np.testing.assert_array_equal(got[1], _port(x[1:2], tp, name)[0])
    if name == "int8dot":  # the JAX test's mode
        np.testing.assert_allclose(_jax(x, jp, name)[[0, 2]], 0.0, atol=1e-6)


@pytest.mark.parametrize("unpack", ["int8", "int8dot_biass", "BF16", "int4"])
def test_unknown_unpack_names_raise(unpack):
    _, tp = _pack(256, -1)
    with pytest.raises(ValueError, match="unknown unpack"):
        qm.quant_matmul_int4(torch.zeros((1, 256)), tp["qweight"], tp["scales"], tp["zeros"],
                             unpack=unpack)


@pytest.mark.parametrize("unpack", ["bf16", "bf16_u8", "f32dot", "arith", "arith_bf16"])
def test_exact_names_keep_the_exact_route(unpack):
    _, tp = _pack(256, 32)
    x = torch.from_numpy(_x(256, 5))
    want = qm.quant_matmul_int4(x, tp["qweight"], tp["scales"], tp["zeros"])
    got = qm.quant_matmul_int4(x, tp["qweight"], tp["scales"], tp["zeros"], unpack=unpack)
    assert torch.equal(got, want)


def test_w4a8_out_dtype_and_leading_dims():
    """bf16 x gives bf16 out by default (x is cast to bf16 in both); ``out_dtype`` f32
    keeps the f32 sum; leading dims pass through."""
    _, tp = _pack(1024, 128)
    x = torch.from_numpy(_x(1024, 6)).reshape(2, 3, 1024)
    f32 = qm.quant_matmul_int4_w4a8(x.bfloat16(), tp["qweight"], tp["scales"], tp["zeros"],
                                    out_dtype=torch.float32)
    assert f32.shape == (2, 3, N) and f32.dtype == torch.float32
    assert torch.equal(f32, qm.quant_matmul_int4_w4a8(x, tp["qweight"], tp["scales"],
                                                      tp["zeros"]))
    b16 = qm.quant_matmul_int4_w4a8(x.bfloat16(), tp["qweight"], tp["scales"], tp["zeros"])
    assert b16.dtype == torch.bfloat16 and torch.equal(b16, f32.bfloat16())


# (M, K, N, G): the launch plans of the 7B decode shapes and of the 125M's groups
LAUNCH = [(1, 4096, 4096, 1), (1, 4096, 12288, 1), (1, 11008, 4096, 1), (1, 4096, 32000, 1),
          (16, 4096, 4096, 32), (64, 11008, 4096, 86), (17, 780, 2340, 13), (40, 780, 780, 1),
          (512, 4096, 4096, 1)]


@pytest.mark.parametrize("M,K,N,G", LAUNCH)
def test_w4a8_launch_plan(M, K, N, G):
    """Row tiles cover M (up to 64 rows a block); the split never cuts a group and fills
    about `W4A8_BLOCKS_PER_SM` blocks an SM of an H100 (132 SMs) where the groups allow;
    16-byte loads need N % 16 == 0 and an aligned base."""
    plan = qm.w4a8_plan(K // 2, G, M)
    lp = qm.a8_launch_plan(M, plan.k_read, N, plan.n_act, 132, [0])
    assert lp.Mpad >= M and lp.Mpad % (16 * lp.mt) == 0 and lp.Mpad - M < 16 * lp.mt
    assert lp.mt == min(4, -(-M // 16)) and lp.Kpad % 32 == 0 and lp.Kpad - K < 32
    assert 1 <= lp.ksplit <= min(plan.n_act, qm.A8_MAX_SPLIT)
    blocks = -(-N // qm.A8_COLS) * (lp.Mpad // (16 * lp.mt))
    assert lp.ksplit == plan.n_act or lp.ksplit == qm.A8_MAX_SPLIT or \
        blocks * lp.ksplit >= qm.A8_BLOCKS_PER_SM * 132
    assert lp.vec == (N % 16 == 0)
    assert not qm.a8_launch_plan(M, plan.k_read, N, plan.n_act, 132, [8]).vec


# ---------------------------------------------------------------------------
# The kernel's data movement, emulated lane by lane in numpy
# ---------------------------------------------------------------------------

def emulate_kernel(x, qw, s, z):
    """`torch_port_helpers.emulate_a8` with the int4 decoder (``csrc/qmm_a8.cuh`` and
    ``csrc/quant_matmul_w4a8.cu``) over `w4a8_plan`'s groups."""
    plan = qm.w4a8_plan(qw.shape[0], s.shape[0], x.shape[0])
    return emulate_a8(x, [qw], s, z, plan, "int4", 8.0)


# (M, K, N, G): groups of 60 split over two blocks and ragged in K (a step shared by
# two groups), the 125M's 780-element group, a column and row tail, a scale row
# repeated over two activation groups (whole column at K = 2048), two row tiles
EMULATED = [(5, 120, 40, 2), (3, 780, 36, 1), (17, 2048, 32, 1), (2, 200, 70, 5)]


@pytest.mark.parametrize("M,K,N,G", EMULATED)
def test_kernel_emulation_matches_plain_version(M, K, N, G):
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qw = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    s = (rng.random((G, N)) * 0.01 + 0.005).astype(np.float32)
    z = rng.integers(0, 16, (G, N)).astype(np.float32)
    want = qm.quant_matmul_int4_w4a8_ref(*(torch.from_numpy(t) for t in (x, qw, s, z))).numpy()
    got = emulate_kernel(x, qw, s, z)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_TOL * np.abs(want).max())
