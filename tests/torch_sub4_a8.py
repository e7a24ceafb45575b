"""The cases of K4's W2A8 and K5's W3A8 modes (`ops/cuda/quant_matmul_sub4.py`:
``quant_matmul_int2/int3(..., unpack="int8dot*")``, `quant_matmul_int2_a8`,
`quant_matmul_int3_a8`, their plain versions and `sub4_a8_plan`) against the JAX kernel's
``unpack="int8dot"``, ``"int8dot_bc"`` and ``"int8dot_fused"``
(`lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py`) in interpret mode, on the CPU; one
function per case, taking the width, run by `tests/test_torch_w2a8.py` (int2) and
`tests/test_torch_w3a8.py` (int3), a file each to keep each under its time budget.

Tolerance: `torch_port_helpers.check_a8_rows`, row by row against max|want| of the case's
output: within 1e-5 where the port's int8 activation levels equal those of the JAX
formula, 3e-3 for a row with a level flipped at a .5 tie (at most one a group). Rows of
every M <= 64 go to JAX stacked in one call of 62 rows; above 64 rows the JAX plan takes
tiles twice as deep, and 65 rows go in a call of their own.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.ops.pallas.quant_matmul_sub4 import _common_tiling
from lit_llama_ja_tpu.ops.pallas.quant_matmul_sub4 import quant_matmul_int2 as j_qmm2
from lit_llama_ja_tpu.ops.pallas.quant_matmul_sub4 import quant_matmul_int3 as j_qmm3
from lit_llama_ja_tpu.quant.linear import quantize_colblock

from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul_sub4 as qs
from torch_port_helpers import EXACT_TOL, FLIP_TOL, check_a8_rows, emulate_a8

N = 96
MS = (1, 5, 16, 40)
HIGH_M = 65
NAMES = qs.A8_MODES
# (K, groupsize, name): at M <= 64 (CASES), whole columns (K = 1024, and the 125M's 780
# over its 784 stored rows) under every name, 64-row groups at the 125M's K = 780 (13
# groups over 832 stored rows) under the JAX default "int8dot_bc" and at K = 256 (4
# groups) under the other names; above 64 rows (HIGH_CASES), K = 1024 whole-column under
# every name, and "int8dot_bc" at K = 780 whole-column and K = 256 in groups
CASES = ([(K, -1, name) for K in (1024, 780) for name in NAMES]
         + [(780, 64, "int8dot_bc"), (256, 64, "int8dot"), (256, 64, "int8dot_fused")])
HIGH_CASES = ([(1024, -1, name) for name in NAMES]
              + [(780, -1, "int8dot_bc"), (256, 64, "int8dot_bc")])


@functools.lru_cache(maxsize=None)
def pack(bits, K, groupsize):
    rng = np.random.default_rng(bits * K + groupsize)
    w = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32))
    jp = quantize_colblock(w, bits=bits, tile_cols=groupsize)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(K, M, seed=0):
    return np.random.default_rng(seed + 7 * K + M).standard_normal((M, K)).astype(np.float32)


def _leaves(bits, p):
    return ((p["qweight"], p["scales"], p["zeros"]) if bits == 2 else
            (p["qweight"], p["qweight_hi"], p["scales"], p["zeros"]))


def _jax(bits, x, jp, name):
    fn = j_qmm2 if bits == 2 else j_qmm3
    return np.asarray(fn(jnp.asarray(x), *_leaves(bits, jp), interpret=True,
                         out_dtype=jnp.float32, unpack=name))


def _port(bits, x, tp, name):
    fn = qs.quant_matmul_int2 if bits == 2 else qs.quant_matmul_int3
    return fn(torch.from_numpy(x), *_leaves(bits, tp), unpack=name).numpy()


def _plan(bits, K, tp, M):
    Kp = 4 * tp["qweight"].shape[0]
    return qs.sub4_a8_plan(K, Kp, tp["scales"].shape[0], M, bits)


@functools.lru_cache(maxsize=None)
def stacked_jax(bits, K, groupsize, name):
    jp, _ = pack(bits, K, groupsize)
    out = _jax(bits, np.concatenate([_x(K, M) for M in MS]), jp, name)
    return np.split(out, np.cumsum(MS)[:-1])


def matches_jax_interpret(bits, K, groupsize, name):
    """Every M of `MS` through the port, each against the JAX kernel on the same rows."""
    _, tp = pack(bits, K, groupsize)
    for M, want in zip(MS, stacked_jax(bits, K, groupsize, name)):
        x = _x(K, M)
        got = _port(bits, x, tp, name)
        assert got.shape == (M, N) and got.dtype == np.float32
        check_a8_rows(got, want, x, _plan(bits, K, tp, M), (bits, K, groupsize, name, M))


def above_64_rows_matches_jax_interpret(bits, K, groupsize, name):
    """65 rows against the JAX kernel's own call on them, with one large activation
    column."""
    jp, tp = pack(bits, K, groupsize)
    x = _x(K, HIGH_M, seed=1)
    x[:, 9] *= 30.0
    check_a8_rows(_port(bits, x, tp, name), _jax(bits, x, jp, name), x,
                  _plan(bits, K, tp, HIGH_M), (bits, K, groupsize, name, HIGH_M))


def exact_route_is_not_a8(bits):
    """The exact wrapper sits more than 3e-3 max|want| from JAX's A8 on rows with a large
    column: the tests see the mode."""
    K = 1024
    jp, tp = pack(bits, K, -1)
    x = _x(K, 5, seed=2)
    x[:, 3] *= 50.0
    want = _jax(bits, x, jp, "int8dot_bc")
    assert np.abs(_port(bits, x, tp, None) - want).max() > FLIP_TOL * np.abs(want).max()
    check_a8_rows(_port(bits, x, tp, "int8dot_bc"), want, x,
                  _plan(bits, K, tp, 5), (bits, "exact vs A8"))


def exact_names_keep_the_exact_route(bits, unpack):
    _, tp = pack(bits, 780, 64)
    x = torch.from_numpy(_x(780, 5))
    fn = qs.quant_matmul_int2 if bits == 2 else qs.quant_matmul_int3
    ref = qs.quant_matmul_int2_ref if bits == 2 else qs.quant_matmul_int3_ref
    want = fn(x, *_leaves(bits, tp))
    assert torch.equal(fn(x, *_leaves(bits, tp), unpack=unpack), want)
    assert torch.equal(want, ref(x, *_leaves(bits, tp)))


def refused_names(bits, unpack, match):
    _, tp = pack(bits, 1024, -1)
    fn = qs.quant_matmul_int2 if bits == 2 else qs.quant_matmul_int3
    with pytest.raises(ValueError, match=match):
        fn(torch.zeros((1, 1024)), *_leaves(bits, tp), unpack=unpack)


def zero_rows(bits):
    """All-zero rows give zeros and no NaN (the amax floor); a zero row beside others
    leaves them as they were."""
    _, tp = pack(bits, 780, 64)
    x = np.zeros((3, 780), np.float32)
    x[1] = _x(780, 1)[0]
    got = _port(bits, x, tp, "int8dot")
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[[0, 2]], 0.0)
    np.testing.assert_array_equal(got[1], _port(bits, x[1:2], tp, "int8dot")[0])


def out_dtype_and_leading_dims(bits):
    _, tp = pack(bits, 1024, -1)
    fn = qs.quant_matmul_int2_a8 if bits == 2 else qs.quant_matmul_int3_a8
    x = torch.from_numpy(_x(1024, 6)).reshape(2, 3, 1024)
    f32 = fn(x.bfloat16(), *_leaves(bits, tp), out_dtype=torch.float32)
    assert f32.shape == (2, 3, N) and f32.dtype == torch.float32
    assert torch.equal(f32, fn(x, *_leaves(bits, tp)))
    b16 = fn(x.bfloat16(), *_leaves(bits, tp))
    assert b16.dtype == torch.bfloat16 and torch.equal(b16, f32.bfloat16())


# (K, Kp, G, M): the 7B's whole columns (K = 11008 over 11264 stored rows) and 64-row
# groups, the 125M's 780 (784 stored rows whole, 832 in 13 groups) and 2304 (3072 stored),
# at M <= 64 and above
PLANS = [(4096, 4096, 1, 1), (4096, 4096, 1, 65), (11008, 11264, 1, 1), (11008, 11264, 1, 512),
         (4096, 4096, 64, 1), (11008, 11264, 176, 16), (11008, 11264, 176, 512),
         (780, 784, 1, 1), (780, 784, 1, 65), (780, 832, 13, 1), (780, 832, 13, 100),
         (2304, 3072, 1, 1), (2304, 3072, 48, 8)]


def plan_is_the_jax_plan(bits, K, Kp, G, M):
    """`sub4_a8_plan` against the JAX wrappers' `_common_tiling` (default block_k 256
    packed rows for int2, 128 bit-plane rows for int3): groups of 4 ``bk2 // gpt`` K
    elements, ``n_k * gpt`` of them, covering K."""
    rows = Kp // 4 if bits == 2 else Kp // 8
    _, bk, gpt = _common_tiling(M, N, G, rows, None, None, 256 if bits == 2 else 128)
    plan = qs.sub4_a8_plan(K, Kp, G, M, bits)
    bk2 = bk if bits == 2 else 2 * bk
    assert plan.group == 4 * (bk2 // gpt) and plan.n_act == rows // bk * gpt
    assert K <= plan.k_read <= Kp and plan.n_act == G * plan.rep


def plan_refusals(bits):
    """Plans the JAX kernel cannot run raise: a pack with more scale rows than its
    stored rows can slice into whole K-rows, and (int3) slices of an odd number of int2
    rows, whose bit-plane slices would cover other K-rows than their int2 rows."""
    with pytest.raises(ValueError, match="does not cover"):
        qs.sub4_a8_plan(88, 88, 3, 1, bits)  # 22 int2 rows in 3 slices of 7: row 21 unread
    if bits == 3:
        with pytest.raises(ValueError, match="does not cover"):
            qs.sub4_a8_plan(40, 40, 2, 1, 3)  # 5 bit-plane rows: int2 slices of 5 rows


# (M, K, Kp, N, G): a group of 784 K elements over stored pad rows, 13 groups of 64,
# groups of 40 K elements (a k32 step shared by two groups), a column tail, two row tiles
EMULATED = [(3, 780, 784, 40, 1), (2, 780, 832, 36, 13), (5, 76, 80, 32, 2),
            (17, 256, 256, 33, 4)]


def kernel_emulation_matches_plain_version(bits, M, K, Kp, n, G):
    """`torch_port_helpers.emulate_a8` with the int2 or int3 decoder of
    ``csrc/quant_matmul_sub4_a8.cu`` against the plain version, on random stored bytes."""
    rng = np.random.default_rng(bits + M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    planes = [rng.integers(0, 256, (Kp // 4, n)).astype(np.uint8)]
    if bits == 3:
        planes.append(rng.integers(0, 256, (Kp // 8, n)).astype(np.uint8))
    s = (rng.random((G, n)) * 0.01 + 0.005).astype(np.float32)
    z = rng.integers(0, 2**bits, (G, n)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, *planes, s, z)]
    ref = qs.quant_matmul_int2_a8_ref if bits == 2 else qs.quant_matmul_int3_a8_ref
    want = ref(*t).numpy()
    plan = qs.sub4_a8_plan(K, Kp, G, M, bits)
    got = emulate_a8(x, planes, s, z, plan, f"int{bits}", 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_TOL * np.abs(want).max())


def launch_plan(bits, M, K, Kp, n, G):
    """The launch plan reads x̂ up to the groups' end rounded to 32 bytes, past K over
    stored pad rows."""
    plan = qs.sub4_a8_plan(K, Kp, G, M, bits)
    lp = qm.a8_launch_plan(M, plan.k_read, n, plan.n_act, 132, [0, 0])
    assert lp.Kpad == -(-plan.k_read // 32) * 32 and lp.Kpad >= K
    assert 1 <= lp.ksplit <= min(plan.n_act, qm.A8_MAX_SPLIT)
    assert not qm.a8_launch_plan(M, plan.k_read, n, plan.n_act, 132, [0, 8]).vec
