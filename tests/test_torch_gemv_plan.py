"""The decode GEMV's plan (`ops/cuda/quant_matmul.py::gemv_plan`) on the CPU.

The GEMV of K1, K3, K4 and K5 (`csrc/qmm_gemv.cuh`) takes the K split (the blocks of a
thread-block cluster), its route and its load widths from the plan, and refuses a plan
that a shape or a pointer cannot take (`qmmv::launch`). These tests hold the plan to
that rule at every layer view of the 7B, 125M and 19M linears, int4, int8, int2 (whole
columns and 64-row groups over the padded K) and int3, at every M from 1 to 16, so that
no launch the wrapper accepts is refused; and to what the design needs: 16-byte loads
wherever the rows allow them, the fast route on every 7B view, a split within the
cluster limit that fills the card at 4096 x 4096, scale groups counted over the padded
K, and the ragged ones flagged.
"""
import pytest
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    GEMV_MAX_CLUSTER,
    GEMV_MAX_M,
    GemvPlan,
    _gemv_plan,
    gemv_plan,
    weight_alignment,
)
from lit_llama_ja_tpu_torch.quant.linear import sub4_pad_rows

H100_SMS = 132
LAYERS = 3  # layer views of a stacked (L, ...) tree
KERNEL_MAX_CLUSTER = 8  # qmmv::MAX_CLUSTER
BATCH = {4: 4, 8: 2, 2: 4, 3: 4}  # Dec::U: k16 steps a batch of loads on the fast route


def linear_shapes(name):
    """(K, N) of every linear of a model: c_attn, attn c_proj, c_fc1/c_fc2, mlp c_proj,
    lm_head."""
    c = LLaMAConfig.from_name(name)
    D, H = c.n_embd, c.n_hidden
    return [(D, 3 * D), (D, D), (D, H), (H, D), (D, c.padded_vocab_size)]


def kernel_accepts(plan: GemvPlan, M, K, N, G, bits, x_ptr, packed_ptr, scale_ptrs, Kp=None,
                   hi_ptr=0):
    """The check of `qmmv::launch` (csrc/qmm_gemv.cuh) and of the entry points, written
    out; ``Kp`` the stored K-rows (K but for int2/int3), ``hi_ptr`` int3's second plane."""
    Kp = K if Kp is None else Kp
    S = -(-K // 16)
    split_ok = (1 <= plan.ksplit <= KERNEL_MAX_CLUSTER and plan.steps >= 1
                and plan.ksplit * plan.steps >= S and (plan.ksplit - 1) * plan.steps < S)
    w_ok = plan.lw == 1 or (plan.lw in (4, 8, 16) and N % plan.lw == 0
                            and packed_ptr % plan.lw == 0 and hi_ptr % plan.lw == 0)
    x_ok = plan.xw == 2 or (plan.xw == 16 and K % 8 == 0 and x_ptr % 16 == 0)
    s_ok = plan.sw == 4 or (plan.sw == 16 and N % 4 == 0
                            and all(p % 16 == 0 for p in scale_ptrs))
    gsz = -(-Kp // G)
    fast_ok = ((plan.lw, plan.xw, plan.sw) == (16, 16, 16) and K % 16 == 0
               and plan.steps % BATCH[bits] == 0 and (G == 1 or gsz % (16 * BATCH[bits]) == 0))
    return (1 <= M <= 16 and K <= Kp and 1 <= G <= Kp and split_ok and w_ok and x_ok and s_ok
            and (fast_ok or not plan.fast) and (bits != 4 or K % 2 == 0))


def views(bits, K, N, G, base=1 << 20):
    """Base pointers of each layer view of stacked (L, rows, N) leaves, one allocation
    per leaf (the allocator aligns each base to at least 64 bytes)."""
    rows = K // 2 if bits == 4 else K
    return [(base + layer * rows * N,
             [base * 8 + layer * G * N * 4, base * 9 + layer * G * N * 4])
            for layer in range(LAYERS)]


@pytest.mark.parametrize("model", ["7B", "125M", "19M"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("groupsize", [-1, 128])
def test_plan_takes_every_layer_view_at_every_row_count(model, bits, groupsize):
    for K, N in linear_shapes(model):
        G = 1 if groupsize < 0 else -(-K // groupsize)
        for packed, scales in views(bits, K, N, G):
            # the views prepare_launch accepts, as a launch sees them
            assert packed % weight_alignment(torch.empty(0, dtype=torch.uint8), N) == 0
            for M in range(1, GEMV_MAX_M + 1):
                plan = gemv_plan(M, K, N, G, H100_SMS, 0, packed, scales, bits)
                assert kernel_accepts(plan, M, K, N, G, bits, 0, packed, scales), (K, N, plan)
                assert plan.ksplit <= GEMV_MAX_CLUSTER, plan
                # 16-byte loads exactly where N and the base allow them
                assert (plan.lw == 16) == (N % 16 == 0 and packed % 16 == 0), (K, N, plan)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N", linear_shapes("7B"))
def test_7b_decode_takes_the_fast_route(bits, K, N):
    """Every 7B linear, whole-column or in 128-row groups, at the serve step's M = 8 too:
    16-byte loads, the fast route, whole batches of loads a split."""
    for G in (1, K // 128):
        for M in (1, 8, 16):
            plan = gemv_plan(M, K, N, G, H100_SMS, 0, 0, [0, 0], bits)
            assert plan.fast and (plan.lw, plan.xw, plan.sw) == (16, 16, 16), plan
            assert plan.steps % BATCH[bits] == 0 and not plan.straddle, plan


@pytest.mark.parametrize("bits", [4, 8])
def test_split_fills_the_card_in_one_wave_at_4096(bits):
    """N = 4096 has 32 column tiles: the K split gives at least one block an SM, and no
    more than three (one wave), within the portable cluster size."""
    plan = gemv_plan(1, 4096, 4096, 1, H100_SMS, 0, 0, [0, 0], bits)
    blocks = plan.ksplit * -(-4096 // plan.cols)
    assert H100_SMS <= blocks <= 3 * H100_SMS, plan
    assert 1 < plan.ksplit <= 8, plan


@pytest.mark.parametrize("K,G,straddle", [(780, 13, True), (90, 2, True), (4096, 32, False),
                                          (4096, 1, False), (1000, 3, True), (768, 6, False)])
def test_ragged_groups_are_flagged_and_take_the_general_route(K, G, straddle):
    """K = 780 in 13 groups of 60 rows and K = 90 in 2 of 45: k16 steps straddle a group
    boundary, which only the general route handles (one product per group, x masked)."""
    for bits in (4, 8):
        plan = gemv_plan(3, K, 2340, G, H100_SMS, 0, 0, [0, 0], bits)
        assert plan.straddle == straddle, plan
        if straddle:
            assert not plan.fast, plan


@pytest.mark.parametrize("K", [2, 8, 90, 91, 780, 1000])
def test_plan_never_refuses_an_accepted_view(K):
    """Every N and every base offset that `prepare_launch` lets through (packed rows
    aligned to weight_alignment, f32 leaves to theirs) gets a plan the kernel takes;
    odd N falls back to byte loads and odd K to 2-byte copies of x."""
    for bits in (4, 8):
        if bits == 4 and K % 2:
            continue
        for N in range(1, 41):
            wa = weight_alignment(torch.empty(0, dtype=torch.uint8), N)
            sa = weight_alignment(torch.empty(0, dtype=torch.float32), N)
            for off in range(0, 17):
                packed = 4096 + off * wa
                scales = [4096 + off * sa, 8192 + 2 * off * sa]
                for M in (1, 9):
                    plan = gemv_plan(M, K, N, 1, H100_SMS, 2 * off, packed, scales, bits)
                    assert kernel_accepts(plan, M, K, N, 1, bits, 2 * off, packed, scales), (
                        K, N, off, plan)
                    assert (plan.lw == 1) == (N % 4 != 0)
                    assert (plan.xw == 2) == (K % 8 != 0 or off % 8 != 0)


def test_plan_is_memoized_on_pointer_residues():
    gemv_plan(1, 4096, 4096, 1, H100_SMS, 0, 0, [0, 0], 4)
    from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import _gemv_plan
    hits = _gemv_plan.cache_info().hits
    assert gemv_plan(1, 4096, 4096, 1, H100_SMS, 1 << 30, 1 << 31, [1 << 20, 1 << 21], 4) == \
        gemv_plan(1, 4096, 4096, 1, H100_SMS, 0, 0, [0, 0], 4)
    assert _gemv_plan.cache_info().hits >= hits + 2


# the sub-4-bit packs the models run: (bits, groupsize); -1: whole columns
SUB4_MODES = [(2, -1), (2, 64), (3, -1)]


def sub4_views(bits, K, N, groupsize, base=1 << 20):
    """(Kp, G, views) of a stacked (L, ...) int2 or int3 pack as `quantize` stores it:
    Kp = sub4_pad_rows(K, groupsize) rows, G = Kp / groupsize groups; each view is
    (packed, hi, scales) pointers, hi 0 for int2."""
    Kp = sub4_pad_rows(K, groupsize)
    G = 1 if groupsize < 0 else Kp // groupsize
    out = []
    for layer in range(LAYERS):
        hi = base * 3 + layer * (Kp // 8) * N if bits == 3 else 0
        out.append((base + layer * (Kp // 4) * N, hi,
                    [base * 8 + layer * G * N * 4, base * 9 + layer * G * N * 4]))
    return Kp, G, out


@pytest.mark.parametrize("model", ["7B", "125M", "19M"])
@pytest.mark.parametrize("bits,groupsize", SUB4_MODES)
def test_plan_takes_every_sub4_layer_view_at_every_row_count(model, bits, groupsize):
    """int2 and int3 over the padded K (11008 -> 11264, 2304 -> 3072, 780 -> 784 or 832
    in 64-row groups): every layer view at every M gets a plan the kernel takes, with
    16-byte loads exactly where N and both planes' bases allow them."""
    for K, N in linear_shapes(model):
        Kp, G, views_ = sub4_views(bits, K, N, groupsize)
        for packed, hi, scales in views_:
            assert packed % weight_alignment(torch.empty(0, dtype=torch.uint8), N) == 0
            for M in range(1, GEMV_MAX_M + 1):
                plan = gemv_plan(M, K, N, G, H100_SMS, 0, packed, scales, bits, Kp,
                                 hi or None)
                assert kernel_accepts(plan, M, K, N, G, bits, 0, packed, scales, Kp, hi), (
                    K, Kp, N, G, plan)
                assert (plan.lw == 16) == (N % 16 == 0 and packed % 16 == 0
                                           and hi % 16 == 0), (K, N, plan)


def test_padded_k_of_the_models():
    assert [sub4_pad_rows(K, gs) for K, gs in
            [(11008, -1), (11008, 64), (2304, -1), (2304, 64), (780, -1), (780, 64),
             (4096, 64)]] == [11264, 11264, 3072, 3072, 784, 832, 4096]


@pytest.mark.parametrize("bits,groupsize", SUB4_MODES)
@pytest.mark.parametrize("K,N", linear_shapes("7B"))
def test_7b_sub4_decode_takes_the_fast_route(bits, groupsize, K, N):
    """Every 7B view of gptq.int2, gptq.int3 and the mix's int2 64-row groups, at the
    serve step's M = 8 too: 16-byte loads of both planes, the fast route, whole
    batches of loads a split, no group boundary inside a k16 step."""
    Kp, G, views_ = sub4_views(bits, K, N, groupsize, base=1 << 24)
    for packed, hi, scales in views_:
        for M in (1, 8, 16):
            plan = gemv_plan(M, K, N, G, H100_SMS, 0, packed, scales, bits, Kp, hi or None)
            assert plan.fast and (plan.lw, plan.xw, plan.sw) == (16, 16, 16), plan
            assert plan.steps % BATCH[bits] == 0 and not plan.straddle, plan
            assert kernel_accepts(plan, M, K, N, G, bits, 0, packed, scales, Kp, hi), plan


@pytest.mark.parametrize("bits", [2, 3])
def test_sub4_groups_are_counted_over_the_padded_k(bits):
    """K 780 in 64-row groups stores Kp = 832 rows in G = 13 groups: 64 rows a group
    over Kp (no k16 step straddles a boundary), where ceil(K / G) would give 60 (and
    straddle). K 780 in 13 groups over Kp = 784: 61 rows, ragged."""
    plan = gemv_plan(3, 780, 2340, 13, H100_SMS, 0, 0, [0, 0], bits, 832)
    assert not plan.straddle and not plan.fast, plan  # K % 16 != 0: the general route
    assert kernel_accepts(plan, 3, 780, 2340, 13, bits, 0, 0, [0, 0], 832)
    assert gemv_plan(3, 780, 2340, 13, H100_SMS, 0, 0, [0, 0], bits, 784).straddle
    # at K % 16 == 0 the group size over Kp decides the route: 4096 in 64 groups of 64
    # over Kp 4096 is fast; 4000 rows over Kp 4096 in 64 groups too, though
    # ceil(4000 / 64) = 63 would not be
    assert gemv_plan(1, 4096, 4096, 64, H100_SMS, 0, 0, [0, 0], bits, 4096).fast
    plan = gemv_plan(1, 4000, 4096, 64, H100_SMS, 0, 0, [0, 0], bits, 4096)
    assert plan.fast and not plan.straddle, plan


@pytest.mark.parametrize("K", [8, 90, 100, 780, 1000])
def test_sub4_plan_never_refuses_an_accepted_view(K):
    """Every N and base offset of both planes that `prepare_launch` lets through gets a
    plan the kernel takes, with stored rows past K."""
    Kp = sub4_pad_rows(K)
    for bits in (2, 3):
        for N in range(1, 41):
            wa = weight_alignment(torch.empty(0, dtype=torch.uint8), N)
            sa = weight_alignment(torch.empty(0, dtype=torch.float32), N)
            for off in range(0, 9):
                packed = 4096 + off * wa
                hi = 8192 + (off // 2) * wa if bits == 3 else 0
                scales = [4096 + off * sa, 8192 + 2 * off * sa]
                for M in (1, 9):
                    plan = gemv_plan(M, K, N, 1, H100_SMS, 2 * off, packed, scales, bits, Kp,
                                     hi or None)
                    assert kernel_accepts(plan, M, K, N, 1, bits, 2 * off, packed, scales,
                                          Kp, hi), (K, N, off, plan)
                    assert (plan.lw == 1) == (N % 4 != 0)


def test_sub4_plan_refuses_what_the_kernel_cannot_take():
    for bad in [dict(bits=2, Kp=90), dict(bits=4, Kp=112), dict(bits=5, Kp=100)]:
        with pytest.raises(ValueError):
            gemv_plan(1, 100, 64, 1, H100_SMS, 0, 0, [0, 0], bad["bits"], bad["Kp"])


def test_int3_plan_is_memoized_on_the_second_planes_residue():
    """Two int3 views that differ only in qweight_hi's residue get different plans
    (the narrower loads for the misaligned plane), each from its own memo entry."""
    args = (1, 4096, 4096, 1, H100_SMS, 0, 0, [0, 0], 3, 4096)
    aligned = gemv_plan(*args, 1 << 20)
    misses = _gemv_plan.cache_info().misses
    shifted = gemv_plan(*args, (1 << 20) + 8)
    assert _gemv_plan.cache_info().misses == misses + 1
    assert aligned.lw == 16 and aligned.fast, aligned
    assert shifted.lw == 8 and not shifted.fast, shifted
    hits = _gemv_plan.cache_info().hits
    assert gemv_plan(*args, 1 << 24) == aligned and gemv_plan(*args, (1 << 24) + 8) == shifted
    assert _gemv_plan.cache_info().hits == hits + 2


def shard_shapes():
    """(K, N, G) of the linears a rank multiplies on a mesh (`parallel/`): the 7B's at
    tp = 2 (column-parallel c_attn, c_fc1/c_fc2 and lm_head, row-parallel c_proj) and the
    hops of `ring_quant_matmul` with n = 2 on 4096 x 4096 and 4096 x 11008 ((K/n, N/n));
    whole-column, and in the groups a shard takes by the whole matrix's tile rule: 128
    rows, and the 125M's K = 780 in groups of 64 (13 tiles of 60) cut at 390 rows
    (13 tiles of 30, `parallel/sharded.k_shard_groups`)."""
    c = LLaMAConfig.from_name("7B")
    D, H, V = c.n_embd, c.n_hidden, c.padded_vocab_size
    tp = [(D, 3 * D // 2), (D // 2, D), (D, H // 2), (H // 2, D), (D, V // 2)]
    hops = [(D // 2, D // 2), (D // 2, H // 2), (H // 2, D // 2)]
    out = [(K, N, G) for K, N in tp + hops for G in (1, K // 128)]
    return out + [(780, 390, 13), (390, 2340, 13), (390, 780, 13)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N,G", shard_shapes())
def test_plan_takes_every_shard_shape(bits, K, N, G):
    """The shard shapes are new keys of the memoized plan: every layer view at every M
    gets a plan the kernel takes; the 7B shards take the fast route; the ragged 125M
    shard is flagged and takes the general one."""
    for packed, scales in views(bits, K, N, G):
        for M in range(1, GEMV_MAX_M + 1):
            plan = gemv_plan(M, K, N, G, H100_SMS, 0, packed, scales, bits)
            assert kernel_accepts(plan, M, K, N, G, bits, 0, packed, scales), (K, N, G, plan)
    plan = gemv_plan(1, K, N, G, H100_SMS, 0, 0, [0, 0], bits)
    if K % 128 == 0:
        assert plan.fast and not plan.straddle, plan
    else:
        assert plan.straddle and not plan.fast, plan
