"""The K1 and K3-K5 prefill GEMM's plan (`ops/cuda/quant_matmul.py::gemm_plan`) on the
CPU.

The GEMM (`csrc/qmm_generic.cuh`) copies x, the packed rows and the scales by
``cp.async`` at widths the plan picks from K, N and the base pointers, and refuses a
width that a pitch or a pointer cannot take. These tests hold the plan to the rule the
kernel checks, at every linear of the 7B, 125M and 19M models and at every layer view
of a stacked tree that `prepare_launch` accepts, so no launch accepted before is
refused; and to its tile rule: 128-wide tiles unless they would leave half the card
idle.
"""
import pytest
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import gemm_plan, weight_alignment
from lit_llama_ja_tpu_torch.quant.linear import sub4_pad_rows

H100_SMS = 132
LAYERS = 3  # layer views of a stacked (L, ...) tree


def linear_shapes(name):
    """(K, N) of every linear of a model: c_attn, attn c_proj, c_fc1/c_fc2, mlp c_proj,
    lm_head."""
    c = LLaMAConfig.from_name(name)
    D, H = c.n_embd, c.n_hidden
    return [(D, 3 * D), (D, D), (D, H), (H, D), (D, c.padded_vocab_size)]


def kernel_accepts(plan, K, N, x_ptr, packed_ptrs, scale_ptrs):
    """The check of `qmm::launch_gemm` (csrc/qmm_generic.cuh), written out."""
    bn, xw, ww, sw = plan
    x_ok = xw == 2 or (xw in (4, 8, 16) and (2 * K) % xw == 0 and x_ptr % xw == 0)
    w_ok = ww == 1 or (ww in (4, 8, 16) and N % ww == 0
                       and all(p % ww == 0 for p in packed_ptrs))
    s_ok = sw == 4 or (sw == 16 and N % 4 == 0 and all(p % 16 == 0 for p in scale_ptrs))
    return x_ok and w_ok and s_ok and bn in (64, 128)


def packed_rows(bits, K, groupsize):
    """Stored rows of each packed plane and the scale groups of one linear."""
    if bits in (4, 8):
        return [K // (8 // bits)], -(-K // groupsize) if groupsize > 0 else 1
    Kp = sub4_pad_rows(K, groupsize)
    G = Kp // groupsize if groupsize > 0 else 1
    return ([Kp // 4, Kp // 8] if bits == 3 else [Kp // 4]), G


def stacked_views(bits, K, N, groupsize, base=1 << 20):
    """Base pointers of each layer view of stacked (L, rows, N) leaves, one allocation
    per leaf (the allocator aligns each base to at least 64 bytes)."""
    rows, G = packed_rows(bits, K, groupsize)
    views = []
    for layer in range(LAYERS):
        packed = [base * (i + 1) + layer * r * N for i, r in enumerate(rows)]
        scales = [base * 8 + layer * G * N * 4, base * 9 + layer * G * N * 4]
        views.append((packed, scales))
    return views


@pytest.mark.parametrize("model", ["7B", "125M", "19M"])
@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (8, -1), (8, 128), (2, -1),
                                            (2, 64), (3, -1)])
def test_plan_takes_every_layer_view_of_the_models(model, bits, groupsize):
    for K, N in linear_shapes(model):
        for packed, scales in stacked_views(bits, K, N, groupsize):
            # the views prepare_launch accepts (weight_alignment), as a launch sees them
            assert all(p % weight_alignment(torch.empty(0, dtype=torch.uint8), N) == 0
                       for p in packed)
            for M in (17, 512, 2048):
                plan = gemm_plan(M, K, N, H100_SMS, 0, packed, scales)
                assert kernel_accepts(plan, K, N, 0, packed, scales), (K, N, plan)
                # model widths never leave cp.async: K and N are multiples of 4
                assert plan[1] >= 8 and plan[2] >= 4 and plan[3] == 16, (K, N, plan)


@pytest.mark.parametrize("K,N", linear_shapes("7B"))
def test_tile_rule_fills_the_card_at_the_7b_prefill(K, N):
    """128-wide tiles at every linear of the 7B prefill: at N = 4096 they launch 128
    blocks on 132 SMs, which measured faster than 256 blocks of 64."""
    bn = gemm_plan(512, K, N, H100_SMS, 0, [0], [0, 0])[0]
    assert 2 * -(-N // bn) * -(-512 // 128) >= H100_SMS
    assert bn == 128


@pytest.mark.parametrize("M,K,N,bn", [(128, 4096, 4096, 64), (128, 11008, 4096, 64),
                                      (128, 4096, 11008, 128), (128, 4096, 12288, 128),
                                      (2048, 780, 780, 128), (2048, 2304, 780, 128),
                                      (17, 780, 2340, 64), (17, 4096, 32000, 128)])
def test_tile_rule_halves_the_tile_where_the_card_would_sit_half_idle(M, K, N, bn):
    """64-wide tiles only where 128-wide ones would launch fewer blocks than half the
    SMs: a 128-token chunk at N = 4096 (32 blocks), not the 125M rows at N = 780
    (112)."""
    assert gemm_plan(M, K, N, H100_SMS, 0, [0], [0, 0])[0] == bn


@pytest.mark.parametrize("K", [1, 2, 3, 4, 6, 8, 91, 780])
def test_plan_never_refuses_an_accepted_view(K):
    """Every N and every base offset that `prepare_launch` lets through (packed rows
    aligned to weight_alignment, f32 leaves to theirs) gets widths the kernel takes;
    odd K and N fall back to plain loads."""
    for N in range(1, 41):
        wa = weight_alignment(torch.empty(0, dtype=torch.uint8), N)
        sa = weight_alignment(torch.empty(0, dtype=torch.float32), N)
        for off in range(0, 33):
            packed = [4096 + off * wa, 8192 + off * wa]
            scales = [4096 + off * sa, 8192 + 2 * off * sa]
            plan = gemm_plan(40, K, N, H100_SMS, 0, packed, scales)
            assert kernel_accepts(plan, K, N, 0, packed, scales), (K, N, off, plan)
            assert (plan[1] == 2) == (K % 2 == 1)
            assert (plan[2] == 1) == (N % 4 != 0)


def shard_shapes():
    """(K, N) of the linears a rank multiplies on a mesh (`parallel/`): the 7B's at tp = 2
    and the hops of `ring_quant_matmul` with n = 2 ((K/n, N/n)), and the 125M's at tp = 2
    (the row-parallel c_proj of K = 390, the column-parallel c_attn of N = 1170)."""
    c = LLaMAConfig.from_name("7B")
    D, H, V = c.n_embd, c.n_hidden, c.padded_vocab_size
    return [(D, 3 * D // 2), (D // 2, D), (D, H // 2), (H // 2, D), (D, V // 2),
            (D // 2, D // 2), (D // 2, H // 2), (H // 2, D // 2), (390, 780), (780, 1170)]


@pytest.mark.parametrize("bits,groupsize", [(4, -1), (4, 128), (8, -1), (8, 128)])
@pytest.mark.parametrize("K,N", shard_shapes())
def test_plan_takes_every_shard_shape(bits, groupsize, K, N):
    """Every layer view of a shard gets widths the kernel takes, cp.async wherever the
    model widths allow it, and the 7B prefill shards (M = 512) keep 128-wide tiles
    where those fill half the card."""
    for packed, scales in stacked_views(bits, K, N, groupsize):
        for M in (17, 512, 2048):
            plan = gemm_plan(M, K, N, H100_SMS, 0, packed, scales)
            assert kernel_accepts(plan, K, N, 0, packed, scales), (K, N, plan)
            # the 125M c_attn at tp = 2 has N = 1170: 4-byte scale copies
            assert plan[1] >= 4 and plan[3] == (16 if N % 4 == 0 else 4), (K, N, plan)
    bn = gemm_plan(512, K, N, H100_SMS, 0, [0], [0, 0])[0]
    assert bn == (128 if 2 * -(-N // 128) * 4 >= H100_SMS else 64)
