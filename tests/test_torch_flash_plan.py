"""The flash-attention plan (`ops/cuda/flash_attention.py::flash_plan`) on the CPU.

K2 and K6 (`csrc/flash_attention_fwd.cu`, `csrc/flash_attention_bwd.cu`) copy their
tiles by ``cp.async`` at the width the plan picks, and refuse rows that do not start on
it. These tests hold the plan to what the kernels take at every K2 and K6 case that
`chip_smoke.py` drives (the model's strided views, ragged T, T = 1, head dims 40 to
128), to the shared memory of a block, to the copy route measured faster for the 125M
model's hd 78 views, and to its block-size rule; and the Python constants that mirror
the CUDA sources to those sources.
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import flash_attention as fa

H100_SMS = 132
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may take on an H100
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def layouts(B, nh, T, hd, strided):
    """q, k, v, dO as `chip_smoke.attention_inputs` lays them out, on the meta device:
    views of one (B, T, 3, nh, hd) projection and a transposed (B, T, nh, hd) gradient,
    or contiguous (B, nh, T, hd) tensors."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    if strided:
        qkv = empty(B, T, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return q, k, v, empty(B, T, nh, hd).transpose(1, 2)
    return tuple(empty(B, nh, T, hd) for _ in range(4))


def model_views(B, nh, T, hd):
    """q and k as RoPE's (B, T, nh, hd) outputs transposed, v as a head view of the
    (B, T, 3C) projection, dO as autograd hands it over (models/llama.py)."""
    C = nh * hd
    rope = torch.empty((B, T, nh, hd), dtype=torch.bfloat16, device="meta")
    qkv = torch.empty((B, T, 3 * C), dtype=torch.bfloat16, device="meta")
    v = qkv[..., 2 * C:].reshape(B, T, nh, hd).transpose(1, 2)
    return rope.transpose(1, 2), rope.transpose(1, 2), v, rope.transpose(1, 2)


def plan_of(tensors):
    B, nh, T, hd = tensors[0].shape
    return fa.flash_plan(B, nh, T, hd, [t.stride()[:3] for t in tensors], H100_SMS,
                         [2 * t.storage_offset() for t in tensors])


def kernel_takes(plan, tensors) -> bool:
    """The kernels' rule: every row of every input starts on ``width`` bytes; an input
    the plan realigns is copied into rows of hd rounded up to 8 elements, which do."""
    hd = tensors[0].shape[-1]
    if plan.rows not in (64, 128) or plan.width not in (4, 8, 16) or hd % 2 or hd > 128:
        return False
    for t, realign in zip(tensors, plan.realign):
        if realign:
            hd8 = hd + -hd % 8
            strides, ptr = (t.shape[1] * t.shape[2] * hd8, t.shape[2] * hd8, hd8), 0
        else:
            strides, ptr = t.stride()[:3], 2 * t.storage_offset()
        if any((2 * s) % plan.width for s in strides) or ptr % plan.width:
            return False
    return True


K2_CASES = ([(1, nh, T, hd, False) for nh, hd in CS.K2_SHAPES for T in CS.K2_LENGTHS]
            + list(CS.K2_EDGES))
K6_CASES = [(B, nh, 2048, hd, True) for B, nh, hd in CS.K6_SHAPES] + list(CS.K6_EDGES)


def test_the_cases_cover_the_head_dims_and_lengths_the_kernels_pad_or_cut():
    hds = {c[3] for c in K2_CASES + K6_CASES}
    assert {40, 64, 78, 96, 128} <= hds
    assert 1 in {c[2] for c in K2_CASES + K6_CASES}


@pytest.mark.parametrize("B,nh,T,hd,strided", K2_CASES + K6_CASES)
def test_plan_takes_every_chip_smoke_case(B, nh, T, hd, strided):
    tensors = layouts(B, nh, T, hd, strided)
    for inputs in (tensors[:3], tensors):  # K2 (q, k, v) and K6 (q, k, v, dO)
        plan = plan_of(inputs)
        assert kernel_takes(plan, inputs), (B, nh, T, hd, strided, plan)
        assert plan.smem <= SMEM_LIMIT, plan
        if B * nh * T >= fa.REALIGN_MIN_ROWS:
            assert plan.width == 16  # realigned where the layout allows less


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("hd", [40, 64, 78, 80, 96, 128])
def test_every_kernel_fits_a_block(rows, hd):
    smem = fa.flash_smem(hd, rows)
    assert set(smem) == {"fwd", "dq", "dkv"} and max(smem.values()) <= SMEM_LIMIT, smem


def test_the_125m_views_take_the_realigned_16_byte_route():
    """hd 78 heads lie 156 bytes apart, so the views allow only 4-byte copies; the plan
    copies all four inputs into rows 80 elements apart and copies 16 bytes at a time,
    the route measured faster on an H100 in both kernels (PERF.md, section 6)."""
    views = model_views(4, 10, 2048, 78)
    assert [fa.row_alignment(t.stride()[:3], 2 * t.storage_offset()) for t in views] == [4] * 4
    plan = plan_of(views)
    assert plan.realign == (True,) * 4 and plan.width == 16 and plan.rows == 128
    assert plan.kv_rows == 64 and plan.q_rows == 64


def test_without_realignment_the_plan_copies_at_the_narrowest_rows():
    views = model_views(4, 10, 2048, 78)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "REALIGN_MIN_ROWS", 2**62)
        plan = plan_of(views)
    assert plan.realign == (False,) * 4 and plan.width == 4 and kernel_takes(plan, views)


@pytest.mark.parametrize("B,T", [(1, 128), (1, 512), (1, 2048), (2, 2048)])
def test_short_calls_copy_straight_from_the_views(B, T):
    """Below REALIGN_MIN_ROWS the realigning copies cost more than they save (one
    sequence of up to 2048 tokens at 10 heads, measured on an H100, PERF.md section 6)."""
    views = model_views(B, 10, T, 78)
    plan = plan_of(views)
    assert plan.realign == (False,) * 4 and plan.width == 4 and kernel_takes(plan, views)


def test_aligned_inputs_are_not_copied():
    """The 7B prefill's q, k, v (32 x 128, T 512) take 16-byte copies as they are."""
    plan = plan_of(model_views(1, 32, 512, 128)[:3])
    assert plan.realign == (False,) * 3 and plan.width == 16


@pytest.mark.parametrize("off", range(8))
def test_row_alignment_follows_strides_and_base(off):
    want = 16 if off % 8 == 0 else 8 if off % 4 == 0 else 4
    assert fa.row_alignment((1024, 256, 128), 2 * off) == want
    assert fa.row_alignment((1024, 256, 130), 0) == 4  # 260-byte rows


def test_128_row_blocks_at_the_7b_prefill():
    """32 heads x 4 blocks of 128 rows = 128 blocks on 132 SMs. A 64-row block (two
    warps of 32 rows) would give 256 and fill the card, but measured slower on an H100
    (device time 0.0285 against 0.0254 ms, `flash_probe`, PERF.md section 6): it copies every
    k/v tile once per 64 rows instead of once per 128."""
    plan = fa.flash_plan(1, 32, 512, 128, [(32 * 512 * 128, 512 * 128, 128)] * 3, H100_SMS)
    assert plan.rows == 128
    assert 2 * 32 * 4 >= H100_SMS  # at least half the SMs busy


@pytest.mark.parametrize("B,nh,T,rows", [(1, 32, 512, 128), (4, 10, 2048, 128),
                                         (1, 8, 2048, 128), (1, 2, 200, 64), (3, 2, 1, 64),
                                         (1, 10, 777, 128), (2, 3, 130, 64)])
def test_block_rule_halves_the_block_where_the_card_would_sit_half_idle(B, nh, T, rows):
    plan = fa.flash_plan(B, nh, T, 64, [(nh * T * 64, T * 64, 64)] * 3, H100_SMS)
    assert plan.rows == rows
    assert (2 * B * nh * -(-T // 128) >= H100_SMS) == (rows == 128)


def _c_int(source: str, pattern: str) -> str:
    text = (_build.CSRC / source).read_text()
    m = re.search(pattern, text)
    assert m, (source, pattern)
    return m.group(1)


def test_python_constants_mirror_the_cuda_sources():
    assert int(_c_int("flash_common.cuh", r"constexpr int KV_ROWS = (\d+);")) == fa.KV_ROWS
    assert int(_c_int("flash_common.cuh", r"fwd_stages\(\) \{ return (\d+); \}")) == fa.FWD_STAGES
    assert int(_c_int("flash_common.cuh", r"bwd_stages\(\) \{ return (\d+); \}")) == fa.BWD_STAGES
    assert _c_int("flash_attention_bwd.cu", r"dkv_q_rows\(\) \{ return (HDP > 80 \? \d+ : \d+); \}") \
        == f"HDP > 80 ? {fa.DKV_Q_ROWS_WIDE} : {fa.DKV_Q_ROWS}"
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        text = (_build.CSRC / src).read_text()
        assert "rows != 64 && rows != 128" in text and "width != 4 && width != 8 && width != 16" in text
