"""The split plan and the fold of the paged decode attention K7/K8
(`ops/cuda/paged_attention.py::paged_plan`, `csrc/paged_attention.cu`) on the CPU.

The kernels take their splits from the plan and refuse a plan that the shapes cannot
take (`lljt_paged_decode`). These tests hold the plan to that check and to what the
design needs at the 7B, 125M and 19M heads, for B in {1, 8, 32} and tables of 1 to 128
pages: the splits fill the card, none is shorter than a tile, a cluster stays within the
portable limit, and nothing of the plan reads the positions. Numpy emulations then hold
the kernels' arithmetic to the plain version: the two int8 decodes without I2F on all
256 levels (k's f16 form for the tensor cores, v's f32 form), and the order of the fold
(each warp over its warp tiles with one softmax update a tile, the lane groups of p v
summed by a butterfly, the warps in warp order, the splits in rank order).
"""
import inspect
import math
import re

import numpy as np
import pytest
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import paged_attention as pa

H100_SMS = 132
SOURCE = (_build.CSRC / "paged_attention.cu").read_text()
MODELS = ["7B", "125M", "19M"]


def kernel_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def kernel_accepts(plan: pa.PagedPlan, page: int, AP: int) -> bool:
    """The plan check of `lljt_paged_decode`, written out."""
    total = AP * page
    tile = kernel_constant("WARPS") * kernel_constant("WT")
    return (1 <= plan.splits <= kernel_constant("MAX_CLUSTER") and plan.span >= tile
            and plan.span % tile == 0 and plan.splits * plan.span >= total
            and (plan.splits - 1) * plan.span < total)


def heads(model):
    c = LLaMAConfig.from_name(model)
    return c.n_head, c.n_embd // c.n_head


def test_plan_constants_are_the_kernels():
    assert pa.PAGED_WARPS == kernel_constant("WARPS")
    assert pa.PAGED_WARP_TILE == kernel_constant("WT") == 16  # the rows of m16n8k16
    assert pa.PAGED_MAX_CLUSTER == kernel_constant("MAX_CLUSTER")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("page", [16, 128])
def test_plan_fills_the_card_in_whole_tiles(model, B, page):
    nh, hd = heads(model)
    for AP in range(1, 129):
        plan = pa.paged_plan(B, nh, hd, page, AP, H100_SMS)
        assert kernel_accepts(plan, page, AP), (model, B, page, AP, plan)
        n_tiles = -(-AP * page // plan.tile)
        # no split shorter than a tile; each split but the last takes span tokens
        assert plan.span >= plan.tile and AP * page - (plan.splits - 1) * plan.span >= 1
        # the card is filled, unless the cluster limit caps it: then the longest split
        # is as short as a cluster of whole tiles allows
        capped = plan.span == -(-n_tiles // pa.PAGED_MAX_CLUSTER) * plan.tile
        assert B * nh * plan.splits >= H100_SMS or capped, (model, B, page, AP, plan)
        # ... and no more splits than the aim of PAGED_BLOCKS_PER_SM blocks an SM needs
        want = -(-pa.PAGED_BLOCKS_PER_SM * H100_SMS // (B * nh))
        assert plan.splits <= max(1, min(want, n_tiles)), (model, B, page, AP, plan)


@pytest.mark.parametrize("AP", [64, 96, 128])
def test_plan_fills_the_card_at_the_serve_run_and_at_one_slot(AP):
    """The serve run's B = 8 over tables of 64-128 pages of 16, and B = 1, at 7B."""
    for B in (1, 8):
        plan = pa.paged_plan(B, 32, 128, 16, AP, H100_SMS)
        assert B * 32 * plan.splits >= H100_SMS, (B, AP, plan)


def test_plan_reads_no_positions():
    params = list(inspect.signature(pa.paged_plan).parameters)
    assert params == ["B", "nh", "hd", "page", "AP", "n_sm"]
    assert "pos" not in pa.paged_plan.__wrapped__.__code__.co_names
    # the wrapper plans from the shapes and the SM count, before it reads pos
    src = inspect.getsource(pa._launch)
    assert "paged_plan(B, nh, hd, page, AP, _build.sm_count(dev.index))" in src


def test_plan_takes_longer_tables_in_longer_splits():
    """A table longer than a full cluster of one-tile splits: each split takes more
    tiles, within one cluster (no second pass)."""
    plan = pa.paged_plan(1, 32, 128, 16, 256, H100_SMS)
    assert plan.splits == pa.PAGED_MAX_CLUSTER and plan.span == 8 * plan.tile
    plan = pa.paged_plan(1, 32, 128, 16, 2048, H100_SMS)
    assert plan.splits == pa.PAGED_MAX_CLUSTER and plan.splits * plan.span == 2048 * 16


def prmt(a: int, b: int, sel: int) -> int:
    """PTX prmt.b32 (default mode): result byte i is byte sel[4i:4i+3] of {b, a}."""
    pool = (b << 32) | a
    return sum(((pool >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


LEVELS = np.arange(-128, 128, dtype=np.int8)
WORDS = LEVELS.view(np.uint8).reshape(-1, 4).view("<u4").ravel().tolist()


def test_int8_decode_of_v_without_i2f_gives_back_every_level():
    """`levels4`: (level ^ 0x80) permuted into the low byte of 2^23, minus 2^23 + 128."""
    got = []
    for w in WORDS:
        x = w ^ 0x80808080
        for i in range(4):
            bits = np.array([prmt(x, 0x4B000000, 0x7540 | i)], dtype=np.uint32)
            got.append(bits.view(np.float32)[0] - np.float32(8388736.0))
    got = np.array(got, dtype=np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, LEVELS.astype(np.float32))


def test_int8_decode_of_k_without_i2f_gives_back_every_level():
    """`half2_levels`: (level ^ 0x80) under the f16 exponent of 1024 is 1152 + level,
    exactly; selectors 0x4140 and 0x4342 give the pairs of bytes 0, 1 and 2, 3."""
    got = []
    for w in WORDS:
        x = w ^ 0x80808080
        for sel in (0x4140, 0x4342):
            got.extend(np.array([prmt(x, 0x64646464, sel)], dtype=np.uint32).view(np.float16))
    got = np.array(got, dtype=np.float16)
    assert np.array_equal(got.astype(np.float32) - 1152, LEVELS.astype(np.float32))


def to_f16_scaled(q):
    """`load_q`: q times 2^-e in f16 (e = 0 unless max |q| >= 2^15), and 2^e."""
    e = max(0, int(np.frexp(np.float32(np.abs(q).max()))[1]) - 1 - 14)
    return (q * np.float32(2.0 ** -e)).astype(np.float16), np.float32(2.0 ** e)


def emulate(q, k, ks, v, vs, tables, pos, n_sm=H100_SMS):
    """K7's fold in numpy f32, in the kernel's order: the plan's splits; in a split, warp
    w's warp tiles of 16 tokens w, w + 4, ...; per warp tile the scores as the tensor
    cores form them (f16 q against 1152 + level, less 1152 * sum q), one update of the
    warp's max and sum, and p v over the tile; the warps merged in warp order, the
    splits in rank order."""
    B, nh, hd = q.shape
    page, AP = k.shape[2], tables.shape[1]
    plan = pa.paged_plan(B, nh, hd, page, AP, n_sm)
    WT = pa.PAGED_WARP_TILE
    scale_log2 = np.float32(math.log2(math.e) / math.sqrt(hd))
    out = np.zeros((B, nh, hd), np.float32)
    for b in range(B):
        n_all = max(0, min(int(pos[b]) + 1, AP * page))
        for h in range(nh):
            q16, qscale = to_f16_scaled(q[b, h])
            q32 = q16.astype(np.float32)
            off = np.float32(1152) * q32.sum(dtype=np.float32)

            def row(t):
                p = tables[b, t // page]
                return (k[p, h, t % page].astype(np.float32), ks[p, h, t % page],
                        v[p, h, t % page].astype(np.float32), vs[p, h, t % page])

            slots = []
            for r in range(-(-n_all // plan.span)):
                t_begin, t_end = r * plan.span, min((r + 1) * plan.span, n_all)
                n_wt = -(-(t_end - t_begin) // WT)
                warps = []
                for w in range(pa.PAGED_WARPS):
                    m, l, acc = -np.inf, np.float32(0), np.zeros(hd, np.float32)
                    for j in range(w, n_wt, pa.PAGED_WARPS):
                        t0 = t_begin + j * WT
                        rows = [row(t) for t in range(t0, min(t0 + WT, t_end))]
                        s = [(np.float32(np.dot(q32, kr + 1152)) - off) * qscale * scale_log2
                             * kss for kr, kss, _, _ in rows]
                        mx = max([m] + s)
                        alpha = np.float32(1) if mx == m else np.exp2(np.float32(m - mx))
                        p = [np.exp2(np.float32(si - mx)) for si in s]
                        l = np.float32(l * alpha + np.float32(sum(p)))
                        acc = (acc * alpha).astype(np.float32)
                        for pi, (_, _, vr, vss) in zip(p, rows):
                            acc = (acc + (pi * vss) * vr).astype(np.float32)
                        m = mx
                    warps.append((m, l, acc))
                M = max(wm for wm, _, _ in warps)
                L, A = np.float32(0), np.zeros(hd, np.float32)
                for wm, wl, wacc in warps:
                    wt = np.float32(0) if wm == -np.inf else np.exp2(np.float32(wm - M))
                    L, A = np.float32(L + wl * wt), (A + wacc * wt).astype(np.float32)
                slots.append((M, L, A))
            if slots:
                Mc = max(sm for sm, _, _ in slots)
                L, A = np.float32(0), np.zeros(hd, np.float32)
                for sm, sl, sa in slots:
                    wt = np.exp2(np.float32(sm - Mc))
                    L, A = np.float32(L + sl * wt), (A + sa * wt).astype(np.float32)
                out[b, h] = A / L
    return out, plan


# (n_head, head_dim, page, AP, positions): slots that end inside a split, at a split's
# last token, at a page edge, past their table (an idle slot), and at token 0
FOLD_CASES = [(2, 128, 16, 40, [639, 255, 300]), (2, 128, 16, 8, [15, 16, 127]),
              (2, 78, 3, 70, [209, 63, 64]), (3, 64, 8, 48, [383, 128, 7]),
              (2, 64, 8, 20, [0, 400, 159])]


@pytest.mark.parametrize("case", FOLD_CASES, ids=lambda c: f"{c[0]}x{c[1]}-p{c[2]}-ap{c[3]}")
def test_fold_order_matches_the_plain_version(case):
    """The emulated fold against `paged_decode_attention_ref` in f32, with q bf16-valued
    as the kernels take it (so f16 holds it exactly from 2^-14 up): the two differ only
    in the order of f32 sums, so within 2e-5 of the largest magnitude."""
    nh, hd, page, AP, pos = case
    rng = np.random.default_rng(sum(case[:4]))
    B, P = len(pos), AP * len(pos) + 1
    k = rng.integers(-127, 128, (P, nh, page, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (P, nh, page, hd)).astype(np.int8)
    ks = (rng.random((P, nh, page)) * 0.01 + 0.005).astype(np.float32)
    vs = (rng.random((P, nh, page)) * 0.01 + 0.005).astype(np.float32)
    tables = (rng.permutation(P - 1)[:B * AP].reshape(B, AP) + 1).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((B, nh, hd)).astype(np.float32))
    q = q.bfloat16().float().numpy()
    pos = np.array(pos, np.int32)
    got, plan = emulate(q, k, ks, v, vs, tables, pos)
    assert plan.splits > 1 or AP * page <= plan.tile
    want = pa.paged_decode_attention_ref(
        *map(torch.from_numpy, (q, k, ks, v, vs, tables, pos))).numpy()
    assert want.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= 2e-5 * np.abs(want).max(), (err, np.abs(want).max())
