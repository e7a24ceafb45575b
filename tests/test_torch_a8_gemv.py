"""The decode route of the A8 kernel (``a8_gemv`` of csrc/qmm_a8.cuh, planned by
`ops/cuda/quant_matmul.py::a8_gemv_plan`) on the CPU: a numpy emulation of the kernel as
the CUDA source writes it, held to the plain versions of K1's W4A8, K3's W8A8 (int8 and
uint8) and K4/K5's W2A8/W3A8 modes, and tests of its plan.

The emulation follows a block of the kernel lane by lane: each block rounds the
activation groups that its k32 steps reach (amax over the whole group, ``127 / amax`` by
IEEE division, round half to even) and stages x̂ of its steps; each warp takes its share
of the block's steps, each lane loads 16 bytes of each stored row that its K-rows need
and decodes them into the A registers of ``mma.sync`` m16n8k32 (``gfrag`` of
csrc/quant_matmul_w4a8.cu, csrc/quant_matmul_a8.cu and csrc/quant_matmul_sub4_a8.cu),
the B registers are x̂'s row ``g`` with the bytes outside the group masked; a warp's
int32 sums go to its block's D when it leaves a group, the blocks' D are added, and each
(row, column) folds the groups in order in f32. Tolerance: `torch_port_helpers.check_a8_rows` (1e-5 of max|want| a row,
3e-3 for a row with a level flipped at a .5 tie; the emulation rounds as the plain
version does, so no level flips).
"""
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul_sub4 as qs
from lit_llama_ja_tpu_torch.quant.linear import sub4_pad_rows
from torch_port_helpers import check_a8_rows, keep_bytes, spread2

COLS = qm._GEMV_COLS
WARPS = qm.GEMV_WARPS
MS = (1, 5, 16)


# ---------------------------------------------------------------------------
# The decoders of the decode route (gfrag), on the 32 lanes' words at once
# ---------------------------------------------------------------------------

def byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` on arrays of 32-bit words (held in uint64)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= b[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def byte_of(v, b):
    return (v >> (8 * b)) & 0xFF


def high4(n):
    return ((n | (n << 7) | (n << 14) | (n << 21)) & 0x01010101) << 2


def fused_word(t):
    return ((((t & 0x000F000F) << 4) ^ 0x00800080) | ((t & 0x00F000F0) << 8)) & 0xFFFFFFFF


def _frag8(w, j, signed):
    wd, p = j >> 1, 2 * (j & 1)
    sel = p | (p + 4) << 4 | (p + 1) << 8 | (p + 5) << 12
    a = []
    for h in range(2):
        lo = byte_perm(w[4 * h][:, wd], w[4 * h + 1][:, wd], sel)
        hi = byte_perm(w[4 * h + 2][:, wd], w[4 * h + 3][:, wd], sel)
        a += [byte_perm(lo, hi, 0x5410), byte_perm(lo, hi, 0x7632)]
    return a if signed else [v ^ 0x80808080 for v in a]


def _frag4(w, j):
    wd, p = j >> 1, 2 * (j & 1)
    a = []
    for h in range(2):
        r0, r1 = w[2 * h][:, wd], w[2 * h + 1][:, wd]
        a += [fused_word(byte_perm(r0, r1, p | (p + 4) << 8)),
              fused_word(byte_perm(r0, r1, (p + 1) | (p + 5) << 8))]
    return a


def _frag2(w, j):
    p, v0, v1 = 2 * (j & 1), w[0][:, j >> 1], w[1][:, j >> 1]
    return [spread2(byte_of(v0, p)), spread2(byte_of(v0, p + 1)),
            spread2(byte_of(v1, p)), spread2(byte_of(v1, p + 1))]


def _frag3(w, j):
    p, h = 2 * (j & 1), w[2][:, j >> 1]
    h0, h1 = byte_of(h, p), byte_of(h, p + 1)
    a = _frag2(w, j)
    return [a[0] | high4(h0 & 0xF), a[1] | high4(h1 & 0xF), a[2] | high4(h0 >> 4),
            a[3] | high4(h1 >> 4)]


# name -> (GU, [(plane, stored row of load i of step s for lanes t)], gfrag(w, j), SHIFT)
DECODERS = {
    "int8": (1, [(0, lambda s, t, i=i: 32 * s + 8 * t + i) for i in range(8)],
             lambda w, j: _frag8(w, j, True), 0),
    "uint8": (1, [(0, lambda s, t, i=i: 32 * s + 8 * t + i) for i in range(8)],
              lambda w, j: _frag8(w, j, False), 0),
    "int4": (1, [(0, lambda s, t, i=i: 16 * s + 4 * t + i) for i in range(4)], _frag4, 4),
    "int2": (2, [(0, lambda s, t, i=i: 8 * s + 2 * t + i) for i in range(2)], _frag2, 0),
    "int3": (1, [(0, lambda s, t: 8 * s + 2 * t), (0, lambda s, t: 8 * s + 2 * t + 1),
                 (1, lambda s, t: 4 * s + t)], _frag3, 0),
}


def _bytes(words):
    """uint32 words (held in uint64) -> their four int8 bytes, little end first."""
    return np.stack([((words >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                     for b in range(4)], -1).astype(np.int64)


# ---------------------------------------------------------------------------
# a8_gemv, a block at a time
# ---------------------------------------------------------------------------

def round_groups(x, plan, groups):
    """A block's rounding of ``groups``: rsx and the level sum of each (group, row), and
    the levels of each group's K-rows (zero past K), with the kernel's f32 operations."""
    M, K = x.shape
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    out = {}
    for j in groups:
        k0, k1 = j * plan.group, min((j + 1) * plan.group, K)
        v = np.zeros((M, plan.group), np.float32)
        v[:, :max(0, k1 - k0)] = xb[:, k0:k1]
        amax = np.maximum(np.abs(v).max(-1), np.float32(1e-30))
        r = (np.float32(127) / amax).astype(np.float32)
        lv = np.rint((v * r[:, None]).astype(np.float32)).astype(np.int64)
        out[j] = (r, lv.sum(-1), lv)
    return out


def emulate_a8_gemv(x, planes, scales, zeros, plan, decoder, zshift, steps=None):
    """``a8_gemv`` with one of `DECODERS` on x (M, K) f32 and the stored ``planes``
    (uint8 ``(rows, N)``; rows past a plane and columns past N read 0), in the launch of
    `a8_gemv_plan` (132 SMs, aligned bases) or with ``steps`` k32 steps a block."""
    gu, loads, gfrag, shift = DECODERS[decoder]
    M, K = x.shape
    N = planes[0].shape[1]
    group, n_act = plan.group, plan.n_act
    k_read = group * n_act
    S = -(-k_read // 32)
    gp = qm.a8_gemv_plan(M, k_read, N, n_act, group, 132, [0])
    steps = steps or gp.steps
    ksplit = -(-S // steps)
    assert 1 <= ksplit <= qm.GEMV_MAX_CLUSTER and (ksplit - 1) * steps < S
    tiles = -(-N // COLS)
    rows_of = [p.shape[0] for p in planes]
    # each plane zero-padded past its rows (the loads' guard) and past N
    need = max(max(r(S, 3) for _, r in loads) + 1, *rows_of)
    padded = [np.zeros((need, tiles * COLS), np.uint8) for _ in planes]
    for p, q in zip(padded, planes):
        p[:q.shape[0], :N] = q
    mt_n = 1 if M <= 8 else 2
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    out = np.zeros((M, N), np.float32)
    for tile in range(tiles):
        col0 = tile * COLS
        d_block = []  # per block: {group: int64 (M, COLS)}
        stats = {}
        for b in range(ksplit):
            sb0, sb1 = b * steps, min(S, (b + 1) * steps)
            jb0 = 32 * sb0 // group
            groups = range(jb0, (min(32 * sb1, k_read) - 1) // group + 1)
            rnd = round_groups(x, plan, groups)
            stats.update({j: rnd[j][:2] for j in groups})
            dl = {j: np.zeros((M, COLS), np.int64) for j in groups}
            xs = np.zeros((mt_n * 8, 32 * (sb1 - sb0)), np.int64)  # x̂ of the block's steps
            for k in range(32 * sb0, min(32 * sb1, k_read)):
                j = k // group
                xs[:M, k - 32 * sb0] = rnd[j][2][:, k - j * group]
            per = -(-(sb1 - sb0) // (WARPS * gu)) * gu
            for warp in range(WARPS):
                wb = min(sb1, sb0 + warp * per)
                we = min(sb1, wb + per)
                d = np.zeros((mt_n * 8, COLS), np.int64)
                cur = None
                for s in range(wb, we):
                    w = []
                    for plane, row in loads:
                        r = np.array([row(s, tt) for tt in range(4)])[t]
                        cols = col0 + 16 * g[:, None] + np.arange(16)[None, :]
                        w.append(np.ascontiguousarray(padded[plane][r[:, None], cols])
                                 .view("<u4").astype(np.uint64))
                    A = np.zeros((8, 16, 32), np.int64)
                    for j in range(8):
                        regs = gfrag(w, j)
                        for ri in range(4):
                            rows = g + 8 * (ri & 1)
                            kb = 4 * t + 16 * (ri >> 1)
                            for bb, v in enumerate(_bytes(regs[ri]).T):
                                A[j, rows, kb + bb] = v
                    kb, kend = 32 * s, min(32 * s + 32, k_read)
                    for j_grp in range(kb // group, (kend - 1) // group + 1):
                        if j_grp != cur:
                            if cur is not None:
                                dl[cur] += d[:M]
                            d[:] = 0
                            cur = j_grp
                        k0, k1 = j_grp * group, (j_grp + 1) * group
                        B = np.zeros((mt_n, 32, 8), np.int64)
                        for mt in range(mt_n):
                            for ln in range(32):
                                gg, tt = ln >> 2, ln & 3
                                xrow = xs[8 * mt + gg, 32 * (s - sb0) + 8 * tt:
                                          32 * (s - sb0) + 8 * tt + 8]
                                lo = np.array([(keep_bytes(kb + 8 * tt, k0, k1) >> (8 * i))
                                               & 0xFF != 0 for i in range(4)])
                                hi = np.array([(keep_bytes(kb + 8 * tt + 4, k0, k1)
                                                >> (8 * i)) & 0xFF != 0 for i in range(4)])
                                B[mt, 4 * tt:4 * tt + 4, gg] = xrow[:4] * lo
                                B[mt, 16 + 4 * tt:16 + 4 * tt + 4, gg] = xrow[4:] * hi
                        for j in range(8):
                            for mt in range(mt_n):
                                D = A[j] @ B[mt]  # (16 columns, 8 rows of x)
                                d[8 * mt:8 * mt + 8, 16 * np.arange(8) + 2 * j] += D[:8].T
                                d[8 * mt:8 * mt + 8, 16 * np.arange(8) + 2 * j + 1] += D[8:].T
                if cur is not None:
                    dl[cur] += d[:M]
            d_block.append(dl)
        # the cluster: every group's D over its blocks, then each element folds in order
        cols = col0 + np.arange(COLS)
        ok = cols < N
        acc = np.zeros((M, COLS), np.float32)
        for j in range(n_act):
            dsum = sum(dl[j] for dl in d_block if j in dl)
            assert (dsum % (1 << shift) == 0).all()
            r, sx = stats[j]
            sr = j // plan.rep
            sc = np.where(ok, scales[sr, np.minimum(cols, N - 1)], 0).astype(np.float32)
            zc = np.where(ok, zeros[sr, np.minimum(cols, N - 1)] - np.float32(zshift),
                          0).astype(np.float32)
            part = ((dsum >> shift).astype(np.float32) - sx[:, None].astype(np.float32) * zc
                    ).astype(np.float32) * (sc[None, :] / r[:, None]).astype(np.float32)
            acc = (acc + part.astype(np.float32)).astype(np.float32)
        hi = min(N, col0 + COLS) - col0
        out[:, col0:col0 + hi] = acc[:, :hi]
    return out


# ---------------------------------------------------------------------------
# Cases: the decoder, its pack, its plan and plain version
# ---------------------------------------------------------------------------

def make_case(decoder, K, N, groupsize, M, seed=0):
    """Random packs of ``decoder`` (random bytes over every stored row, scales about
    0.01, random zero levels), x, the `A8Plan` at M rows, the plain version's output and
    the emulation's arguments."""
    rng = np.random.default_rng(seed + K + N + M)
    bits = {"int8": 8, "uint8": 8, "int4": 4, "int2": 2, "int3": 3}[decoder]
    Kp = sub4_pad_rows(K, groupsize) if bits in (2, 3) else K
    G = 1 if groupsize < 0 else (Kp // groupsize if bits in (2, 3) else -(-K // groupsize))
    scales = (rng.random((G, N)) * 0.01 + 0.005).astype(np.float32)
    zeros = rng.integers(0, 2 ** bits, (G, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    rows = {8: K, 4: K // 2, 2: Kp // 4, 3: Kp // 4}[bits]
    planes = [rng.integers(0, 256, (rows, N), dtype=np.uint8)]
    if bits == 3:
        planes.append(rng.integers(0, 256, (Kp // 8, N), dtype=np.uint8))
    t = torch.from_numpy
    if decoder == "int8":
        zeros[:] = 0
        q = t(planes[0].view(np.int8))
        plan = qm.w8a8_plan(K, G, M)
        want = qm.quant_matmul_int8_w8a8_ref(t(x), q, t(scales), t(zeros), torch.float32)
        zshift = 0.0
    elif decoder == "uint8":
        plan = qm.w8a8_plan(K, G, M)
        want = qm.quant_matmul_int8_w8a8_ref(t(x), t(planes[0]), t(scales), t(zeros),
                                             torch.float32)
        zshift = 128.0
    elif decoder == "int4":
        plan = qm.w4a8_plan(K // 2, G, M)
        want = qm.quant_matmul_int4_w4a8_ref(t(x), t(planes[0]), t(scales), t(zeros),
                                             torch.float32)
        zshift = 8.0
    elif decoder == "int2":
        plan = qs.sub4_a8_plan(K, Kp, G, M, 2)
        want = qs.quant_matmul_int2_a8_ref(t(x), t(planes[0]), t(scales), t(zeros),
                                           torch.float32)
        zshift = 0.0
    else:
        plan = qs.sub4_a8_plan(K, Kp, G, M, 3)
        want = qs.quant_matmul_int3_a8_ref(t(x), t(planes[0]), t(planes[1]), t(scales),
                                           t(zeros), torch.float32)
        zshift = 0.0
    return x, planes, scales, zeros, plan, want.numpy(), zshift


# (decoder, K, N, groupsize): whole columns and groups with a column tail (N = 160, 150),
# the 125M's K = 780 in 64-row groups (activation groups of 60 K-rows for int4, int8 and
# uint8; 64 over a pack padded to 832 stored rows for int2 and int3)
CASES = [("int4", 256, 160, -1), ("int4", 256, 150, 128), ("int4", 780, 40, 64),
         ("int8", 512, 160, -1), ("uint8", 512, 150, 128), ("uint8", 780, 40, 64),
         ("int2", 1024, 160, -1), ("int2", 780, 40, 64),
         ("int3", 1024, 150, -1), ("int3", 780, 40, 64)]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("decoder,K,N,groupsize", CASES)
def test_emulation_matches_the_plain_version(decoder, K, N, groupsize, M):
    x, planes, scales, zeros, plan, want, zshift = make_case(decoder, K, N, groupsize, M)
    got = emulate_a8_gemv(x, planes, scales, zeros, plan, decoder, zshift)
    assert np.isfinite(got).all()
    assert check_a8_rows(got, want, x, plan, (decoder, K, N, groupsize, M)) == []


@pytest.mark.parametrize("decoder,K,N,groupsize", [CASES[2], CASES[3], CASES[5], CASES[7],
                                                     CASES[9]])
def test_two_split_plans_give_equal_bits(decoder, K, N, groupsize):
    """The split runs over k32 steps and the cluster folds each group once in group
    order, so the bits do not depend on the plan: the plan's split against one block
    and against blocks of one step (ragged groups straddle the blocks)."""
    M = 5
    x, planes, scales, zeros, plan, _, zshift = make_case(decoder, K, N, groupsize, M)
    S = -(-plan.k_read // 32)
    base = emulate_a8_gemv(x, planes, scales, zeros, plan, decoder, zshift)
    for steps in {S, -(-S // qm.GEMV_MAX_CLUSTER)}:
        other = emulate_a8_gemv(x, planes, scales, zeros, plan, decoder, zshift, steps)
        assert np.array_equal(base.view(np.uint32), other.view(np.uint32)), steps


# ---------------------------------------------------------------------------
# a8_gemv_plan
# ---------------------------------------------------------------------------

def _views():
    """(name, K, N, G, Kp, bits) of every linear of the 7B, the 125M and the 65B, whole
    and as tp-2 shards (columns halved; rows halved, the sub-4-bit packs' stored rows
    with them), whole-column and in the groups their formats use (7B and 65B: 128 rows,
    sub-4-bit 64; 125M: 64)."""
    shapes = {"7B": [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096),
                     (4096, 32000)],
              "125M": [(780, 2340), (780, 780), (780, 2304), (2304, 780), (780, 35008)],
              "65B": [(8192, 24576), (8192, 8192), (8192, 22016), (22016, 8192)]}
    for model, sh in shapes.items():
        gs = 64 if model == "125M" else 128
        for K, N in sh:
            for bits in (4, 8, 2, 3):
                for groupsize in (-1, 64 if bits in (2, 3) else gs):
                    Kp = sub4_pad_rows(K, groupsize) if bits in (2, 3) else K
                    G = 1 if groupsize < 0 else (Kp // groupsize if bits in (2, 3)
                                                 else -(-K // groupsize))
                    yield model, K, N, G, Kp, bits
                    yield model + " tp2 cols", K, N // 2, G, Kp, bits
                    if K % 4 == 0 and (G == 1 or G % 2 == 0):
                        yield (model + " tp2 rows", K // 2, N, max(1, G // 2),
                               Kp // 2 if bits in (2, 3) else K // 2, bits)


def _a8_plan(K, G, Kp, bits, M):
    if bits == 4:
        return qm.w4a8_plan(K // 2, G, M)
    if bits == 8:
        return qm.w8a8_plan(K, G, M)
    return qs.sub4_a8_plan(K, Kp, G, M, bits)


def test_every_view_the_route_above_takes_is_planned():
    """Every view of the 7B and the 125M (tp-2 shards too) whose A8 plan exists and that
    `a8_launch_plan` accepts at M <= 16 has a decode plan, with 16-byte loads where N and
    the bases allow, 4-byte or byte loads elsewhere, every k32 step in one block, at most
    8 blocks a cluster and room in shared memory; so has every 65B view at M <= 8."""
    seen = 0
    for model, K, N, G, Kp, bits in _views():
        for M in (1, 8, 9, 16):
            try:
                plan = _a8_plan(K, G, Kp, bits, M)
            except ValueError:
                continue  # the JAX kernel cannot run it either (K3 at K = 780 and 390)
            qm.a8_launch_plan(M, plan.k_read, N, plan.n_act, 132, [0])
            for ptr in (0, 4, 1):
                gp = qm.a8_gemv_plan(M, plan.k_read, N, plan.n_act, plan.group, 132, [ptr])
                if gp is None:  # no room: the route above 16 rows takes it
                    assert model.startswith("65B") and M > 8, (model, K, N, G, bits, M)
                    continue
                want_lw = next(w for w in (16, 4, 1) if N % w == 0 and ptr % w == 0)
                assert gp.lw == want_lw and gp.vec == (want_lw == 16), (model, K, N, ptr)
                S = -(-plan.k_read // 32)
                assert 1 <= gp.ksplit <= 8
                assert (gp.ksplit - 1) * gp.steps < S <= gp.ksplit * gp.steps
                assert gp.smem == qm.a8_gemv_smem(M, gp.steps, plan.group, plan.n_act, gp.ksplit)
                assert gp.smem <= qm.A8_SMEM_MAX, (model, K, N, G, bits, M)
                seen += 1
    assert seen > 1000


@pytest.mark.parametrize("M,k_read,N,n_act,group", [
    (1, 4096, 4096, 4, 1024), (16, 11008, 4096, 86, 128), (5, 780, 2340, 13, 60),
    (1, 832, 35008, 13, 64), (9, 5632, 4096, 22, 256), (1, 64, 8, 1, 64), (3, 128, 37, 2, 64)])
def test_every_k32_step_falls_in_one_block(M, k_read, N, n_act, group):
    gp = qm.a8_gemv_plan(M, k_read, N, n_act, group, 132, [0])
    S = -(-k_read // 32)
    owners = [b for b in range(gp.ksplit) for _ in range(b * gp.steps,
                                                          min(S, (b + 1) * gp.steps))]
    assert len(owners) == S and all(
        b * gp.steps <= s < (b + 1) * gp.steps for s, b in enumerate(owners))
    assert 1 <= gp.ksplit <= qm.GEMV_MAX_CLUSTER
    assert gp.cols == COLS and gp.warps == WARPS


def test_plan_is_memoized_on_pointer_residues():
    a = qm.a8_gemv_plan(1, 4096, 4096, 16, 256, 132, [1 << 20])
    b = qm.a8_gemv_plan(1, 4096, 4096, 16, 256, 132, [(1 << 21) + 32])
    assert a is b and a.lw == 16
    c = qm.a8_gemv_plan(1, 4096, 4096, 16, 256, 132, [(1 << 20) + 4])
    assert c is not a and c.lw == 4


@pytest.mark.parametrize("M,group", [(17, 256), (0, 256), (1, qm.A8_MAX_GROUP + 8)])
def test_plan_refuses_what_the_kernel_cannot_take(M, group):
    with pytest.raises(ValueError):
        qm.a8_gemv_plan(M, 4 * group, 4096, 4, group, 132, [0])


def test_a_block_without_room_leaves_the_view_to_the_route_above():
    """A 65B sub-4-bit pack in 64-row groups at 16 rows: 44 groups a block at 8 splits,
    8 KB of int32 sums each, more than a block's shared memory."""
    assert qm.a8_gemv_plan(16, 22528, 8192, 352, 64, 132, [0]) is None
    assert qm.a8_gemv_plan(8, 22528, 8192, 352, 64, 132, [0]) is not None
