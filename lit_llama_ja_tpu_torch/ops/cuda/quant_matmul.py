"""Int4 and int8 dequant-matmuls: the wrappers of ``csrc/quant_matmul_int4.cu`` (K1) and
``csrc/quant_matmul_int8.cu`` (K3) and their plain PyTorch versions.

* `quant_matmul_int4` replaces the Pallas kernel
  `lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325 quant_matmul_int4`.
* `quant_matmul_int8` replaces `quant_matmul_int8` (`:451`), for int8 (symmetric
  absmax, zeros 0) and uint8 (asymmetric levels) packs.

Each computes exactly ``x @ dequantize_with_k(params, K)``: the weight is
dequantized in f32 as ``(q - zero) * scale`` and the product accumulates in f32. Two
regimes sit behind each wrapper: a tensor-core GEMV for M <= 16 rows (decode,
``csrc/qmm_gemv.cuh``, planned by `gemv_plan`) and a tensor-core GEMM for larger M
(prefill, ``csrc/qmm_generic.cuh``, planned by `gemm_plan`), one of each for every
format. The helpers here are shared with the sub-4-bit wrappers
(`quant_matmul_sub4.py`).

`quant_matmul_int4` and `quant_matmul_int8` also take the JAX functions' ``unpack``
names. The exact ones (int4: None, ``"bf16"``, ``"bf16_u8"``, ``"f32dot"``, ``"arith"``,
``"arith_bf16"``; int8: None, ``"bf16"``) keep the routes above; the int8-operand names
compute the JAX kernels' A8 numerics: int4's four ``int8dot*`` names (`W4A8_MODES`)
through `quant_matmul_int4_w4a8` (``csrc/quant_matmul_w4a8.cu``), int8's ``"int8dot"``
through `quant_matmul_int8_w8a8` (``csrc/quant_matmul_a8.cu``), both on the A8 kernel of
``csrc/qmm_a8.cuh``: x rounded to int8 per (row, activation group), int8 x int8 products
summed in int32, folded into f32 a group at a time. The activation groups follow the JAX
tile plan at the caller's M (`w4a8_plan`, `w8a8_plan`): the JAX kernels take one
``block_k`` at M <= 64 and another above, so a row's result depends on how many rows
come with it, as on the TPU. There the JAX functions pick these modes by themselves
(int4 at M <= 64; llm.int8-dyn's bulk product at every M); here a caller asks for them,
and `quant/linear.quant_matmul` does not. Other names raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build

GEMV_MAX_M = 16
GEMM_BM = 128  # rows of x per block of the K1 and K3-K5 GEMM (csrc/qmm_generic.cuh)
# the K1 and K3-K5 GEMV (csrc/qmm_gemv.cuh)
_GEMV_COLS = 128  # output columns a block
GEMV_WARPS = 4  # warps a block, each over its share of the block's k16 steps
GEMV_MAX_CLUSTER = 8  # K splits of a column tile: the blocks of one portable cluster
GEMV_BLOCKS_PER_SM = 2  # the K split aims at this many blocks an SM
GEMV_MIN_WARP_STEPS = 2  # and gives each warp at least this many k16 steps
# K1's W4A8 modes (csrc/quant_matmul_w4a8.cu)
W4A8_MODES = ("int8dot_bias", "int8dot_bias_bc", "int8dot_fused", "int8dot")
EXACT_MODES = (None, "bf16", "bf16_u8", "f32dot", "arith", "arith_bf16")
# the A8 modes' plans follow the JAX kernels' default block_k (stored rows a k-tile):
# the first at M <= A8_DECODE_M rows, the second above
A8_DECODE_M = 64
W4A8_BLOCK_K = (512, 1024)  # int4 packed rows (quant_matmul.py:381-382)
W8A8_BLOCK_K = (256, 2048)  # int8 K-rows (quant_matmul.py:489-490)
# the A8 kernel (csrc/qmm_a8.cuh) above GEMV_MAX_M rows
A8_COLS = 32  # output columns a block (one warp)
A8_BLOCKS_PER_SM = 4  # the split over activation groups aims at this many blocks an SM
A8_MAX_SPLIT = 16
# its decode route (a8_gemv) at M <= GEMV_MAX_M: the GEMV's blocks and clusters
A8_MAX_GROUP = 1 << 17  # K-rows an activation group: 127 * 128 * 2^17 < 2^31, sums exact
A8_SMEM_MAX = 232448  # dynamic shared memory a block can have on an H100
A8_FOLD_FLOATS = 2048  # the fold's parts in shared memory, at least
A8_WIDE_BLOCKS_PER_SM = 1.5  # at M > 8 (two blocks an SM) the grid stays under this


def _dequant_matmul(x: torch.Tensor, params, bits=None) -> torch.Tensor:
    """Plain version of every dequant-matmul: dequantize the whole weight in f32,
    cast to ``x.dtype``, matmul."""
    from lit_llama_ja_tpu_torch.quant.linear import dequantize_with_k

    return x @ dequantize_with_k(params, x.shape[-1], dtype=x.dtype, bits=bits)


def quant_matmul_int4_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version of K1."""
    return _dequant_matmul(x, {"qweight": qweight, "scales": scales, "zeros": zeros})


def quant_matmul_int8_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3."""
    return _dequant_matmul(x, {"qweight": qweight, "scales": scales, "zeros": zeros})


def check_groups(scales: torch.Tensor, zeros: torch.Tensor, N: int, rows: int) -> int:
    """``scales``/``zeros`` must be ``(G, N)`` with ``1 <= G <= rows``; returns G."""
    G = scales.shape[0]
    if scales.shape != (G, N) or zeros.shape != (G, N) or not 1 <= G <= rows:
        raise ValueError(f"scales/zeros must be (G, {N}) with 1 <= G <= {rows}, got "
                         f"{tuple(scales.shape)} and {tuple(zeros.shape)}")
    return G


def weight_alignment(t: torch.Tensor, N: int) -> int:
    """The widest load, in bytes, that the kernels issue on a weight buffer with N
    columns: 16 on f32 scales and zeros when N % 4 == 0; 8 on packed rows when
    N % 8 == 0 (the GEMM), else 4 when N % 4 == 0 (the GEMV). So one layer's view of
    a stacked (L, ...) tree whose base is 16-byte aligned always qualifies."""
    if t.dtype == torch.float32:
        return 16 if N % 4 == 0 else 4
    return 8 if N % 8 == 0 else 4 if N % 4 == 0 else 1


def prepare_launch(name: str, x: torch.Tensor, N: int, out_dtype: torch.dtype | None = None,
                   **weights: torch.Tensor):
    """The checks every kernel makes on CUDA inputs, then ``(x2, out, lead)``: x as
    a contiguous 16-byte aligned ``(M, K)`` bf16 matrix and the ``(M, N)`` output in
    ``out_dtype`` (default x's).
    The kernels have no backward: an x that autograd tracks is refused, so that no
    gradient is cut silently."""
    dev = x.device
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"the {name} kernel has no backward: a step cannot train "
                           "through a quantized linear on the card")
    for wname, t in weights.items():
        if t.device != dev:
            raise ValueError(f"{wname} is on {t.device}, x on {dev}")
        align = weight_alignment(t, N)
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{wname} must be contiguous and {align}-byte aligned")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes bf16 activations, got {x.dtype}")
    if weights["scales"].dtype != torch.float32 or weights["zeros"].dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes f32 scales and zeros")
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    out = torch.empty((x2.shape[0], N), dtype=out_dtype or x.dtype, device=dev)
    return x2, out, x.shape[:-1]


def gemm_plan(M: int, K: int, N: int, n_sm: int, x_ptr: int, packed_ptrs, scale_ptrs):
    """Tile width and copy widths of the K1 and K3-K5 prefill GEMM (``qmm_generic.cuh``):
    ``(bn, xw, ww, sw)``.

    * ``bn``: 128 output columns a block, or 64 where 128-wide tiles would launch
      fewer blocks than half the card's SMs (N = 4096 at M = 128: 64 blocks, not 32).
      Measured on an H100 (``gemm_probe``): 128 is faster wherever 128-wide tiles give
      86 blocks or more (N = 4096 at M = 512: 128 blocks), 64 where they give 32.
    * ``xw``: bytes per copy of x, whose rows lie 2K bytes apart: 16, 8 or 4 as 2K and
      the base allow, or 2 for an odd K (plain loads in the kernel).
    * ``ww``: bytes per copy of the packed rows, N bytes apart: 16, 8 or 4 as N and
      every packed base allow, or 1 when N % 4 != 0 (byte loads).
    * ``sw``: 16 on f32 scales and zeros when N % 4 == 0 and both bases are 16-byte
      aligned, else 4.

    Every width falls back to a narrower one, so no view that `prepare_launch`
    accepts is refused."""
    tiles_128 = -(-N // 128) * -(-M // GEMM_BM)
    bn = 128 if 2 * tiles_128 >= n_sm else 64
    xw = next((w for w in (16, 8, 4) if (2 * K) % w == 0 and x_ptr % w == 0), 2)
    ww = next((w for w in (16, 8, 4)
               if N % w == 0 and all(p % w == 0 for p in packed_ptrs)), 1)
    sw = 16 if N % 4 == 0 and all(p % 16 == 0 for p in scale_ptrs) else 4
    return bn, xw, ww, sw


def launch_gemm_plan(dev: torch.device, x2: torch.Tensor, N: int, packed, scales, zeros):
    """`gemm_plan` for CUDA tensors on ``dev``."""
    M, K = x2.shape
    return gemm_plan(M, K, N, _build.sm_count(dev.index),
                     x2.data_ptr(), [t.data_ptr() for t in packed],
                     [scales.data_ptr(), zeros.data_ptr()])


class GemvPlan(NamedTuple):
    """Launch plan of the K1 and K3-K5 GEMV (`gemv_plan`)."""
    cols: int  # output columns a block
    ksplit: int  # K splits of a column tile = blocks of its cluster
    steps: int  # k16 steps a split
    fast: bool  # the fast route (gemv_fast), else the general one (gemv_general)
    lw: int  # bytes a load of the packed rows: 16, 8, 4 or 1
    xw: int  # bytes a copy of x into shared memory: 16 or 2
    sw: int  # bytes a load of the scales and zeros: 16 or 4
    warps: int  # warps a block
    straddle: bool  # some k16 step holds K-rows of two scale groups


def gemv_plan(M: int, K: int, N: int, G: int, n_sm: int, x_ptr: int, packed_ptr: int,
              scale_ptrs, bits: int, Kp: int | None = None, hi_ptr: int | None = None
              ) -> GemvPlan:
    """Launch plan of the K1 (``bits`` 4), K3 (8), K4 (2) and K5 (3) GEMV of
    ``csrc/qmm_gemv.cuh`` for ``x (M, K) @ W (K, N)`` with G scale groups, M <= 16. A
    sub-4-bit pack stores ``Kp >= K`` K-rows (default K) and K5 a second plane at
    ``hi_ptr``; the scale groups are ``ceil(Kp / G)`` K-rows.

    * ``ksplit``: the K splits of each 128-column tile, which form one thread-block
      cluster (at most 8, the portable size) and sum their partials through
      distributed shared memory. Aims at `GEMV_BLOCKS_PER_SM` blocks an SM (N = 4096:
      32 tiles, 8 splits), while each warp keeps at least `GEMV_MIN_WARP_STEPS` k16
      steps; on an H100 (``gemv_probe splits``) fewer, longer splits lost at N = 4096
      and more, shorter ones at N >= 11008.
    * ``fast``: the fast route, which loads 16 bytes a lane straight into registers, a
      batch of 4 (int2, int3, int4) or 2 (int8) k16 steps at a time, so a split is
      whole batches and a batch must not reach two scale groups: 16-byte loads, K % 16
      == 0 and one group or groups of a multiple of 64 K-rows. Every 7B view takes it,
      in whole columns and in 64- or 128-row groups.
    * ``lw``: 16-byte loads of the packed rows where N % 16 == 0 and every plane's base
      is 16-byte aligned, else the widest of 8, 4 and 1 that N and the bases allow (the
      general route's ``cp.async`` copies); ``xw``: 16-byte copies of x where K % 8 == 0
      and its base is aligned, else 2; ``sw``: 16 on scales and zeros where N % 4 == 0
      and both bases are aligned.
    * ``straddle``: scale groups that end inside a k16 step (ragged groups); the
      general route runs such a step once per group with x masked to the group's rows.

    Every width falls back to a narrower one, so no view that `prepare_launch`
    accepts is refused. Memoized on the pointers' residues modulo 16, so a call's host
    time is a dictionary lookup."""
    return _gemv_plan(M, K, N, G, n_sm, x_ptr % 16, packed_ptr % 16,
                      tuple(p % 16 for p in scale_ptrs), bits, K if Kp is None else Kp,
                      0 if hi_ptr is None else hi_ptr % 16)



@functools.lru_cache(maxsize=1024)
def _gemv_plan(M, K, N, G, n_sm, x_mod, packed_mod, scale_mods, bits, Kp, hi_mod) -> GemvPlan:
    if (not 1 <= M <= GEMV_MAX_M or bits not in (2, 3, 4, 8) or (bits == 4 and K % 2)
            or Kp < K or (bits >= 4 and Kp != K)):
        raise ValueError(f"no GEMV plan for M={M}, K={K}, Kp={Kp}, bits={bits}")
    steps_total = -(-K // 16)
    tiles = -(-N // _GEMV_COLS)
    ksplit = max(1, min(GEMV_MAX_CLUSTER, -(-GEMV_BLOCKS_PER_SM * n_sm // tiles),
                        steps_total // (GEMV_WARPS * GEMV_MIN_WARP_STEPS)))
    lw = next((w for w in (16, 8, 4)
               if N % w == 0 and packed_mod % w == 0 and hi_mod % w == 0), 1)
    xw = 16 if K % 8 == 0 and x_mod == 0 else 2
    sw = 16 if N % 4 == 0 and all(p == 0 for p in scale_mods) else 4
    gsz = -(-Kp // G)
    fast = (lw, xw, sw) == (16, 16, 16) and K % 16 == 0 and (G == 1 or gsz % 64 == 0)
    steps = -(-steps_total // ksplit)
    if fast:  # whole batches of loads: 4 k16 steps (int2, int3, int4) or 2 (int8)
        steps = -(-steps // 4) * 4
    ksplit = -(-steps_total // steps)
    return GemvPlan(_GEMV_COLS, ksplit, steps, fast, lw, xw, sw, GEMV_WARPS,
                    G > 1 and gsz % 16 != 0)


def gemv_launch_args(x2, N, G, bits, qweight, scales, zeros, Kp=None, qweight_hi=None):
    """The plan's arguments of a GEMV launch on CUDA tensors, as every GEMV entry point
    takes them last: ``(ksplit, steps, fast, lw, xw, sw, stream)``."""
    M, K = x2.shape
    dev = x2.device
    plan = gemv_plan(M, K, N, G, _build.sm_count(dev.index), x2.data_ptr(),
                     qweight.data_ptr(), [scales.data_ptr(), zeros.data_ptr()], bits, Kp,
                     None if qweight_hi is None else qweight_hi.data_ptr())
    return (plan.ksplit, plan.steps, int(plan.fast), plan.lw, plan.xw, plan.sw,
            torch.cuda.current_stream(dev).cuda_stream)


def _check4(x, qweight, scales, zeros):
    K = x.shape[-1]
    if qweight.dim() != 2 or qweight.dtype != torch.uint8:
        raise ValueError(f"qweight must be a 2-D uint8 (K/2, N) pack, got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    Kh, N = qweight.shape
    if 2 * Kh != K:
        raise ValueError(f"x has K={K} but qweight packs {2 * Kh} rows")
    return K, N, check_groups(scales, zeros, N, K)


def quant_matmul_int4(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    unpack: str | None = None,
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (K/2, N) uint8, scales/zeros (G, N) f32)``,
    returned in ``x.dtype``.

    ``unpack``: the JAX function's names. None and the exact names compute exactly
    ``x @ dequantize_with_k`` (below); the `W4A8_MODES` compute the W4A8 product of
    `quant_matmul_int4_w4a8`, over the activation groups of `w4a8_plan` at x's row
    count; any other name raises.

    CPU tensors run `quant_matmul_int4_ref`. CUDA tensors launch the kernel, which
    takes bf16 ``x`` and contiguous f32 ``scales``/``zeros`` on the same device;
    anything else raises.
    """
    if unpack in W4A8_MODES:
        return quant_matmul_int4_w4a8(x, qweight, scales, zeros)
    if unpack not in EXACT_MODES:
        raise ValueError(f"unknown unpack {unpack!r}: one of {EXACT_MODES + W4A8_MODES}")
    K, N, G = _check4(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int4_ref(x, qweight, scales, zeros)
    x2, out, lead = prepare_launch("int4", x, N, qweight=qweight, scales=scales, zeros=zeros)
    M = x2.shape[0]
    if M == 0:
        return out.reshape(*lead, N)
    dev = x.device
    lib = _build.load("quant_matmul_int4", _bind4)
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            status = lib.lljt_qmm4_gemv(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, N, G,
                *gemv_launch_args(x2, N, G, 4, qweight, scales, zeros),
            )
        else:
            plan = launch_gemm_plan(dev, x2, N, [qweight], scales, zeros)
            status = lib.lljt_qmm4_gemm(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), M, K, N, G, *plan,
                torch.cuda.current_stream(dev).cuda_stream,
            )
    quant_matmul_int4.launches += 1
    _build.check(lib, status, "quant_matmul_int4")
    return out.reshape(*lead, N)


quant_matmul_int4.launches = 0


def plan_tiles(Kq: int, n_groups: int, block_k: int):
    """The JAX kernels' k-tile plan (``_plan_tiles`` of
    `lit_llama_ja_tpu/ops/pallas/quant_matmul.py`, copied): a packed-K tile size such that
    every tile spans whole scale groups or sits inside one. Returns
    ``(bk, groups_per_tile)``."""
    gsize = Kq // n_groups  # packed rows per group
    if gsize >= block_k:
        bk = block_k
        while gsize % bk != 0:
            bk //= 2
        return max(bk, 8), 1
    m = max(block_k // gsize, 1)
    while Kq % (m * gsize) != 0 and m > 1:
        m -= 1
    return m * gsize, m


class A8Plan(NamedTuple):
    """The activation groups of an A8 mode (W4A8, W8A8, W2A8, W3A8), from the JAX
    kernel's tile plan: x is rounded to int8 per (row, activation group), and the groups
    are the tiles' group slices in K order."""
    group: int  # K elements an activation group
    n_act: int  # activation groups: they cover K elements [0, n_act * group)
    rep: int  # activation groups a scale row: group j reads scale row j // rep

    @property
    def k_read(self) -> int:
        """K elements the groups cover: K, or more over a sub-4-bit pack's pad rows."""
        return self.n_act * self.group


def jax_block_k(blocks, M: int) -> int:
    """A JAX kernel's default ``block_k``: ``blocks[0]`` at M <= `A8_DECODE_M` rows (its
    decode tiling), ``blocks[1]`` above."""
    return blocks[M > A8_DECODE_M]


def a8_groups(rows: int, G: int, bk: int, gpt: int, per_row: int, what: str) -> A8Plan:
    """`A8Plan` of ``rows`` stored rows (``per_row`` K elements a row) in G scale groups,
    cut as the JAX kernel cuts them into tiles of ``bk`` rows of ``gpt`` group slices,
    with the JAX wrappers' scale repeat ``n_k // G`` where tiles split a group. Raises
    where the JAX kernel leaves rows unread or would read scale rows past G."""
    n_k = rows // bk
    n_act = n_k * gpt
    rep = 1 if n_act == G else n_k // G
    if rows % bk or G * rep != n_act:
        raise ValueError(f"the {what} plan of {rows} rows in {G} scale groups does not "
                         f"cover them (tiles of {bk} rows, {gpt} groups a tile)")
    return A8Plan(per_row * (bk // gpt), n_act, rep)


@functools.lru_cache(maxsize=256)
def w4a8_plan(Kq: int, G: int, M: int) -> A8Plan:
    """`A8Plan` of K1's W4A8 modes over a ``(Kq, N)`` int4 pack with G scale rows and M
    rows of x, as the JAX function lays it out: its tiles of ``bk`` packed rows
    (``block_k`` 512 at M <= 64, 1024 above), ``groups_per_tile`` slices a tile, and the
    scale rows repeated ``n_k // G`` times where tiles split a group. That holds the JAX
    kernel's ragged-group rule (ROADMAP queue 3): K = 780 in groups of 64 (13 scale rows)
    gives slices of 60 K elements, each with one scale row. Plans the JAX kernel cannot
    run (tiles that do not cover K, scale rows it would read past) raise."""
    bk, gpt = plan_tiles(Kq, G, jax_block_k(W4A8_BLOCK_K, M))
    return a8_groups(Kq, G, bk, gpt, 2, "W4A8")


@functools.lru_cache(maxsize=256)
def w8a8_plan(K: int, G: int, M: int) -> A8Plan:
    """`A8Plan` of K3's W8A8 mode over a ``(K, N)`` int8 pack with G scale rows and M rows
    of x: `plan_tiles` over K rows at ``block_k`` 256 (M <= 64) or 2048, the scale repeat
    ``n_k // G``. Raises where the JAX kernel's tiles do not cover K: at M <= 64, K = 780
    whole-column gives tiles of 8 rows, and its 97 tiles leave K-rows 776-779 unread
    (ROADMAP queue 3); the tp-2 shard's K = 390 alike."""
    bk, gpt = plan_tiles(K, G, jax_block_k(W8A8_BLOCK_K, M))
    return a8_groups(K, G, bk, gpt, 1, "W8A8")


def a8_quantize_ref(x2: torch.Tensor, plan: A8Plan):
    """x ``(M, K)`` rounded as the JAX kernels do: cast to bf16, zero past K up to
    ``plan.k_read``, then per (row, activation group) ``rsx = 127 / max(amax, 1e-30)`` and
    ``round_half_even(x * rsx)``, all in f32. Returns the levels ``(M, n_act, group)``
    (f32 integers) and ``rsx`` ``(M, n_act, 1)``."""
    M, K = x2.shape
    xb = x2.to(torch.bfloat16).float()
    if plan.k_read != K:
        xb = torch.nn.functional.pad(xb, (0, plan.k_read - K))
    xg = xb.reshape(M, plan.n_act, plan.group)
    amax = torch.clamp(xg.abs().amax(dim=-1, keepdim=True), min=1e-30)
    # a tensor divided by a tensor: ``127.0 / amax`` would be ``reciprocal(amax) * 127``,
    # one rounding more than the IEEE division of the JAX kernel
    rsx = torch.full_like(amax, 127.0) / amax
    return torch.round(xg * rsx), rsx


def a8_fold_ref(x: torch.Tensor, levels: torch.Tensor, scales: torch.Tensor,
                zeros: torch.Tensor, plan: A8Plan, zshift: float = 0.0,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The A8 epilogue shared by the plain versions: with x̂ from `a8_quantize_ref` and
    the f32 integer ``levels`` ``(k_read, N)`` (stored minus ``zshift``), the exact sums
    ``D = Σ x̂ levels`` a group (in f64, rounded once to f32 as the kernels' int32 sums
    are), the level sums ``sx``, then per group in f32 ``(D - sx (z - zshift)) * (s /
    rsx)``, summed over the groups."""
    K, N = x.shape[-1], levels.shape[-1]
    xq, rsx = a8_quantize_ref(x.reshape(-1, K), plan)
    w = levels.double().reshape(plan.n_act, plan.group, N)
    d = torch.einsum("mjr,jrn->mjn", xq.double(), w).float()
    sx = xq.sum(-1, keepdim=True)
    rows = torch.arange(plan.n_act, device=x.device) // plan.rep
    s, z = scales.float()[rows], zeros.float()[rows]
    part = (d - sx * (z - zshift)) * (s / rsx)
    y = part.sum(dim=1)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


def quant_matmul_int4_w4a8_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of K1's W4A8 modes, step by step as the JAX kernel's
    ``int8dot_bias`` epilogue: with x̂ from `a8_quantize_ref`, the even and odd
    K-rows' int sums ``D_e = Σ x̂_e q_lo`` and ``D_o = Σ x̂_o 16 (q_hi - 8)`` (exact, in
    f64), the row sums ``sxe``/``sxo``, then per group in f32
    ``(D_e + D_o/16 - (sxe + sxo) z + 8 sxo) * (s / rsx)``, summed over the groups."""
    K, N, G = _check4(x, qweight, scales, zeros)
    x2 = x.reshape(-1, K)
    plan = w4a8_plan(K // 2, G, x2.shape[0])
    xq, rsx = a8_quantize_ref(x2, plan)
    xe, xo = xq[..., 0::2], xq[..., 1::2]
    sxe, sxo = xe.sum(-1, keepdim=True), xo.sum(-1, keepdim=True)
    half = plan.group // 2
    lo = (qweight & 0x0F).double().reshape(plan.n_act, half, N)
    hi = (qweight & 0xF0).view(torch.int8).double().reshape(plan.n_act, half, N)
    d_e = torch.einsum("mjr,jrn->mjn", xe.double(), lo).float()
    d_o = torch.einsum("mjr,jrn->mjn", xo.double(), hi).float()
    rows = torch.arange(plan.n_act, device=x.device) // plan.rep
    s, z = scales.float()[rows], zeros.float()[rows]
    part = (d_e + d_o * 0.0625 - (sxe + sxo) * z + 8.0 * sxo) * (s / rsx)
    y = part.sum(dim=1)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


class A8Launch(NamedTuple):
    """Launch plan of the A8 kernel (`a8_launch_plan`)."""
    mt: int  # 16-row tiles of x̂ a block
    ksplit: int  # splits of the activation groups, merged in order by a second pass
    Mpad: int  # rows of x̂ (M rounded up to 16 * mt)
    Kpad: int  # bytes a row of x̂ (the groups' K elements rounded up to 32)
    vec: bool  # 16-byte loads of the stored rows (N % 16 == 0, aligned bases)


def a8_launch_plan(M: int, k_read: int, N: int, n_act: int, n_sm: int, packed_ptrs
                   ) -> A8Launch:
    """Up to 4 row tiles of 16 a block (M <= 64 in one); the activation groups split
    over ``ksplit`` blocks of a column tile so that the grid aims at
    `A8_BLOCKS_PER_SM` blocks an SM (at most one split a group, `A8_MAX_SPLIT`)."""
    mt = min(4, max(1, -(-M // 16)))
    Mpad = -(-M // (16 * mt)) * 16 * mt
    blocks = -(-N // A8_COLS) * (Mpad // (16 * mt))
    ksplit = max(1, min(n_act, A8_MAX_SPLIT, -(-A8_BLOCKS_PER_SM * n_sm // blocks)))
    return A8Launch(mt, ksplit, Mpad, -(-k_read // 32) * 32,
                    N % 16 == 0 and all(p % 16 == 0 for p in packed_ptrs))


class A8GemvPlan(NamedTuple):
    """Launch plan of the A8 kernel's decode route (`a8_gemv_plan`)."""
    cols: int  # output columns a block
    ksplit: int  # K splits of a column tile = blocks of its cluster
    steps: int  # k32 steps a split: block r takes steps [r steps, (r + 1) steps)
    lw: int  # bytes a load of the stored rows: 16, 4 or 1
    warps: int  # warps a block, each over its share of the block's steps
    smem: int  # dynamic shared memory a block (`a8_gemv_smem`)

    @property
    def vec(self) -> bool:
        """16-byte loads of the stored rows straight into registers."""
        return self.lw == 16


def a8_gemv_smem(M: int, steps: int, group: int, n_act: int, ksplit: int) -> int:
    """Bytes of shared memory a block of ``a8_gemv`` takes (``a8::GemvSmem`` of
    csrc/qmm_a8.cuh): for each activation group that a block's steps reach, the int32
    sums D of 8 or 16 rows (M <= 8 or more) by 128 columns, rsx and the level sums of its
    M rows; then one region for x̂ of the block's steps (M rows of ``32 steps`` bytes
    rounded up to 128, + 32) that the fold reuses for its tables, sums and parts."""
    ng = min(n_act, (32 * steps + group - 2) // group + 1)
    slot = (8 if M <= 8 else 16) * _GEMV_COLS
    xs = -(-32 * steps // 128) * 128 + 32
    tables = GEMV_MAX_CLUSTER + (2 * M + 1) * n_act
    share = -(-M * _GEMV_COLS // ksplit)
    return ng * (4 * slot + 8 * M) + max(M * xs, 4 * (tables + share + A8_FOLD_FLOATS))


def a8_gemv_plan(M: int, k_read: int, N: int, n_act: int, group: int, n_sm: int,
                 packed_ptrs) -> A8GemvPlan | None:
    """Launch plan of the A8 kernel's decode route (``a8_gemv`` of csrc/qmm_a8.cuh) for
    M <= 16 rows of x over ``n_act`` activation groups of ``group`` K-rows (``k_read``
    in all) and N columns, as the exact GEMV's `gemv_plan` lays out its blocks:

    * 128 output columns a block of 4 warps.
    * ``ksplit``: the K splits of a column tile, the blocks of one cluster (at most 8),
      aiming at `GEMV_BLOCKS_PER_SM` blocks an SM at M <= 8 (where three blocks fit an
      SM), and at M > 8 at no more than `A8_WIDE_BLOCKS_PER_SM` (two fit: more would
      start a second wave, clusters of 8 leaving slots unfilled), with at least one k32
      step a warp; raised until a block's shared memory (`a8_gemv_smem`: the int32 sums
      of every group its steps reach) fits twice on an SM. The split runs over k32
      steps, not over groups: a group's int32 sum is exact in any order, and the cluster
      folds each group once in group order, so the plan does not change the bits.
    * ``steps``: k32 steps a block, so that every step below ``ceil(k_read / 32)`` falls
      in exactly one block.
    * ``lw``: 16-byte loads where N % 16 == 0 and every plane's base is 16-byte aligned,
      else 4-byte ones (N % 4 == 0, aligned bases) or byte loads: no view that
      `prepare_launch` accepts is refused.

    Groups of more than `A8_MAX_GROUP` K-rows (whose int32 sums could overflow) raise.
    None where a block would need more than `A8_SMEM_MAX` bytes of shared memory even
    at 8 splits (a 65B's packs in 64- or 128-row groups at M > 8): `a8_launch` takes the
    route above 16 rows there. Memoized on the pointers' residues modulo 16."""
    return _a8_gemv_plan(M, k_read, N, n_act, group, n_sm,
                         tuple(p % 16 for p in packed_ptrs))


@functools.lru_cache(maxsize=1024)
def _a8_gemv_plan(M, k_read, N, n_act, group, n_sm, packed_mods) -> A8GemvPlan | None:
    if (not 1 <= M <= GEMV_MAX_M or not 1 <= group <= A8_MAX_GROUP or N < 1
            or group * n_act != k_read):
        raise ValueError(f"no A8 decode plan for M={M}, {n_act} groups of {group}, N={N}")
    S = -(-k_read // 32)
    tiles = -(-N // _GEMV_COLS)
    aim = (-(-GEMV_BLOCKS_PER_SM * n_sm // tiles) if M <= 8
           else int(A8_WIDE_BLOCKS_PER_SM * n_sm) // tiles)
    want = max(1, min(GEMV_MAX_CLUSTER, aim, S // GEMV_WARPS))
    while True:
        steps = -(-S // want)
        ksplit = -(-S // steps)
        smem = a8_gemv_smem(M, steps, group, n_act, ksplit)
        if smem <= A8_SMEM_MAX // 2 or want >= min(GEMV_MAX_CLUSTER, S):
            break
        want += 1
    if smem > A8_SMEM_MAX:
        return None
    lw = next((w for w in (16, 4) if N % w == 0 and all(p % w == 0 for p in packed_mods)), 1)
    return A8GemvPlan(_GEMV_COLS, ksplit, steps, lw, GEMV_WARPS, smem)


def a8_prepare(name: str, x: torch.Tensor, N: int, out_dtype, **weights):
    """`prepare_launch` for an A8 kernel, with its output in ``out_dtype`` (bf16 or
    f32; default ``x.dtype``), allocated once."""
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the {name} kernel writes bf16 or f32, not {out_dtype}")
    return prepare_launch(name, x, N, out_dtype, **weights)


def a8_launch(lib: ctypes.CDLL, entry: str, x2: torch.Tensor, weights, scales: torch.Tensor,
              zeros: torch.Tensor, out: torch.Tensor, plan: A8Plan, dims, tail=(),
              levels: bool = False):
    """One launch of an A8 entry point on CUDA tensors that its wrapper has checked
    (``x2`` (M, K) bf16 with M >= 1, ``out`` (M, N) bf16 or f32), a weight None passing
    a null pointer.

    At M <= `GEMV_MAX_M` the decode route, ``entry + "_gemv"(x, *weights, scales, zeros,
    out, levels, *dims, group, n_act, rep, ksplit, steps, lw, out_f32, *tail, stream)``
    with `a8_gemv_plan`: one kernel, and nothing allocated here but, with ``levels``,
    the buffer through which the blocks of column tile 0 write their rounding. Above,
    and where `a8_gemv_plan` finds no room, ``entry(x, *weights, scales, zeros, out, xq,
    rsx, sx, ws, *dims, group, n_act, rep, mt, ksplit, out_f32, vec, *tail, stream)``
    with `a8_launch_plan` and its scratch.

    Returns the rounding, ``{"xq", "rsx", "sx"}``: the int8 levels (M or Mpad rows, the
    groups' K-rows rounded up to 32), rsx and the level sums (M or Mpad, n_act), which a
    check may hold to the plain version's; None on the decode route without
    ``levels``."""
    M = x2.shape[0]
    N = out.shape[-1]
    dev = x2.device
    packed = [w for w in weights if w is not None]
    ptrs = [w.data_ptr() for w in packed]
    stream = torch.cuda.current_stream(dev).cuda_stream
    gp = (a8_gemv_plan(M, plan.k_read, N, plan.n_act, plan.group, _build.sm_count(dev.index),
                       ptrs) if M <= GEMV_MAX_M else None)
    if gp is not None:
        kpad = -(-plan.k_read // 32) * 32
        buf = (torch.empty(M * kpad + 8 * M * plan.n_act, dtype=torch.uint8, device=dev)
               if levels else None)
        with torch.cuda.device(dev):
            status = getattr(lib, entry + "_gemv")(
                x2.data_ptr(), *(None if w is None else w.data_ptr() for w in weights),
                scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
                None if buf is None else buf.data_ptr(), *dims, plan.group, plan.n_act,
                plan.rep, gp.ksplit, gp.steps, gp.lw, int(out.dtype == torch.float32), *tail,
                stream,
            )
        _build.check(lib, status, entry + "_gemv")
        if buf is None:
            return None
        stats = buf[M * kpad:].view(2, M, plan.n_act, 4)
        return {"xq": buf[:M * kpad].view(torch.int8).view(M, kpad),
                "rsx": stats[0].contiguous().view(torch.float32).view(M, plan.n_act),
                "sx": stats[1].contiguous().view(torch.int32).view(M, plan.n_act)}
    lp = a8_launch_plan(M, plan.k_read, N, plan.n_act, _build.sm_count(dev.index), ptrs)
    xq = torch.empty((lp.Mpad, lp.Kpad), dtype=torch.int8, device=dev)
    rsx = torch.empty((lp.Mpad, plan.n_act), dtype=torch.float32, device=dev)
    sx = torch.empty((lp.Mpad, plan.n_act), dtype=torch.int32, device=dev)
    ws = (torch.empty((lp.ksplit, lp.Mpad, N), dtype=torch.float32, device=dev)
          if lp.ksplit > 1 else None)
    with torch.cuda.device(dev):
        status = getattr(lib, entry)(
            x2.data_ptr(), *(None if w is None else w.data_ptr() for w in weights),
            scales.data_ptr(), zeros.data_ptr(), out.data_ptr(), xq.data_ptr(),
            rsx.data_ptr(), sx.data_ptr(), None if ws is None else ws.data_ptr(), *dims,
            plan.group, plan.n_act, plan.rep, lp.mt, lp.ksplit,
            int(out.dtype == torch.float32), int(lp.vec), *tail, stream,
        )
    _build.check(lib, status, entry)
    return {"xq": xq, "rsx": rsx, "sx": sx}


def quant_matmul_int4_w4a8(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K1's W4A8 modes: ``Σ x̂ (q - z) s`` with x̂ the int8-rounded activation of
    `quant_matmul_int4_w4a8_ref`, returned in ``out_dtype`` (bf16 or f32 on CUDA;
    default ``x.dtype``).

    CPU tensors run the plain version. CUDA tensors launch the kernel of
    ``csrc/quant_matmul_w4a8.cu`` (bf16 x, contiguous f32 scales and zeros on x's
    device) or raise; it never falls back to the exact kernel."""
    K, N, G = _check4(x, qweight, scales, zeros)
    plan = w4a8_plan(K // 2, G, x.numel() // K)
    if not x.is_cuda:
        return quant_matmul_int4_w4a8_ref(x, qweight, scales, zeros, out_dtype)
    x2, out, lead = a8_prepare("int4 W4A8", x, N, out_dtype, qweight=qweight, scales=scales,
                               zeros=zeros)
    if x2.shape[0] == 0:
        return out.reshape(*lead, N)
    w4a8_launch(x2, qweight, scales, zeros, out, plan)
    quant_matmul_int4_w4a8.launches += 1
    return out.reshape(*lead, N)


def w4a8_launch(x2: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                zeros: torch.Tensor, out: torch.Tensor, plan: A8Plan, levels: bool = False):
    """`a8_launch` of the W4A8 kernel; returns its rounding (see there)."""
    lib = _build.load("quant_matmul_w4a8", _bind_w4a8)
    M, K = x2.shape
    return a8_launch(lib, "lljt_qmm4_w4a8", x2, (qweight,), scales, zeros, out, plan,
                     (M, K, out.shape[-1]), levels=levels)


quant_matmul_int4_w4a8.launches = 0


def _check8(x, qweight, scales, zeros):
    K = x.shape[-1]
    if qweight.dim() != 2 or qweight.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"qweight must be a 2-D int8 or uint8 (K, N) matrix, got "
                         f"{tuple(qweight.shape)} {qweight.dtype}")
    Kw, N = qweight.shape
    if Kw != K:
        raise ValueError(f"x has K={K} but qweight has {Kw} rows")
    return K, N, check_groups(scales, zeros, N, K)


def quant_matmul_int8(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    unpack: str | None = None,
) -> torch.Tensor:
    """``x (..., K) @ dequant(qweight (K, N) int8 or uint8, scales/zeros (G, N) f32)``,
    returned in ``x.dtype``; the levels are signed when ``qweight`` is int8.

    ``unpack``: the JAX function's names. None and ``"bf16"`` compute exactly ``x @
    dequantize_with_k`` (below); ``"int8dot"`` computes the W8A8 product of
    `quant_matmul_int8_w8a8`; any other name raises.

    CPU tensors run `quant_matmul_int8_ref`. CUDA tensors launch the kernel (bf16 x,
    contiguous f32 scales and zeros on x's device) or raise.
    """
    if unpack == "int8dot":
        return quant_matmul_int8_w8a8(x, qweight, scales, zeros)
    if unpack not in (None, "bf16"):
        raise ValueError(f"unknown unpack {unpack!r}: one of None, 'bf16', 'int8dot'")
    K, N, G = _check8(x, qweight, scales, zeros)
    if not x.is_cuda:
        return quant_matmul_int8_ref(x, qweight, scales, zeros)
    x2, out, lead = prepare_launch("int8", x, N, qweight=qweight, scales=scales, zeros=zeros)
    M = x2.shape[0]
    if M == 0:
        return out.reshape(*lead, N)
    dev = x.device
    signed = int(qweight.dtype == torch.int8)
    lib = _build.load("quant_matmul_int8", _bind8)
    with torch.cuda.device(dev):
        if M <= GEMV_MAX_M:
            status = lib.lljt_qmm8_gemv(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, N, G, signed,
                *gemv_launch_args(x2, N, G, 8, qweight, scales, zeros),
            )
        else:
            plan = launch_gemm_plan(dev, x2, N, [qweight], scales, zeros)
            status = lib.lljt_qmm8_gemm(
                x2.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), M, K, N, G, signed, *plan,
                torch.cuda.current_stream(dev).cuda_stream,
            )
    quant_matmul_int8.launches += 1
    _build.check(lib, status, "quant_matmul_int8")
    return out.reshape(*lead, N)


quant_matmul_int8.launches = 0


def quant_matmul_int8_w8a8_ref(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of K3's W8A8 mode, step by step as the JAX kernel's ``int8dot``
    epilogue: x̂ from `a8_quantize_ref` over `w8a8_plan`'s groups; int8 levels as they
    are, uint8 levels as ``w ^ 0x80`` (``w - 128``) with ``zshift = 128`` folded into the
    zero; then `a8_fold_ref`'s ``(D - sx (z - zshift)) * (s / rsx)`` summed over groups."""
    K, N, G = _check8(x, qweight, scales, zeros)
    plan = w8a8_plan(K, G, x.numel() // K)
    signed = qweight.dtype == torch.int8
    levels = qweight.view(torch.int8) if signed else (qweight ^ 0x80).view(torch.int8)
    return a8_fold_ref(x, levels.float(), scales, zeros, plan, 0.0 if signed else 128.0,
                       out_dtype)


def quant_matmul_int8_w8a8(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """K3's W8A8 mode: ``Σ x̂ (q - z) s`` with x̂ the int8-rounded activation of
    `quant_matmul_int8_w8a8_ref`, returned in ``out_dtype`` (bf16 or f32 on CUDA;
    default ``x.dtype``). Plans the JAX kernel cannot run raise (`w8a8_plan`).

    CPU tensors run the plain version. CUDA tensors launch the kernel of
    ``csrc/quant_matmul_a8.cu`` or raise; it never falls back to the exact kernel."""
    K, N, G = _check8(x, qweight, scales, zeros)
    plan = w8a8_plan(K, G, x.numel() // K)
    if not x.is_cuda:
        return quant_matmul_int8_w8a8_ref(x, qweight, scales, zeros, out_dtype)
    x2, out, lead = a8_prepare("int8 W8A8", x, N, out_dtype, qweight=qweight, scales=scales,
                               zeros=zeros)
    if x2.shape[0] == 0:
        return out.reshape(*lead, N)
    w8a8_launch(x2, qweight, scales, zeros, out, plan)
    quant_matmul_int8_w8a8.launches += 1
    return out.reshape(*lead, N)


def w8a8_launch(x2: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                zeros: torch.Tensor, out: torch.Tensor, plan: A8Plan, levels: bool = False):
    """`a8_launch` of the W8A8 kernel; returns its rounding (see there)."""
    lib = _build.load("quant_matmul_a8", _bind_a8)
    M, K = x2.shape
    return a8_launch(lib, "lljt_qmm8_w8a8", x2, (qweight,), scales, zeros, out, plan,
                     (M, K, out.shape[-1]), (int(qweight.dtype == torch.int8),), levels)


quant_matmul_int8_w8a8.launches = 0


def _bind4(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm4_gemv", 5, [i] * 10)
    _build.bind(lib, "lljt_qmm4_gemm", 5, [i] * 8)


def _bind_w4a8(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm4_w4a8", 9, [i] * 10)
    _build.bind(lib, "lljt_qmm4_w4a8_gemv", 6, [i] * 10)


def _bind_a8(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm8_w8a8", 9, [i] * 11)
    _build.bind(lib, "lljt_qmm8_w8a8_gemv", 6, [i] * 11)


def _bind8(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_qmm8_gemv", 5, [i] * 11)
    _build.bind(lib, "lljt_qmm8_gemm", 5, [i] * 9)
