"""Paged int8 decode attention: the wrappers of ``csrc/paged_attention.cu`` (K7 and K8)
and their plain PyTorch version.

* `paged_decode_attention` replaces the Pallas kernel
  `lit_llama_ja_tpu/ops/pallas/paged_attention.py:99 paged_decode_attention`: one
  decode token per slot against that slot's pages of an int8 page pool. The serving
  engine's int8-pool decode step runs it (`infer/paged.py`).
* `paged_decode_attention_db` replaces `paged_decode_attention_db` (`:228`), the same
  function with the pages streamed by a producer warp's TMA bulk copies. As in the JAX
  package, no engine path calls it.

Both compute, for every slot ``b`` and head ``h``, attention over the tokens
``tok <= pos[b]`` of the pages ``tables[b, :]`` names (page ``j`` holds tokens
``j*page .. j*page + page - 1``): ``s = (q . k) * k_scale / sqrt(hd)``, a softmax in
f32 in which every other token weighs an exact 0, and ``out = sum (p * v_scale) v``.
Both take their splits from `paged_plan`, which reads the shapes and the SM count only.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from lit_llama_ja_tpu_torch.ops.attention import masked_softmax
from lit_llama_ja_tpu_torch.ops.cuda import _build

MAX_HEAD_DIM = 128
PAGED_WARPS = 4  # warps that fold tokens in a block (the kernels' WARPS)
PAGED_WARP_TILE = 16  # tokens a warp folds at a time: one m16n8k16 product (WT)
PAGED_MAX_CLUSTER = 8  # the portable cluster size (MAX_CLUSTER)
PAGED_BLOCKS_PER_SM = 4  # blocks an SM the splits aim at


class PagedPlan(NamedTuple):
    splits: int  # blocks of one (slot, head): one thread-block cluster
    span: int  # tokens a split takes, a whole number of tiles
    tile: int  # tokens a block folds in one round of its warps


@functools.lru_cache(maxsize=1024)
def paged_plan(B: int, nh: int, hd: int, page: int, AP: int, n_sm: int) -> PagedPlan:
    """Launch plan of K7 and K8 over tables of ``AP`` pages of ``page`` tokens.

    The tokens of each (slot, head) are cut into ``splits`` spans of ``span`` tokens,
    the blocks of one thread-block cluster that merge in rank order. ``splits`` aims at
    `PAGED_BLOCKS_PER_SM` blocks an SM over the ``B * nh`` clusters, within the cluster
    limit and with no split shorter than one tile; where the table spans more tokens
    than that, each split takes more tiles (never a second pass). The plan reads the
    shapes and the SM count only, never the positions, which live on the device: a
    launch captured in a CUDA graph stays valid while they move, and a split past a
    slot's last token exits at once on the card."""
    tile = PAGED_WARPS * PAGED_WARP_TILE
    n_tiles = -(-AP * page // tile)
    want = -(-PAGED_BLOCKS_PER_SM * n_sm // (B * nh))
    splits = max(1, min(PAGED_MAX_CLUSTER, want, n_tiles))
    span = -(-n_tiles // splits) * tile
    return PagedPlan(-(-AP * page // span), span, tile)


def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """``pages`` ``(P, nh, page, ...)`` gathered by ``tables`` ``(B, AP)`` into
    per-slot contiguous views ``(B, nh, AP * page, ...)``."""
    B, AP = tables.shape
    g = pages[tables.long()]  # (B, AP, nh, page, ...)
    g = g.movedim(2, 1)  # (B, nh, AP, page, ...)
    return g.reshape(B, g.shape[1], AP * pages.shape[2], *pages.shape[3:])


def paged_decode_attention_ref(q, k_pages, k_scale, v_pages, v_scale, tables, pos):
    """Plain version of K7 and K8, in f32: gather every page of the table, mask the
    tokens past ``pos`` with an exact 0 weight. Returns ``(B, nh, hd)`` in q's dtype."""
    _check_shapes(q, k_pages, k_scale, v_pages, v_scale, tables, pos)
    k = gather_pages(k_pages, tables).float()
    v = gather_pages(v_pages, tables).float()
    ks = gather_pages(k_scale, tables).float()
    vs = gather_pages(v_scale, tables).float()
    S = k.shape[2]
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k) * ks / math.sqrt(q.shape[-1])
    mask = (torch.arange(S, device=q.device)[None, :] <= pos[:, None].long())[:, None]
    p = masked_softmax(s, mask) * vs
    return torch.einsum("bhs,bhsd->bhd", p, v).to(q.dtype)


def _check_shapes(q, k_pages, k_scale, v_pages, v_scale, tables, pos):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B, nh, hd) and the pages (P, nh, page, hd), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, nh, hd = q.shape
    P, _, page, _ = k_pages.shape
    want = {"k_pages": (P, nh, page, hd), "v_pages": (P, nh, page, hd),
            "k_scale": (P, nh, page), "v_scale": (P, nh, page)}
    got = {"k_pages": k_pages, "v_pages": v_pages, "k_scale": k_scale, "v_scale": v_scale}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(got[name].shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or tables.shape[1] < 1:
        raise ValueError(f"tables must be (B={B}, AP >= 1), got {tuple(tables.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be (B={B},), got {tuple(pos.shape)}")


def _launch(fn, name: str, pipelined: bool, q, k_pages, k_scale, v_pages, v_scale, tables,
            pos) -> torch.Tensor:
    dev = q.device
    B, nh, hd = q.shape
    for tname, t, dtype in (("k_pages", k_pages, torch.int8), ("v_pages", v_pages, torch.int8),
                            ("k_scale", k_scale, torch.float32),
                            ("v_scale", v_scale, torch.float32), ("tables", tables, torch.int32),
                            ("pos", pos, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{tname} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"the {name} kernel takes {dtype} {tname}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous (a layer of a stacked pool is)")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes a bf16 q, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim must be at most {MAX_HEAD_DIM}, got {hd}")
    q = q.contiguous()
    o = torch.empty((B, nh, hd), dtype=q.dtype, device=dev)
    if o.numel() == 0:
        return o
    page, AP = k_pages.shape[2], tables.shape[1]
    plan = paged_plan(B, nh, hd, page, AP, _build.sm_count(dev.index))
    lib = _build.load("paged_attention", _bind)
    status = lib.lljt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(), v_pages.data_ptr(),
        v_scale.data_ptr(), tables.data_ptr(), pos.data_ptr(), o.data_ptr(), B, nh, page, hd,
        AP, plan.splits, plan.span, math.log2(math.e) / math.sqrt(hd), int(pipelined),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    fn.launches += 1
    _build.check(lib, status, name)
    return o


def paged_decode_attention(q, k_pages, k_scale, v_pages, v_scale, tables, pos):
    """One decode token per slot against its paged int8 KV; returns ``(B, nh, hd)``.

    Args:
      q: ``(B, nh, hd)``; k_pages, v_pages: ``(P, nh, page, hd)`` int8; k_scale,
        v_scale: ``(P, nh, page)`` f32; tables: ``(B, AP)`` int32 page indices in
        ``[0, P)``; pos: ``(B,)`` int32, the last visible position of each slot.

    CPU tensors run `paged_decode_attention_ref`. CUDA tensors launch K7, which takes
    a bf16 q with hd <= 128 and contiguous pages, scales, tables and pos (a layer of
    the stacked pool is contiguous), any page size; anything else raises. Each slot's
    tokens are split over the blocks of a cluster as `paged_plan` says, and the blocks
    merge in one launch.
    """
    _check_shapes(q, k_pages, k_scale, v_pages, v_scale, tables, pos)
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pages, k_scale, v_pages, v_scale, tables, pos)
    return _launch(paged_decode_attention, "paged_decode_attention", False, q, k_pages,
                   k_scale, v_pages, v_scale, tables, pos)


paged_decode_attention.launches = 0


def paged_decode_attention_db(q, k_pages, k_scale, v_pages, v_scale, tables, pos):
    """`paged_decode_attention` with each block's pages streamed by a producer warp's
    TMA bulk copies into a three-stage ring (K8). Same arguments, same checks, same plan,
    same plain version on CPU tensors."""
    _check_shapes(q, k_pages, k_scale, v_pages, v_scale, tables, pos)
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pages, k_scale, v_pages, v_scale, tables, pos)
    return _launch(paged_decode_attention_db, "paged_decode_attention_db", True, q, k_pages,
                   k_scale, v_pages, v_scale, tables, pos)


paged_decode_attention_db.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    i = ctypes.c_int
    _build.bind(lib, "lljt_paged_decode", 8, [i] * 7 + [ctypes.c_float, i, i])
