"""Paged KV cache and the paged continuous-batching engine (counterpart of
`lit_llama_ja_tpu/infer/paged.py`).

The cache is a **page pool** ``(L, n_pages, nh, page_size, hd)`` (bf16, or int8 /
head-pair int4 with per-token scales ``(L, n_pages, nh, page_size)``), a budget shared
by all slots. Each slot holds a page table of pool indices; position ``p`` lives at
``(table[p // page], p % page)``. Page 0 is the trash page: padding and unallocated
table entries point at it, and attention never lets it through. A registered prompt
prefix's full pages are shared by reference (refcounted, read-only). Admission waits
when the pool has no free pages, and a slot that runs out mid-decode preempts the
longest request, which later resumes exactly.

The forward is **write-then-attend**, the JAX package's ``use_kernel`` route: each
layer writes its tokens' k/v into the pool IN PLACE and then attends to the pool, so a
slot's new tokens see themselves. The JAX package's default defers the writes (and
splits a step into a read program and a commit program, or pipelines the commit one
step late) only to keep XLA from copying the pool; eager PyTorch writes in place, so
the engine has no such forms. `paged_forward_read` and `commit_writes` keep the
deferred route as functions; ``pipelined_commit`` is accepted and changes nothing.

Attention dispatch, per layer:
  * a span from position 0 (``prefill_attn``) attends causally over its own k/v
    through `causal_attention` (K2 on CUDA);
  * a T == 1 decode over an int8 pool runs `paged_decode_attention` (K7 on CUDA, its
    plain version on the CPU), whatever ``use_kernel`` says;
  * everything else (fp and int4 pools, spans that start past 0) gathers the pages
    and attends in plain PyTorch, as the JAX package leaves it to XLA.

MoE blocks (`models/moe.py`) take the sparse MLP in place of the dense one; their
capacity covers every (slot, token) assignment of the step, idle slots included, so
nothing drops and the tokens equal `generate`'s.

On a ``(dp=1, fsdp, tp)`` mesh (``mesh=``) the params are this rank's slices and the
forward runs sharded (`parallel/sharded.py`); the pool holds this rank's ``nh / tp``
heads, so K7 runs on them. On a pipeline mesh (``pp_mesh=``, with a ``pp`` axis and
optionally ``tp`` and ``fsdp``) each rank holds its stage's layers and their slice of
the pool, and the forward is `parallel/pp_decode.make_pp_span_forward`'s wavefront.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, find_multiple
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import PagedStep, SpanStep
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.models.llama import (
    _check_params_device,
    _qkv,
    apply_linear,
    block_config,
    embed as _embed,
    layer_params,
    lm_head,
    mlp_block,
    normalize_kv_mode,
)
from lit_llama_ja_tpu_torch.models.moe import moe_mlp
from lit_llama_ja_tpu_torch.ops.attention import (
    causal_attention,
    int4_scores,
    int4_values,
    masked_softmax as _masked_softmax,
    quantize_kv,
    quantize_kv4,
)
from lit_llama_ja_tpu_torch.ops.cuda.paged_attention import gather_pages, paged_decode_attention
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.ops.rope import build_rope_cache
from lit_llama_ja_tpu_torch.ops.sampling import categorical, sample_token, top_p_filter

PagePool = Dict[str, torch.Tensor]


def init_page_pool(
    config: LLaMAConfig,
    n_pages: int,
    page_size: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized=False,
    device="cuda",
) -> PagePool:
    """Zero page pool ``(L, n_pages, nh, page_size, hd)`` (plus per-token scales
    ``(L, n_pages, nh, page_size)``, ones, when quantized).

    ``quantized``: False | True/"int8" | "int4" (packed two per byte across head pairs,
    ``(L, n_pages, nh/2, page_size, hd)`` uint8, `ops/attention.quantize_kv4`).
    ``n_pages`` includes the trash page 0, so ``(n_pages - 1) * page_size`` tokens are
    usable across all slots.
    """
    dev = resolve_device(device)
    quantized = normalize_kv_mode(quantized)
    L, nh, hd = config.n_layer, config.n_head, config.head_dim
    sshape = (L, n_pages, nh, page_size)
    if quantized:
        if quantized == "int4":
            shape, qdtype = (L, n_pages, nh // 2, page_size, hd), torch.uint8
        else:
            shape, qdtype = (*sshape, hd), torch.int8
        return {
            "k": torch.zeros(shape, dtype=qdtype, device=dev),
            "v": torch.zeros(shape, dtype=qdtype, device=dev),
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
        }
    shape = (*sshape, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _gathered(cache_l: Dict[str, torch.Tensor], tables: torch.Tensor):
    """Gather one layer's pages into per-slot contiguous ``bhsd`` views: leaves
    ``(n_pages, nh, page, ...)``, tables ``(B, AP)`` -> ``(B, nh, AP * page, ...)``."""
    return {key: gather_pages(val, tables) for key, val in cache_l.items()}


def _is_int4(gath) -> bool:
    return gath["k"].dtype == torch.uint8


def _paged_attention(q, gath, pos, quantized):
    """q: (B, nh, T, hd); gath leaves (B, nh, S, hd) (S = AP * page); pos: (B, T)
    absolute positions of the query tokens. The masked-softmax and folded-scale math
    of `ops/attention.decode_attention_quant` (and its int4 form), for T query tokens
    at per-(slot, token) positions."""
    S = gath["k"].shape[2]
    slot = torch.arange(S, dtype=pos.dtype, device=pos.device)
    mask = (slot[None, None, :] <= pos[:, :, None])[:, None]  # (B, 1, T, S)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if quantized and _is_int4(gath):
        att = int4_scores(q, gath["k"]) * gath["k_scale"][:, :, None, :].float()
        att = _masked_softmax(att * scale, mask)
        att = (att * gath["v_scale"][:, :, None, :]).to(q.dtype)
        return int4_values(att, gath["v"])
    if quantized:
        att = torch.einsum("bhqd,bhsd->bhqs", q, gath["k"].to(q.dtype))
        att = att * gath["k_scale"][:, :, None, :].float()
        att = _masked_softmax(att * scale, mask) * gath["v_scale"][:, :, None, :]
        return torch.einsum("bhqs,bhsd->bhqd", att.to(q.dtype), gath["v"].to(q.dtype))
    att = torch.einsum("bhqd,bhsd->bhqs", q, gath["k"].to(q.dtype)) * scale
    att = _masked_softmax(att.float(), mask).to(q.dtype)
    return torch.einsum("bhqs,bhsd->bhqd", att, gath["v"].to(q.dtype))


def _span_attention(q, gath, fresh, pos0, quantized):
    """Attention of a contiguous (B, T) token span against ``[stale paged cache | the
    span's own fresh k/v]`` (the deferred-write route of `paged_forward_read`).

    q: (B, nh, T, hd); gath: page-cache views (B, nh, S, ...) that do NOT hold the span
    yet (masked strictly below ``pos0`` (B,), the span's first position); fresh: the
    layer's writes in write layout, k/v (B, T, nh, hd) ((B, T, nh/2, hd) packed for
    int4) and scales (B, T, nh), quantized as the cache write quantizes them, so the
    result matches write-then-attend; the span attends to itself causally."""
    B, nh, T, hd = q.shape
    S = gath["k"].shape[2]
    scale = 1.0 / (hd**0.5)
    slot = torch.arange(S, dtype=pos0.dtype, device=pos0.device)
    cmask = (slot[None, :] < pos0[:, None])[:, None, None, :].expand(B, 1, T, S)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    mask = torch.cat([cmask, causal[None, None].expand(B, 1, T, T)], dim=-1)
    fk = fresh["k"].transpose(1, 2)  # (B, nh[/2], T, hd)
    fv = fresh["v"].transpose(1, 2)
    if quantized:
        fks = fresh["k_scale"].transpose(1, 2)  # (B, nh, T)
        fvs = fresh["v_scale"].transpose(1, 2)
        if _is_int4(gath):
            att_c = int4_scores(q, gath["k"])
            att_f = int4_scores(q, fk)
        else:
            att_c = torch.einsum("bhqd,bhsd->bhqs", q, gath["k"].to(q.dtype))
            att_f = torch.einsum("bhqd,bhsd->bhqs", q, fk.to(q.dtype))
        att_c = att_c * gath["k_scale"][:, :, None, :].float()
        att_f = att_f * fks[:, :, None, :].float()
        att = _masked_softmax(torch.cat([att_c, att_f], -1) * scale, mask)
        ac = (att[..., :S] * gath["v_scale"][:, :, None, :]).to(q.dtype)
        af = (att[..., S:] * fvs[:, :, None, :]).to(q.dtype)
        if _is_int4(gath):
            return int4_values(ac, gath["v"]) + int4_values(af, fv)
        return (torch.einsum("bhqs,bhsd->bhqd", ac, gath["v"].to(q.dtype))
                + torch.einsum("bhqs,bhsd->bhqd", af, fv.to(q.dtype)))
    att_c = torch.einsum("bhqd,bhsd->bhqs", q, gath["k"].to(q.dtype))
    att_f = torch.einsum("bhqd,bhsd->bhqs", q, fk.to(q.dtype))
    att = _masked_softmax((torch.cat([att_c, att_f], -1) * scale).float(), mask).to(q.dtype)
    return (torch.einsum("bhqs,bhsd->bhqd", att[..., :S], gath["v"].to(q.dtype))
            + torch.einsum("bhqs,bhsd->bhqd", att[..., S:], fv.to(q.dtype)))


@functools.lru_cache(maxsize=16)
def _rope_table(length: int, head_dim: int, base: int, device: torch.device):
    return build_rope_cache(length, head_dim, base, device=device)


def _kv_writes(k, v, quantized, pool_dtype) -> Dict[str, torch.Tensor]:
    """One layer's pool writes from k, v in write layout (B, T, nh, hd)."""
    if quantized == "int4":
        kq, ks, vq, vs = quantize_kv4(k, v)
    elif quantized:
        kq, ks, vq, vs = quantize_kv(k, v)
    else:
        return {"k": k.to(pool_dtype), "v": v.to(pool_dtype)}
    return {"k": kq, "v": vq, "k_scale": ks[..., 0], "v_scale": vs[..., 0]}


def _chunks(B: int, attn_chunk: Optional[int]):
    """Slot ranges of the decode attention: ``attn_chunk`` slots at a time when it
    divides B (it bounds the gathered views' memory; results are the same)."""
    step = attn_chunk if attn_chunk and attn_chunk < B and B % attn_chunk == 0 else B
    return [slice(i, i + step) for i in range(0, B, step)]


def page_coords(tables: torch.Tensor, pos: torch.Tensor, page: int):
    """``(page_idx, offs)`` of every ``(slot, token)`` position ``pos`` (B, T). An idle
    slot keeps the position it retired at, which may lie past the attend width: its
    (all-trash) row's last entry takes the write, where the JAX package drops it."""
    page_idx = torch.gather(tables, 1, torch.div(pos, page, rounding_mode="floor").long()
                            .clamp(max=tables.shape[1] - 1))
    return page_idx, pos % page


def paged_block_chain(
    blocks,
    pool: PagePool,
    x: torch.Tensor,  # (B, T, D) embedded inputs
    pos: torch.Tensor,  # (B, T)
    tables: torch.Tensor,  # (B, AP)
    config: LLaMAConfig,
    quantized,
    use_kernel: bool = False,
    attn_chunk: Optional[int] = None,
    defer_commit: bool = False,
    prefill_attn: bool = False,
    mesh=None,
):
    """The transformer blocks of `paged_forward` (between the embedding and the final
    norm); the ``blocks`` and ``pool`` leading L axis may be any contiguous layer slice.
    ``mesh``: this rank's slices and heads (see the module docstring).

    Default: write-then-attend, the pool written in place per layer; returns
    ``(x, pool)``. ``defer_commit=True`` leaves the pool untouched and returns
    ``(x, writes, page_idx, offs)`` for `commit_writes`, the writes' leaves stacked
    ``(L, B, T, ...)``. ``prefill_attn`` is the caller's promise that the span starts
    at position 0 on fresh pages: attention runs causally over the span's own k/v and
    no page is gathered. ``use_kernel`` is accepted for the JAX signature: the int8
    decode always runs `paged_decode_attention`."""
    del use_kernel
    quantized = normalize_kv_mode(quantized)
    B, T = x.shape[:2]
    page = pool["k"].shape[3]  # leaves are (L, n_pages, nh, page, hd)
    config = block_config(config, mesh)
    nh = config.n_head
    L = blocks["rms_1"]["scale"].shape[0]
    # the rope table reaches the table's capacity, past block_size (extrapolated
    # positions, as the JAX package's paged forward does)
    rope_len = max(config.block_size, tables.shape[1] * page)
    rope_t = _rope_table(rope_len, config.head_dim, config.rope_base, x.device)[
        pos.long().clamp(0, rope_len - 1)]  # (B, T, hd/2, 2)
    page_idx, offs = page_coords(tables, pos, page)
    pi, of = page_idx.long(), offs.long()

    writes_by_layer = []
    for l in range(L):
        bp = layer_params(blocks, l, mesh)
        q, k, v = _qkv(bp["attn"], rmsnorm(x, bp["rms_1"]["scale"], config.norm_eps), nh,
                       rope_t)  # (B, nh, T, hd)
        writes = _kv_writes(k.transpose(1, 2), v.transpose(1, 2), quantized, pool["k"].dtype)
        cache_l = {key: val[l] for key, val in pool.items()}
        if defer_commit:
            writes_by_layer.append(writes)
        else:
            for key, val in writes.items():
                cache_l[key][pi, :, of] = val
        if prefill_attn:
            y = causal_attention(q, k, v)
        elif not defer_commit and T == 1 and quantized == "int8":
            y = paged_decode_attention(
                q[:, :, 0], cache_l["k"], cache_l["k_scale"], cache_l["v"], cache_l["v_scale"],
                tables, pos[:, 0],
            )[:, :, None]
        elif defer_commit:
            y = torch.cat([
                _span_attention(q[c], _gathered(cache_l, tables[c]),
                                {key: w[c] for key, w in writes.items()}, pos[c, 0], quantized)
                for c in _chunks(B, attn_chunk if T == 1 else None)], dim=0)
        else:
            y = torch.cat([
                _paged_attention(q[c], _gathered(cache_l, tables[c]), pos[c], quantized)
                for c in _chunks(B, attn_chunk if T == 1 else None)], dim=0)
        x = x + apply_linear(bp["attn"]["c_proj"], y.transpose(1, 2).reshape(B, T, -1))
        h = rmsnorm(x, bp["rms_2"]["scale"], config.norm_eps)
        if "moe" in bp:
            cap = find_multiple(B * T * config.n_expert_active, 8)
            x = x + moe_mlp(bp["moe"], h, config, capacity=cap)[0]
        else:
            x = x + mlp_block(bp["mlp"], h)
    if defer_commit:
        stacked = {key: torch.stack([w[key] for w in writes_by_layer])
                   for key in writes_by_layer[0]}
        return x, stacked, page_idx, offs
    return x, pool


def _inputs(params, toks, pos, tables, device, mesh=None, embed: bool = True):
    """The embedded tokens (None without ``embed``: a later pipeline stage), the
    positions and the tables, on the device."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    toks = torch.as_tensor(toks, device=dev).long()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    tables = torch.as_tensor(tables, dtype=torch.int32, device=dev)
    return (_embed(params, toks, mesh) if embed else None), pos, tables.contiguous()


@torch.no_grad()
def paged_forward(
    params,
    toks,  # (B, T) tokens (T = 1 decode, T = P prefill)
    pos,  # (B, T) absolute positions of those tokens
    tables,  # (B, AP) page indices (attend width AP * page)
    pool: PagePool,
    config: LLaMAConfig,
    quantized,
    use_kernel: bool = False,
    attn_chunk: Optional[int] = None,
    prefill_attn: bool = False,
    device="cuda",
    mesh=None,
) -> Tuple[torch.Tensor, PagePool]:
    """One paged forward: write each token's k/v at ``(table[pos // page], pos % page)``
    IN PLACE, attend against the pages (write-then-attend, so a slot's new tokens see
    themselves), return ``(logits (B, T, V), pool)`` with the same pool dict.

    Batched decode (T = 1, B slots) and prefill (B = 1, T tokens) share it.
    ``attn_chunk``: gather and attend ``attn_chunk`` slots at a time in the plain decode
    attention (memory only; the results are the same). ``mesh``: this rank's slices,
    pool of this rank's heads; the logits come back whole."""
    x, pos, tables = _inputs(params, toks, pos, tables, device, mesh)
    x, pool = paged_block_chain(params["blocks"], pool, x, pos, tables, config, quantized,
                                use_kernel, attn_chunk, prefill_attn=prefill_attn, mesh=mesh)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh), pool


@torch.no_grad()
def paged_forward_read(
    params,
    toks,  # (B, T)
    pos,  # (B, T)
    tables,  # (B, AP)
    pool: PagePool,
    config: LLaMAConfig,
    quantized,
    attn_chunk: Optional[int] = None,
    prefill_attn: bool = False,
    device="cuda",
):
    """Read-only `paged_forward`: the pool is never written; the span's k/v come back
    as ``writes`` for `commit_writes`. Returns ``(logits, writes, page_idx, offs)``.

    ``prefill_attn``: the caller's promise that the span starts at position 0 on fresh
    pages (causal attention over the span's own k/v, no page gathered)."""
    x, pos, tables = _inputs(params, toks, pos, tables, device)
    x, writes, page_idx, offs = paged_block_chain(
        params["blocks"], pool, x, pos, tables, config, quantized, attn_chunk=attn_chunk,
        defer_commit=True, prefill_attn=prefill_attn,
    )
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return apply_linear(params["lm_head"], x), writes, page_idx, offs


def commit_writes(
    pool: PagePool,
    all_writes: Dict[str, torch.Tensor],  # leaves (L, B, T, nh, ...)
    page_idx: torch.Tensor,  # (B, T)
    offs: torch.Tensor,  # (B, T)
) -> PagePool:
    """Write the per-(slot, token) k/v of every layer into the pool IN PLACE; returns
    the same dict. Padding and idle slots write to the trash page (page 0), where
    entries that land on one place may do so in any order."""
    BT = page_idx.numel()
    pi, of = page_idx.reshape(BT).long(), offs.reshape(BT).long()
    for key, val in all_writes.items():
        flat = val.reshape(val.shape[0], BT, *val.shape[3:])  # (L, BT, nh[, hd])
        # indices split by a slice put their dimension first: (BT, L, nh[, hd])
        pool[key][:, pi, :, of] = flat.transpose(0, 1).to(pool[key].dtype)
    return pool


def sample_next_token(
    logits: torch.Tensor,  # (B, V)
    temps: torch.Tensor,  # (B,) 0 = greedy
    top_k: Optional[int],
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Per-slot temperature / top-k / top-p sampling; returns ``(B,)`` int32 on the
    logits' device. Greedy rows take the argmax; the others draw from ``generator``.
    As in the JAX package, top-k and top-p filter the untempered logits."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    temps = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
    sample_logits = logits
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        sample_logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        sample_logits = top_p_filter(sample_logits, top_p)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    probs = torch.softmax(sample_logits / safe_t, dim=-1)
    sampled = categorical(probs, generator)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def paged_decode_and_sample(params, pool, config, quantized, attn_chunk, device, generator,
                            top_k, top_p, toks, pos, tables, temps, out) -> None:
    """The batched decode step and the per-slot sampling in one body (the JAX package's
    `_paged_decode_and_sample`) over `infer/decode_graph.PagedStep`'s device buffers:
    ``toks``, ``pos`` ``(B,)``, ``tables`` ``(B, AP)``, ``temps`` ``(B,)``; the sampled
    tokens go to ``out`` ``(B,)``. It reads nothing back to the host."""
    logits = paged_forward(params, toks[:, None], pos[:, None], tables, pool, config,
                           quantized, attn_chunk=attn_chunk, device=device)[0]
    out.copy_(sample_next_token(logits[:, 0], temps, top_k, top_p, generator))


def paged_span_body(params, pool, config, quantized, attn_chunk, device, prefill_attn, *,
                    toks, pos, tables, last, out) -> None:
    """A prefill span (the JAX package's jitted `paged_forward_read` and
    `commit_writes_jit` of one span) over `infer/decode_graph.SpanStep`'s device
    buffers: ``toks`` ``(1, P)``, ``pos`` ``(P,)``, ``tables`` ``(1, AP)``, ``last``
    ``(1,)`` the row of the last real token. The span's k/v land in the pool in place;
    the logits of row ``last`` go to ``out`` ``(V,)``. It reads nothing back to the
    host."""
    logits = paged_forward(params, toks, pos[None], tables, pool, config, quantized,
                           attn_chunk=attn_chunk, prefill_attn=prefill_attn, device=device)[0]
    out.copy_(logits[0].index_select(0, last)[0])


@dataclasses.dataclass
class _PagedRequest:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: Optional[int]
    prefix_id: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    preempts: int = 0


class PagedEngine:
    """Continuous-batching engine over a paged KV pool with prefix sharing."""

    def __init__(
        self,
        params,
        config: LLaMAConfig,
        *,
        max_batch: int = 8,
        n_pages: int = 256,
        page_size: int = 16,
        max_pages_per_slot: Optional[int] = None,
        quantize_kv=False,
        eos_id: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        seed: int = 0,
        pp_mesh=None,
        pp_microbatches: int = 1,
        pp_split: bool = True,
        pipelined_commit: bool = False,
        device="cuda",
        mesh=None,
        cuda_graph: bool = True,
    ):
        """``prefill_chunk``: prefill prompts in chunks of at most this many tokens,
        interleaved with decode steps, so a long prompt does not stall the active
        streams for its whole prefill. None = whole-prompt prefill at admission.

        ``pp_mesh``: serve pipeline-parallel over its ``pp`` axis (`parallel/
        pp_decode.py`): every rank runs the engine alike (allocator, tables, prefix
        sharing, chunked prefill, preemption, sampling from the same generator state),
        holds its stage's layers and their slice of the pool; ``params`` is the full
        tree (cut here) or this rank's `parallel/pipeline.shard_params_pp` slice.
        ``pp_microbatches``: the decode wavefront's micro-groups (dividing
        ``max_batch``). ``pp_split`` and ``pipelined_commit`` are accepted and change
        nothing: as on one device, each layer's writes land in place (the JAX package
        splits a step only to keep XLA from copying the pool; `parallel/pp_decode.
        make_pp_decode_read` and `make_pp_commit` keep the split as functions).
        ``seed`` seeds the engine's `torch.Generator` on ``device``. ``mesh``: a
        ``(dp=1, fsdp, tp)`` mesh whose ranks all run the engine alike, ``params`` this
        rank's `parallel/specs.shard_params` slices.

        Without a mesh the batched decode step runs on device buffers
        (`infer/decode_graph.PagedStep`): on a CUDA device one CUDA graph a (attend
        width, top-k, top-p), captured at its first step and replayed after that; so does
        each prefill span (`infer/decode_graph.SpanStep`, `paged_span_body`), one graph a
        (span length, attend width, ``prefill_attn``), all in one memory pool.
        ``cuda_graph=False`` runs the bodies eagerly, which only a comparison of the two
        needs. Admission and preemption run on the host. A mesh or a pipeline runs its
        steps and spans eagerly: their collectives stage through the host over gloo."""
        for m in (mesh, pp_mesh):
            if m is not None and m.shape["dp"] != 1:
                raise ValueError("the engine's slots replicate over the mesh: dp must be 1")
        if pp_mesh is not None and mesh is not None:
            raise ValueError("pass one mesh: a pipeline mesh carries its tp and fsdp axes")
        del pp_split, pipelined_commit
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.pp_mesh, self.pp_microbatches = pp_mesh, pp_microbatches
        L_local = config.n_layer
        if pp_mesh is not None:
            from lit_llama_ja_tpu_torch.parallel.pipeline import check_pipeline, shard_params_pp

            if max_batch % pp_microbatches:
                raise ValueError(f"max_batch {max_batch} does not split into "
                                 f"{pp_microbatches} micro-groups")
            L_local = config.n_layer // check_pipeline(config, pp_mesh)
            if params["blocks"]["rms_1"]["scale"].shape[0] != L_local:
                params = shard_params_pp(params, pp_mesh)
            mesh = pp_mesh
        self.mesh = mesh
        self.params = params
        self.config = config
        self.B = max_batch
        self.page = page_size
        self.n_pages = n_pages
        self.maxP = max_pages_per_slot or max(1, (2 * config.block_size) // page_size)
        self.quantized = normalize_kv_mode(quantize_kv)
        self.eos_id = eos_id
        self.pool = init_page_pool(block_config(config, mesh).replace(n_layer=L_local),
                                   n_pages, page_size, torch.bfloat16, self.quantized,
                                   device=self.device)
        # host-side allocator state; page 0 is the reserved trash page
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.page_refs = np.zeros(n_pages, np.int32)
        self.tables = np.zeros((max_batch, self.maxP), np.int32)
        self.n_owned = np.zeros(max_batch, np.int32)  # table entries in use
        self.n_shared = np.zeros(max_batch, np.int32)  # leading shared (read-only)
        self.pos = np.zeros(max_batch, np.int32)
        self.cur = np.zeros(max_batch, np.int32)
        self.temps = np.zeros(max_batch, np.float32)
        self.top_k: Optional[int] = None
        self.top_p: Optional[float] = None
        self.slot_req: List[Optional[_PagedRequest]] = [None] * max_batch
        self.queue: List[_PagedRequest] = []
        self.prefill_chunk = prefill_chunk
        # the plain decode attention gathers at most 4 slots' pages at a time above 8
        # slots, as the JAX engine chunks it (here it only bounds memory)
        self.attn_chunk = None
        if max_batch > 8:
            for c in (4, 3, 2):
                if max_batch % c == 0:
                    self.attn_chunk = c
                    break
        # slot -> in-progress chunked prefill: the slot's real table row lives here
        # (self.tables row stays all-trash) so interleaved decode writes for other
        # slots can never land in a half-prefilled region
        self.prefilling: Dict[int, dict] = {}
        self._next_id = 0
        self._prefixes: Dict[int, Tuple[List[int], np.ndarray]] = {}
        self._next_prefix = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the buffer-fed step and span, made at the first decode step and the first
        # prefill span of an engine without a mesh; their graphs share one memory pool
        self.decode_step: Optional[PagedStep] = None
        self.span_step: Optional[SpanStep] = None
        self._capture = self.device.type == "cuda" and cuda_graph
        self._graph_pool = torch.cuda.graph_pool_handle() if self._capture else None
        # observability counters (see stats())
        self._steps = 0
        self._tokens_out = 0
        self._prefill_tokens = 0
        self._preempts = 0
        self._completed = 0

    # -- allocator ---------------------------------------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        self.page_refs[pages] = 1
        return pages

    def _release(self, pages) -> None:
        for p in pages:
            if p == 0:
                continue
            self.page_refs[p] -= 1
            if self.page_refs[p] == 0:
                self.free.append(int(p))

    def free_token_budget(self) -> int:
        return len(self.free) * self.page

    # -- prefix sharing ----------------------------------------------------
    def register_prefix(self, prefix_tokens) -> Optional[int]:
        """Prefill a shared prompt prefix ONCE; returns a prefix_id usable in
        `add_request`. Only full pages are shared (the tail re-prefills per request).
        Returns None if the pool lacks pages for it right now."""
        toks = np.asarray(prefix_tokens, np.int32)
        n_full = len(toks) // self.page
        if n_full == 0:
            pid = self._next_prefix
            self._next_prefix += 1
            self._prefixes[pid] = ([], toks)
            return pid
        pages = self._alloc(n_full)
        if pages is None:
            return None
        shared_len = n_full * self.page
        self._prefill_span(toks[:shared_len], start_pos=0, table_pages=pages, want_logits=False)
        pid = self._next_prefix
        self._next_prefix += 1
        self._prefixes[pid] = (pages, toks[shared_len:])
        return pid

    def release_prefix(self, prefix_id: int) -> None:
        pages, _ = self._prefixes.pop(prefix_id)
        self._release(pages)

    # -- requests ----------------------------------------------------------
    def add_request(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        prefix_id: Optional[int] = None,
    ) -> int:
        """Queue a request. With ``prefix_id``, ``prompt`` is the continuation AFTER
        the registered prefix (the engine prepends the prefix tail)."""
        if top_p is not None:
            self.top_p = top_p if self.top_p is None else self.top_p
        req = _PagedRequest(
            self._next_id, np.asarray(prompt, np.int32), max_new_tokens,
            temperature, top_k, prefix_id,
        )
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def _forward(self, toks, pos, tables, prefill_attn=False, rows=None):
        """The logits ``(B, T, V)`` of a step or a span (``rows``: only those token
        columns)."""
        if self.pp_mesh is not None:
            return self._pp_span(toks, pos, tables, prefill_attn, rows)
        logits = paged_forward(self.params, toks, pos, tables, self.pool, self.config,
                               self.quantized, attn_chunk=self.attn_chunk,
                               prefill_attn=prefill_attn, device=self.device,
                               mesh=self.mesh)[0]
        return logits if rows is None else logits[:, rows]

    def _pp_span(self, toks, pos, tables, prefill_attn, rows):
        """`_forward` on a pipeline mesh: the decode wavefront over ``pp_microbatches``
        micro-groups, or a prefill span as one."""
        from lit_llama_ja_tpu_torch.parallel.pp_decode import make_pp_span_forward

        B, T = np.shape(toks)
        inner = make_pp_span_forward(
            self.config, self.pp_mesh, T=T, n_micro=self.pp_microbatches if B == self.B else 1,
            quantized=self.quantized, attn_chunk=self.attn_chunk, prefill_attn=prefill_attn,
            device=self.device)
        logits, self.pool = inner(self.params, toks, pos, tables, self.pool, rows)
        return logits

    def _span_inputs(self, toks, start_pos, table_pages):
        """A prefill span's ``(tokens, positions, table)``, each ``(1, ...)``: the tokens
        padded to a power-of-2 bucket, and the table to the pages up to the end of the
        padded span, power-of-2 wide (padding past ``table_pages`` goes to the trash
        page)."""
        P = bucket_length(len(toks))
        ap = bucket_length((start_pos + P + self.page - 1) // self.page, minimum=1)
        table = np.zeros(ap, np.int32)
        usable = min(len(table_pages), ap)
        table[:usable] = table_pages[:usable]
        padded = np.zeros(P, np.int32)
        padded[: len(toks)] = toks
        pos = start_pos + np.arange(P, dtype=np.int32)
        return padded[None], pos[None], table[None]

    def _span_body(self):
        """The prefill span's body over this engine's params and pool (not the engine)."""
        return functools.partial(paged_span_body, self.params, self.pool, self.config,
                                 self.quantized, self.attn_chunk, self.device)

    def _prefill_span(self, toks, start_pos, table_pages, want_logits=True):
        """Prefill ``toks`` at absolute positions ``start_pos..``, writing into
        ``table_pages``. Returns the last token's logits ``(V,)`` on the device, or
        None. Without a mesh the span runs through the engine's `SpanStep` (captured
        on a CUDA device), on a mesh eagerly."""
        self._prefill_tokens += len(toks)
        padded, pos, table = self._span_inputs(toks, start_pos, table_pages)
        # a span on empty fresh pages attends causally to itself (no gather); chunked
        # or prefix-continuing spans (start_pos > 0) read the pool
        prefill_attn = bool(start_pos == 0)
        if self.mesh is None:
            if self.span_step is None:
                self.span_step = SpanStep(
                    self.device, self._span_body(), (self.config.padded_vocab_size,),
                    self.params["wte"]["weight"].dtype, capture=self._capture,
                    pool=self._graph_pool)
            # the last real row, on the device (an empty span: the last padded row)
            last = np.array([(len(toks) - 1) % padded.shape[1]], np.int64)
            logits = self.span_step.run((prefill_attn,), toks=padded, pos=pos[0], tables=table,
                                        last=last)
            return logits if want_logits else None
        logits = self._forward(padded, pos, table, prefill_attn=prefill_attn,
                               rows=[len(toks) - 1] if want_logits else [])
        return logits[0, 0] if want_logits else None

    def _admit(self):
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            resuming = bool(req.tokens)  # preempted request being re-admitted
            shared_pages: List[int] = []
            tail = req.prompt
            if req.prefix_id is not None:
                spages, sprefix_tail = self._prefixes[req.prefix_id]
                shared_pages = list(spages)
                tail = np.concatenate([sprefix_tail, req.prompt])
            if resuming:
                # re-prefill everything written before preemption; the last sampled
                # token becomes `cur` (it was never written to the cache)
                tail = np.concatenate([tail, np.asarray(req.tokens[:-1], np.int32)])
            shared_len = len(shared_pages) * self.page
            total_len = shared_len + len(tail)
            if total_len >= self.maxP * self.page:
                self.queue.pop(0)
                req.done = True
                raise ValueError(
                    f"prompt length {total_len} exceeds the table capacity "
                    f"{self.maxP * self.page - 1}"
                )
            n_tail_pages = max(
                0, (total_len + self.page) // self.page - len(shared_pages)
            )  # pages covering tail tokens + at least 1 decode slot
            own = self._alloc(n_tail_pages)
            if own is None:
                if not any(r is not None for r in self.slot_req):
                    raise RuntimeError(
                        f"page pool too small: request needs {n_tail_pages} pages "
                        f"({total_len} tokens) with the whole pool free "
                        f"({len(self.free)} of {self.n_pages - 1} pages)"
                    )
                return  # pool exhausted: the head-of-line request waits (backpressure)
            self.queue.pop(0)
            row = np.zeros(self.maxP, np.int32)
            row[: len(shared_pages)] = shared_pages
            row[len(shared_pages): len(shared_pages) + len(own)] = own
            for p in shared_pages:
                self.page_refs[p] += 1
            n_owned = len(shared_pages) + len(own)
            req.slot = slot
            self.slot_req[slot] = req
            self.n_shared[slot] = len(shared_pages)
            self.n_owned[slot] = n_owned
            C = self.prefill_chunk
            if C is not None and len(tail) > C:
                # chunked: the table row installs only at activation; until then the
                # slot decodes against trash (pos/cur pinned to 0)
                self.tables[slot] = 0
                self.pos[slot] = 0
                self.cur[slot] = 0
                self.prefilling[slot] = {
                    "req": req, "tail": tail, "off": 0, "row": row,
                    "shared_len": shared_len, "total_len": total_len,
                    "resuming": resuming, "n_owned": n_owned,
                }
                continue
            self.tables[slot] = row
            logits = self._prefill_span(
                tail, start_pos=shared_len, table_pages=list(row[:n_owned]),
                want_logits=not resuming,
            )
            self._activate(slot, req, logits, resuming, total_len)

    def _activate(self, slot, req, logits, resuming, total_len):
        """Final bookkeeping once a slot's whole prompt is in the cache."""
        self.pos[slot] = total_len
        self.temps[slot] = req.temperature
        if resuming:
            self.cur[slot] = req.tokens[-1]
        else:
            tok = int(sample_token(logits, req.temperature, req.top_k,
                                   generator=self.generator))
            req.tokens.append(tok)
            self.cur[slot] = tok
        if req.top_k is not None:
            self.top_k = req.top_k if self.top_k is None else self.top_k
        self._maybe_finish(req)

    def _advance_prefills(self):
        """Run ONE chunk of prefill per in-progress slot; activate on the last."""
        for slot, st in list(self.prefilling.items()):
            C = self.prefill_chunk
            tail, off = st["tail"], st["off"]
            chunk = tail[off: off + C]
            last = off + len(chunk) >= len(tail)
            logits = self._prefill_span(
                chunk, start_pos=st["shared_len"] + off,
                table_pages=list(st["row"][: st["n_owned"]]),
                want_logits=last and not st["resuming"],
            )
            st["off"] = off + len(chunk)
            if last:
                del self.prefilling[slot]
                self.tables[slot] = st["row"]
                self._activate(slot, st["req"], logits, st["resuming"], st["total_len"])

    def _retire(self, req: _PagedRequest):
        slot = req.slot
        # shared pages were ref-bumped at admit; owned pages drop to free
        self._release(self.tables[slot, : self.n_owned[slot]])
        self.tables[slot] = 0
        self.n_owned[slot] = 0
        self.n_shared[slot] = 0
        self.slot_req[slot] = None
        req.slot = None

    def _maybe_finish(self, req: _PagedRequest):
        hit_eos = self.eos_id is not None and req.tokens and req.tokens[-1] == self.eos_id
        out_of_room = req.slot is not None and self.pos[req.slot] >= self.maxP * self.page - 1
        if len(req.tokens) >= req.max_new_tokens or hit_eos or out_of_room:
            req.done = True
            if req.slot is not None:
                self._retire(req)

    def _ensure_capacity(self) -> bool:
        """Make sure every active slot has a page for its next write position.
        Returns False if the pool is exhausted (caller should retire/wait)."""
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            needed = int(self.pos[slot]) // self.page
            if needed >= self.n_owned[slot]:
                got = self._alloc(1)
                if got is None:
                    return False
                self.tables[slot, needed] = got[0]
                self.n_owned[slot] = needed + 1
        return True

    # -- stepping ----------------------------------------------------------
    def _decoding(self) -> List[_PagedRequest]:
        return [
            r for slot, r in enumerate(self.slot_req)
            if r is not None and slot not in self.prefilling
        ]

    def _preempt_until_capacity(self) -> List[_PagedRequest]:
        """Admit waiting requests, advance in-progress chunked prefills by one chunk
        each, and make room for the next write of every decoding slot; returns the
        decoding requests (empty: nothing decodes this step)."""
        self._admit()
        self._advance_prefills()
        while not self._ensure_capacity():
            # Out of pages mid-decode: preempt the longest request (free its pages,
            # requeue at the head; FIFO admission makes it wait for capacity instead
            # of stealing it back). A request preempted repeatedly (a pathologically
            # small pool) is truncated.
            active = self._decoding()
            if not active:
                return []
            victim = max(active, key=lambda r: self.pos[r.slot])
            self._retire(victim)
            victim.preempts += 1
            self._preempts += 1
            if victim.preempts > 3 or not victim.tokens:
                victim.done = True
            else:
                self.queue.insert(0, victim)
        return self._decoding()

    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit waiting requests, advance in-progress chunked prefills by one chunk
        each, then run one batched paged decode step; returns ``[(req_id, token,
        done)]`` for the slots that decoded."""
        active = self._preempt_until_capacity()
        if not active:
            return []
        # attend width bucket: pages needed by the longest active slot
        max_pages = max(int(self.pos[r.slot]) // self.page + 1 for r in active)
        ap = min(bucket_length(max_pages, minimum=1), self.maxP)
        tables = np.ascontiguousarray(self.tables[:, :ap])
        if self.mesh is None:
            if self.decode_step is None:
                body = functools.partial(
                    paged_decode_and_sample, self.params, self.pool, self.config,
                    self.quantized, self.attn_chunk, self.device, self.generator)
                self.decode_step = PagedStep(self.device, body, (self.B,), capture=self._capture,
                                             generator=self.generator, pool=self._graph_pool)
            # B int32s back: the only device-to-host transfer per step
            nxt = self.decode_step.run((self.top_k, self.top_p), toks=self.cur, pos=self.pos,
                                       tables=tables, temps=self.temps)
        else:
            logits = self._forward(self.cur[:, None], self.pos[:, None], tables)
            nxt = sample_next_token(logits[:, 0], torch.from_numpy(self.temps.copy()),
                                    self.top_k, self.top_p, self.generator).cpu().numpy()
        emitted = []
        for slot, req in enumerate(self.slot_req):
            if req is None or slot in self.prefilling:
                continue
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self.pos[slot] += 1
            self.cur[slot] = tok
            self._maybe_finish(req)
            if req.done:
                self._completed += 1
            emitted.append((req.req_id, tok, req.done))
        self._steps += 1
        self._tokens_out += len(emitted)
        return emitted

    def stats(self) -> Dict[str, float]:
        """Engine counters and live pool state (host-side, no device sync)."""
        used = int(self.n_pages - 1 - len(self.free))
        return {
            "steps": self._steps,
            "tokens_out": self._tokens_out,
            "prefill_tokens": self._prefill_tokens,
            "completed_requests": self._completed,
            "preempts": self._preempts,
            "queued": len(self.queue),
            "active_slots": len(self._decoding()),
            "prefilling_slots": len(self.prefilling),
            "pages_used": used,
            "pages_total": self.n_pages - 1,
            "page_utilization": used / max(self.n_pages - 1, 1),
            "kv_token_budget_free": self.free_token_budget(),
        }

    def run(
        self,
        requests: List[Tuple[np.ndarray, int]],
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        prefix_id: Optional[int] = None,
    ) -> Dict[int, np.ndarray]:
        """Submit (prompt, max_new_tokens) pairs and run to completion; returns
        {req_id: prompt + generated} (the prompt excludes any shared prefix)."""
        reqs_by_id: Dict[int, _PagedRequest] = {}
        for prompt, mnt in requests:
            rid = self.add_request(prompt, mnt, temperature=temperature, top_k=top_k,
                                   top_p=top_p, prefix_id=prefix_id)
            reqs_by_id[rid] = self.queue[-1]
        finished: Dict[int, np.ndarray] = {}
        while len(finished) < len(reqs_by_id):
            self.step()
            for rid, req in reqs_by_id.items():
                if req.done and rid not in finished:
                    finished[rid] = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
        return finished
