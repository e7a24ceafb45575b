"""Pipeline-parallel paged decode (counterpart of `lit_llama_ja_tpu/parallel/pp_decode.py`):
the paged serving engine's forward with the transformer layers, and their slice of the
page pool, split over a ``pp`` axis of ranks. A stage is a process.

Schedule: the B engine slots are split into M micro-groups; at tick ``t`` stage ``s``
runs micro-group ``t − s`` (the GPipe wavefront, M + S − 1 ticks a step). Stage 0
embeds, every stage runs `infer/paged.paged_block_chain` on its own layers (the code
the one-device engine runs; the leading layer axis of the blocks and the pool is the
stage's slice), the last stage projects the logits, and `mesh.broadcast` sends them to
every stage, so that every rank samples the same tokens from the same generator state.
A stage hands its activations on with one `mesh.stage_hop` a tick.

`make_pp_span_forward` is the one wavefront: decode (T = 1) and the prefill of one
``(1, T)`` span (one micro-group, S ticks) are its parameterizations, and the
speculative verifies will be. The JAX package runs every stage at every tick (SPMD)
and points an idle stage's writes at the trash page 0; a process skips its idle ticks
instead, so it writes nothing there and holds no stale buffer that a later tick reads
(a stage reads only what the previous stage sent at the tick before).

The fused route (the default, ``defer_commit=False``) writes each layer's k/v into the
pool in place before attending, as the one-device engine does; the two-dispatch route
(`make_pp_decode_read` and `make_pp_commit`, `make_pp_prefill_read`) keeps the pool
read-only and returns the writes, as `infer/paged.paged_forward_read` and
`commit_writes` do on one device.

With ``tp`` (and ``fsdp``) in the mesh, each stage's blocks run through the port's
tensor-parallel layers (`parallel/sharded.py`) on the stage's ``tp`` group, and the
pool holds the rank's heads: what the JAX package's ``pp_auto_*`` placements leave to
GSPMD. Page tables, the allocator and every other piece of engine bookkeeping are
layer-oblivious and run alike on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.paged import (
    PagePool,
    _inputs,
    commit_writes,
    page_coords,
    paged_block_chain,
    sample_next_token,
)
from lit_llama_ja_tpu_torch.models.llama import lm_head
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, broadcast, stage_hop
from lit_llama_ja_tpu_torch.parallel.pipeline import check_pipeline
from lit_llama_ja_tpu_torch.parallel.specs import P


def pp_pool_specs(pool: PagePool, axis: str = "pp"):
    """Every pool leaf ``(L, n_pages, nh[, page[, hd]])``: the layer axis over ``axis``
    and the heads (head pairs for int4) over ``tp``, which splits nothing where ``tp``
    has one rank."""
    return {key: P(axis, None, "tp") for key in pool}


def shard_pool_pp(pool: PagePool, mesh: Mesh, axis: str = "pp") -> PagePool:
    """This rank's slice of a full pool: its stage's layers and its ``tp`` heads."""
    out = {}
    for key, a in pool.items():
        for dim, ax in ((0, axis), (2, "tp")):
            n, i = mesh.size(ax), mesh.index(ax)
            a = a.narrow(dim, i * (a.shape[dim] // n), a.shape[dim] // n)
        out[key] = a.clone()
    return out


def _head_rows(params, h, config: LLaMAConfig, mesh: Mesh, rows):
    logits = lm_head(params, rmsnorm(h, params["ln_f"]["scale"], config.norm_eps), mesh)
    return logits if rows is None else logits[:, rows]


def make_pp_span_forward(
    config: LLaMAConfig,
    mesh: Mesh,
    params=None,
    pool: Optional[PagePool] = None,
    *,
    T: int,
    n_micro: int = 1,
    quantized=False,
    axis: str = "pp",
    defer_commit: bool = False,
    chain: Optional[Callable] = None,
    attn_chunk: Optional[int] = None,
    prefill_attn: bool = False,
    device="cuda",
):
    """The micro-group wavefront (module docstring). Returns ``inner(params, toks (B, T),
    pos (B, T), tables (B, AP), pool, rows=None)``:

    * fused (``defer_commit=False``): each tick's chain writes the stage's pool in place;
      returns ``(logits (B, T, V), pool)``;
    * two-dispatch (``defer_commit=True``): the pool is only read; the span's k/v of the
      stage's layers come back as ``writes`` (leaves ``(L_local, B, T, ...)``) for
      `make_pp_commit`; returns ``(logits, writes)``.

    ``rows`` (a list of token indices) sends only those columns of the logits to the
    other stages (the last stage projects the whole span, as one device does).
    ``chain(blocks, pool, x (mbs, T, D), pos_m, tab_m)`` runs one stage's layers: ->
    ``(h, pool)`` fused, ``(h, writes)`` deferred; it defaults to `paged_block_chain`
    (with ``attn_chunk`` and ``prefill_attn``, the caller's promise that a span starts
    at position 0 on fresh pages). ``params`` and ``pool`` are the JAX signature's (its
    specs are built from them) and unused."""
    del params, pool
    S, s = check_pipeline(config, mesh, axis), mesh.index(axis)
    M = n_micro
    if chain is None:
        def chain(blocks, pool, x, pos_m, tab_m):
            out = paged_block_chain(blocks, pool, x, pos_m, tab_m, config, quantized,
                                    attn_chunk=attn_chunk, defer_commit=defer_commit,
                                    prefill_attn=prefill_attn, mesh=mesh)
            return out[:2]

    def inner(params, toks, pos, tables, pool, rows: Optional[Sequence[int]] = None):
        B = len(toks)
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} micro-groups")
        mbs = B // M
        emb, pos, tables = _inputs(params, toks, pos, tables, device, mesh, embed=s == 0)
        dtype, dev = params["wte"]["weight"].dtype, pos.device
        template = torch.zeros((mbs, T, config.n_embd), dtype=dtype, device=dev)
        parts, writes, x = [], None, None
        for t in range(M + S - 1):
            m = t - s
            h = None
            if 0 <= m < M:
                sl = slice(m * mbs, (m + 1) * mbs)
                h, out = chain(params["blocks"], pool, emb[sl] if s == 0 else x, pos[sl],
                               tables[sl])
                if not defer_commit:
                    pool = out
                else:
                    if writes is None:
                        writes = {key: w.new_zeros((w.shape[0], B, *w.shape[2:]))
                                  for key, w in out.items()}
                    for key, w in out.items():
                        writes[key][:, sl] = w
                if s == S - 1:
                    parts.append(_head_rows(params, h, config, mesh, rows))
            recv = s > 0 and 0 <= m + 1 < M
            x = stage_hop(h if h is not None and s < S - 1 else None,
                          template if recv else None, mesh, axis)
        R = T if rows is None else len(rows)
        if s == S - 1:  # in the activations' dtype, which the other stages allocate
            logits = torch.cat(parts, dim=0).to(dtype)
        else:
            logits = torch.empty((B, R, config.padded_vocab_size), dtype=dtype, device=dev)
        if R:
            logits = broadcast(logits, mesh, axis, S - 1)
        return logits, (writes if defer_commit else pool)

    return inner


def make_pp_decode_step(config: LLaMAConfig, mesh: Mesh, params=None, pool=None, *,
                        n_micro: int = 1, quantized=False, axis: str = "pp",
                        attn_chunk: Optional[int] = None, device="cuda"):
    """The fused pipeline decode step (the T = 1 wavefront). Returns ``step(params, toks
    (B,), pos (B,), tables (B, AP), pool, generator, temps, top_k=None, top_p=None) ->
    (next_tokens (B,), pool)``, `infer/paged.sample_next_token` on every rank; ``B %
    n_micro == 0``. The JAX signature's ``key`` is a `torch.Generator` here."""
    inner = make_pp_span_forward(config, mesh, T=1, n_micro=n_micro, quantized=quantized,
                                 axis=axis, attn_chunk=attn_chunk, device=device)

    @torch.no_grad()
    def step(params, toks, pos, tables, pool, generator, temps, top_k=None, top_p=None):
        logits, pool = inner(params, torch.as_tensor(toks)[:, None],
                             torch.as_tensor(pos)[:, None], tables, pool)
        return sample_next_token(logits[:, 0], temps, top_k, top_p, generator), pool

    return step


def make_pp_commit(mesh: Mesh, pool=None, axis: str = "pp"):
    """The write half of the two-dispatch route: each stage writes its layers' slice of
    ``writes`` into its pool (`infer/paged.commit_writes`). Returns ``commit(pool,
    writes, page_idx, offs) -> pool``."""
    del mesh, pool, axis
    return commit_writes


def make_pp_decode_read(config: LLaMAConfig, mesh: Mesh, params=None, pool=None, *,
                        n_micro: int = 1, quantized=False, axis: str = "pp",
                        attn_chunk: Optional[int] = None, device="cuda"):
    """The read half of the two-dispatch pipeline decode: the T = 1 wavefront over a
    read-only pool. Returns ``read(params, toks (B,), pos (B,), tables (B, AP), pool,
    generator, temps, top_k=None, top_p=None) -> (next_tokens (B,), writes, page_idx (B,
    1), offs (B, 1))`` for `make_pp_commit`."""
    inner = make_pp_span_forward(config, mesh, T=1, n_micro=n_micro, quantized=quantized,
                                 axis=axis, defer_commit=True, attn_chunk=attn_chunk,
                                 device=device)

    @torch.no_grad()
    def read(params, toks, pos, tables, pool, generator, temps, top_k=None, top_p=None):
        pos2 = torch.as_tensor(pos)[:, None]
        logits, writes = inner(params, torch.as_tensor(toks)[:, None], pos2, tables, pool)
        tables = torch.as_tensor(tables, dtype=torch.int32, device=logits.device)
        page_idx, offs = page_coords(tables, pos2.to(tables), pool["k"].shape[3])
        return (sample_next_token(logits[:, 0], temps, top_k, top_p, generator), writes,
                page_idx, offs)

    return read


def make_pp_prefill(config: LLaMAConfig, mesh: Mesh, params=None, pool=None, *,
                    quantized=False, axis: str = "pp", prefill_attn: bool = False,
                    device="cuda"):
    """The fused pipeline prefill of one ``(1, T)`` span (one micro-group over S ticks).
    Returns ``prefill(params, toks (1, T), pos (1, T), tables (1, AP), pool) -> (logits
    (1, T, V), pool)``, the contract of `infer/paged.paged_forward`."""
    def prefill(params, toks, pos, tables, pool):
        inner = make_pp_span_forward(config, mesh, T=len(toks[0]), quantized=quantized,
                                     axis=axis, prefill_attn=prefill_attn, device=device)
        with torch.no_grad():
            return inner(params, toks, pos, tables, pool)

    return prefill


def make_pp_prefill_read(config: LLaMAConfig, mesh: Mesh, params=None, pool=None, *,
                         quantized=False, axis: str = "pp", prefill_attn: bool = False,
                         device="cuda"):
    """The read half of the two-dispatch pipeline prefill. Returns ``prefill(params, toks
    (1, T), pos (1, T), tables (1, AP), pool) -> (logits (1, T, V), writes, page_idx (1,
    T), offs (1, T))``."""
    def prefill(params, toks, pos, tables, pool):
        inner = make_pp_span_forward(config, mesh, T=len(toks[0]), quantized=quantized,
                                     axis=axis, defer_commit=True, prefill_attn=prefill_attn,
                                     device=device)
        with torch.no_grad():
            logits, writes = inner(params, toks, pos, tables, pool)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=logits.device)
        tables = torch.as_tensor(tables, dtype=torch.int32, device=logits.device)
        return (logits, writes, *page_coords(tables, pos, pool["k"].shape[3]))

    return prefill
