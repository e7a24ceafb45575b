"""Continuous-batching engine over per-slot cache stripes (counterpart of
`lit_llama_ja_tpu/infer/serving.py`).

One shared stacked KV cache in serving layout ``(L, max_batch, S, nh, hd)`` (bf16, or
int8 with per-token scales), batch and slot axes leading and adjacent, so each slot's
decode write is one row. Each slot tracks its own position and attention masks per
slot. New requests are admitted into free slots and prefilled one at a time through
`models/llama.forward_with_cache` with ``prefill_attn`` (K2 on CUDA): without a mesh
as one device program a prompt bucket (`stripe_prefill_body` over
`infer/decode_graph.SpanStep`'s buffers, the slot and the prompt length on the device
as in the JAX package's jitted `_prefill_slot`), on a mesh eagerly on a view of the
slot's stripe (`_prefill_slot`). Decode then runs one batched step per token for all
active slots, with per-slot sampling on the device, so only B int32 tokens cross to the host per
step: the JAX package's `_decode_and_sample`, one compiled program, is here one device
program over static buffers of the slots' tokens, positions and temperatures, captured
in a CUDA graph on a CUDA device (`infer/decode_graph.PagedStep`). The decode attention
is plain PyTorch on every device, as it is plain XLA in the JAX package.
`infer/paged.py`'s engine shares one page budget instead.

On a ``(1, fsdp, tp)`` mesh (``mesh=``) every rank runs the engine alike on its
`parallel/specs.shard_params` slices (`parallel/sharded.py`), its cache holding its
``nh / tp`` heads, and samples the same tokens from the same generator state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.core.device import resolve_device
from lit_llama_ja_tpu_torch.infer.decode_graph import PagedStep, SpanStep
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.infer.paged import sample_next_token
from lit_llama_ja_tpu_torch.models.llama import (
    _check_params_device,
    _qkv,
    _rope_table,
    apply_linear,
    block_config,
    embed,
    forward_with_cache,
    init_kv_cache,
    layer_params,
    lm_head,
    mlp_block,
    normalize_kv_mode,
    unstack_layers,
)
from lit_llama_ja_tpu_torch.ops.attention import quantize_kv
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm
from lit_llama_ja_tpu_torch.ops.sampling import sample_token


def _slot_attention(q, cache_l, pos, quantized):
    """q: (B, nh, 1, hd); cache_l leaves (B, S, nh, hd) in serving layout; pos: (B,)
    each slot's current position."""
    S = cache_l["k"].shape[1]
    slot = torch.arange(S, dtype=pos.dtype, device=pos.device)
    mask = (slot[None, :] <= pos[:, None])[:, None, None, :]  # (B, 1, 1, S)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if quantized:
        att = torch.einsum("bhqd,bshd->bhqs", q, cache_l["k"].to(q.dtype))
        att = att * cache_l["k_scale"][..., 0].transpose(1, 2)[:, :, None, :].float()
        att = torch.softmax(torch.where(mask, att * scale, float("-inf")), dim=-1)
        att = att * cache_l["v_scale"][..., 0].transpose(1, 2)[:, :, None, :]
        return torch.einsum("bhqs,bshd->bhqd", att.to(q.dtype), cache_l["v"].to(q.dtype))
    att = torch.einsum("bhqd,bshd->bhqs", q, cache_l["k"].to(q.dtype)) * scale
    att = torch.softmax(torch.where(mask, att.float(), float("-inf")), dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bhqd", att, cache_l["v"].to(q.dtype))


@torch.no_grad()
def _batched_decode_step(params, toks, pos, cache, config: LLaMAConfig, quantized, mesh=None):
    """One decode step for all slots: toks, pos ``(B,)`` on the device; the cache is
    written in place. ``mesh``: this rank's slices, a cache of this rank's heads.
    Returns logits ``(B, V)``, whole."""
    B = toks.shape[0]
    nh = block_config(config, mesh).n_head
    rope = _rope_table(config.block_size, config.head_dim, config.rope_base, toks.device)
    rope_b = rope[pos.long().clamp(0, config.block_size - 1)][:, None]  # (B, 1, hd/2, 2)
    x = embed(params, toks.long(), mesh)[:, None, :]  # (B, 1, D)
    barange = torch.arange(B, device=toks.device)
    pos_l = pos.long()
    for l, cache_l in enumerate(unstack_layers(cache, config.n_layer)):
        bp = layer_params(params["blocks"], l, mesh)
        q, k, v = _qkv(bp["attn"], rmsnorm(x, bp["rms_1"]["scale"], config.norm_eps), nh,
                       rope_b)  # (B, nh, 1, hd)
        if quantized:
            kq, ks, vq, vs = quantize_kv(k, v)
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            writes = {"k": k, "v": v}
        # slot b writes row (b, pos[b]) of its stripe
        for key, val in writes.items():
            cache_l[key][barange, pos_l] = val[:, :, 0].to(cache_l[key].dtype)
        y = _slot_attention(q, cache_l, pos, quantized)
        x = x + apply_linear(bp["attn"]["c_proj"], y.transpose(1, 2).reshape(B, 1, -1))
        x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["rms_2"]["scale"], config.norm_eps))
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh)[:, 0]


def _decode_and_sample(params, toks, pos, cache, generator, temps, config, quantized, top_k,
                       top_p=None, mesh=None):
    """Decode step and per-slot sampling, on the device: returns ``(B,)`` int32."""
    logits = _batched_decode_step(params, toks, pos, cache, config, quantized, mesh)
    return sample_next_token(logits, temps, top_k, top_p, generator)


def stripe_decode_and_sample(params, cache, generator, config, quantized, top_k, top_p, *,
                             toks, pos, temps, out) -> None:
    """`_decode_and_sample` over `infer/decode_graph.PagedStep`'s device buffers
    ``toks``, ``pos``, ``temps`` ``(B,)``, the tokens into ``out`` ``(B,)``. It reads
    nothing back to the host."""
    out.copy_(_decode_and_sample(params, toks, pos, cache, generator, temps, config, quantized,
                                 top_k, top_p))


def _prefill_slot(params, padded_prompt, prompt_len: int, cache, slot: int,
                  config: LLaMAConfig, device, mesh=None):
    """Prefill one slot's stripe from position 0; returns the last prompt token's logits
    ``(V,)``. The model runs on the slot's view ``(L, 1, nh, S, hd)`` of the serving
    layout, so its in-place cache writes land in the stripe."""
    cache_slot = {k: v[:, slot: slot + 1].transpose(2, 3) for k, v in cache.items()}
    P = padded_prompt.shape[0]
    logits, _ = forward_with_cache(params, padded_prompt[None], torch.arange(P), cache_slot,
                                   config, prefill_attn=True, device=device, mesh=mesh)
    return logits[0, prompt_len - 1]


def stripe_prefill_body(params, cache, config, device, *, toks, slot, last, out) -> None:
    """`_prefill_slot` over `infer/decode_graph.SpanStep`'s device buffers: the prompt
    ``toks`` ``(1, P)`` from position 0 into the stripe of the device index ``slot``
    ``(1,)``, the logits of row ``last`` ``(1,)`` (the prompt's last token) into ``out``
    ``(V,)``. The span runs on a cache of its own P rows in the serving layout (the
    attention with ``prefill_attn`` reads no cache), whose k/v then land in the slot's
    first P rows by one ``index_copy_`` a leaf at the device slot: the bytes the eager
    prefill writes. It reads nothing back to the host."""
    P = toks.shape[1]
    span = {k: torch.empty((v.shape[0], 1, P, *v.shape[3:]), dtype=v.dtype, device=v.device)
            for k, v in cache.items()}
    logits, _ = forward_with_cache(params, toks, torch.arange(P, device=toks.device),
                                   {k: v.transpose(2, 3) for k, v in span.items()}, config,
                                   prefill_attn=True, device=device, roll=False)
    for k, v in cache.items():
        v[:, :, :P].index_copy_(1, slot, span[k])
    out.copy_(logits[0].index_select(0, last)[0])


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: Optional[int]
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


class Engine:
    """Continuous-batching inference engine over a fixed slot pool."""

    def __init__(
        self,
        params,
        config: LLaMAConfig,
        *,
        max_batch: int = 8,
        max_seq_length: Optional[int] = None,
        quantize_kv=False,
        eos_id: Optional[int] = None,
        seed: int = 0,
        device="cuda",
        mesh=None,
        cuda_graph: bool = True,
    ):
        """``quantize_kv``: False | True/"int8" (the stripe layout has no int4 form).
        ``seed`` seeds the engine's `torch.Generator` on ``device``. ``mesh``: a ``(dp=1,
        fsdp, tp)`` mesh whose ranks all run the engine alike, ``params`` this rank's
        `parallel/specs.shard_params` slices. Without a mesh the decode step runs over
        static device buffers (`infer/decode_graph.PagedStep`): on a CUDA device one
        CUDA graph a (top-k, top-p), captured at its first step; so does the slot
        prefill (`stripe_prefill_body`), one graph a prompt bucket, in the same memory
        pool. ``cuda_graph=False`` runs the bodies eagerly, which only a comparison of
        the two needs; a mesh runs both eagerly."""
        if mesh is not None and (mesh.shape["dp"] != 1 or mesh.shape.get("pp", 1) != 1):
            raise ValueError("the stripe engine runs on a (1, fsdp, tp) mesh: its slots "
                             "replicate over the ranks and it has no pipeline form")
        self.mesh = mesh
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.params = params
        self.config = config
        self.B = max_batch
        self.S = max_seq_length or config.block_size
        self.quantized = normalize_kv_mode(quantize_kv)
        self.eos_id = eos_id
        if self.quantized == "int4":
            raise ValueError("the stripe engine takes an int8 KV cache at most")
        base = init_kv_cache(block_config(config, mesh), max_batch, self.S,
                             dtype=torch.bfloat16, quantized=self.quantized, device=self.device)
        # serving layout: (L, B, S, nh, hd), see _slot_attention
        self.cache = {k: v.transpose(2, 3).contiguous() for k, v in base.items()}
        del base
        self.pos = np.zeros(max_batch, np.int32)  # next write position per slot
        self.cur = np.zeros(max_batch, np.int32)  # current token per slot
        self.temps = np.zeros(max_batch, np.float32)  # per-slot temperature
        self.top_k: Optional[int] = None  # engine-wide top_k (the first request's)
        self.top_p: Optional[float] = None  # engine-wide top_p (the first request's)
        self.slot_req: List[Optional[_Request]] = [None] * max_batch
        self.queue: List[_Request] = []
        self._next_id = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the buffer-fed step and prefill, made at the first decode step and the first
        # admission of an engine without a mesh; their graphs share one memory pool
        self.decode_step: Optional[PagedStep] = None
        self.prefill_step: Optional[SpanStep] = None
        self._capture = self.device.type == "cuda" and cuda_graph
        self._graph_pool = torch.cuda.graph_pool_handle() if self._capture else None
        self._steps = 0
        self._tokens_out = 0
        self._completed = 0

    # -- request management ------------------------------------------------
    def add_request(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> int:
        if top_p is not None:
            self.top_p = top_p if self.top_p is None else self.top_p
        req = _Request(self._next_id, np.asarray(prompt, np.int32), max_new_tokens,
                       temperature, top_k)
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def _admit(self):
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            T = len(req.prompt)
            if T >= self.S:
                raise ValueError(
                    f"prompt length {T} does not fit the {self.S}-slot cache "
                    "(reference semantics: prompts are capped at block_size)"
                )
            P = min(bucket_length(T), self.S)
            padded = np.zeros((1, P), np.int64)
            padded[0, :T] = req.prompt
            if self.mesh is None:
                logits = self._prefill_step().run((), toks=padded, slot=np.array([slot]),
                                                  last=np.array([T - 1]))
            else:
                logits = _prefill_slot(self.params, torch.from_numpy(padded[0]).to(self.device),
                                       T, self.cache, slot, self.config, self.device, self.mesh)
            tok = int(sample_token(logits, req.temperature, req.top_k, generator=self.generator))
            req.tokens.append(tok)
            req.slot = slot
            self.slot_req[slot] = req
            self.pos[slot] = T
            self.cur[slot] = tok
            self.temps[slot] = req.temperature
            if req.top_k is not None:
                self.top_k = req.top_k if self.top_k is None else self.top_k
            self._maybe_finish(req)

    def _prefill_step(self) -> SpanStep:
        """The engine's `SpanStep` of `stripe_prefill_body`, made at its first use."""
        if self.prefill_step is None:
            body = functools.partial(stripe_prefill_body, self.params, self.cache, self.config,
                                     self.device)
            self.prefill_step = SpanStep(self.device, body, (self.config.padded_vocab_size,),
                                         self.params["wte"]["weight"].dtype,
                                         capture=self._capture, pool=self._graph_pool)
        return self.prefill_step

    def _maybe_finish(self, req: _Request):
        hit_eos = self.eos_id is not None and req.tokens and req.tokens[-1] == self.eos_id
        out_of_room = req.slot is not None and self.pos[req.slot] >= self.S - 1
        if len(req.tokens) >= req.max_new_tokens or hit_eos or out_of_room:
            req.done = True
            if req.slot is not None:
                self.slot_req[req.slot] = None
                req.slot = None

    # -- stepping ----------------------------------------------------------
    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit pending requests, run one batched decode step; returns
        ``[(req_id, new_token, done)]`` for the slots that produced a token."""
        self._admit()
        active = [r for r in self.slot_req if r is not None]
        if not active:
            return []
        # B int32s: the only device-to-host transfer per step
        if self.mesh is None:
            if self.decode_step is None:
                body = functools.partial(stripe_decode_and_sample, self.params, self.cache,
                                         self.generator, self.config, self.quantized)
                self.decode_step = PagedStep(self.device, body, (self.B,), capture=self._capture,
                                             generator=self.generator, pool=self._graph_pool)
            nxt = self.decode_step.run((self.top_k, self.top_p), toks=self.cur, pos=self.pos,
                                       temps=self.temps)
        else:
            nxt = _decode_and_sample(
                self.params, torch.from_numpy(self.cur.copy()).to(self.device),
                torch.from_numpy(self.pos.copy()).to(self.device), self.cache, self.generator,
                torch.from_numpy(self.temps.copy()), self.config, self.quantized, self.top_k,
                self.top_p, self.mesh,
            ).cpu().numpy()
        emitted = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
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
        """Engine counters and live slot state (host-side, no device sync)."""
        active = sum(1 for r in self.slot_req if r is not None)
        return {
            "steps": self._steps,
            "tokens_out": self._tokens_out,
            "completed_requests": self._completed,
            "queued": len(self.queue),
            "active_slots": active,
            "slot_utilization": active / self.B,
        }

    def run(
        self,
        requests: List[Tuple[np.ndarray, int]],
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> Dict[int, np.ndarray]:
        """Submit (prompt, max_new_tokens) pairs and run to completion. Returns
        {req_id: prompt + generated}; requests are remembered at submission (one can
        retire during its admission)."""
        reqs_by_id: Dict[int, _Request] = {}
        for prompt, mnt in requests:
            rid = self.add_request(prompt, mnt, temperature=temperature, top_k=top_k,
                                   top_p=top_p)
            reqs_by_id[rid] = self.queue[-1]
        finished: Dict[int, np.ndarray] = {}
        while len(finished) < len(reqs_by_id):
            self.step()
            for rid, req in reqs_by_id.items():
                if req.done and rid not in finished:
                    finished[rid] = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
        return finished
