"""Batched speculative decoding inside the paged serving engine (counterpart of
`lit_llama_ja_tpu/infer/spec_serving.py`).

Each engine step runs one draft-and-verify round for all active slots: the draft model
proposes K tokens per slot (batched, over its own page pool), the target verifies the
K + 1 positions of every slot in one batched forward, and the per-slot rejection chain
emits ``accepted + 1`` tokens with the target's output distribution (greedy output is
the target-only engine's).

The draft pool is a second `init_page_pool` indexed by the SAME page tables (the
positions are the same per slot; only L, nh and hd differ), so the allocator, prefix
sharing, preemption and chunked prefill work unchanged: the draft cache is prefilled
beside the target's, in the same span body (`spec_span_body`, one device program with
the target's span over the same staged tokens, positions and table). The verify
forward writes all K + 1 positions in place (rejected ones stay masked until
overwritten), the write-then-attend form of the JAX package's read-then-commit; the
draft consumes the pair (prev, cur) to fill the one-position hole a fully accepted
round leaves, as in `infer/speculative.py`.

On a ``(1, fsdp, tp)`` mesh (``mesh=``) the target runs sharded, its pool holding this
rank's heads, and the draft runs whole on every rank over a whole pool, as the JAX
package's CLI leaves its draft unsharded. On a pipeline (``pp_mesh=``) the same round
takes `parallel/pp_spec.py`'s verify: the draft replicated, the target's span through
the stages.
Either way every rank draws the same numbers in the same order from the engine's
generator, so the ranks emit the same tokens.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.decode_graph import PagedStep
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.infer.paged import (
    PagedEngine,
    PagePool,
    init_page_pool,
    paged_forward,
    paged_span_body,
)
from lit_llama_ja_tpu_torch.infer.speculative import _draw, _residual
from lit_llama_ja_tpu_torch.ops.sampling import top_p_filter


def _dist_batch(logits: torch.Tensor, temps: torch.Tensor, top_k: Optional[int],
                top_p: Optional[float]) -> torch.Tensor:
    """Per-row sampling distributions (B, V): the temperature array (0 = a point mass
    on the argmax), engine-wide top-k and top-p, in `ops/sampling.sample_token`'s
    filter order."""
    logits = logits.float()
    temps = temps.to(logits.device)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    scaled = logits / safe_t
    if top_k is not None:
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if top_p is not None and top_p < 1.0:
        scaled = top_p_filter(scaled, top_p)
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, -1), logits.shape[-1]).float()
    return torch.where((temps > 0)[:, None], torch.softmax(scaled, dim=-1), greedy)


def _draft_propose(dparams, prev, cur, pos, tables, dpool: PagePool, dcfg: LLaMAConfig, K: int,
                   temps, top_k, top_p, generator, device):
    """Draft K tokens per slot: a (prev, cur) pair forward (idle slots at position 0
    query position 0 twice), then K - 1 batched single steps. prev, cur, pos: (B,)
    int32 on the device. Returns ``(draft_toks (B, K), p_d (B, K, V))``; the draft
    pool is written in place."""
    pair = torch.stack([prev, cur], dim=1)
    pair_pos = torch.stack([torch.clamp(pos - 1, min=0), pos], dim=1)
    logits, _ = paged_forward(dparams, pair, pair_pos, tables, dpool, dcfg, False, device=device)
    p_d = [_dist_batch(logits[:, -1], temps, top_k, top_p)]
    drafts = [_draw(p_d[0], generator).int()]
    for i in range(1, K):
        logits, _ = paged_forward(dparams, drafts[-1][:, None], (pos + i)[:, None], tables, dpool,
                                  dcfg, False, device=device)
        p_d.append(_dist_batch(logits[:, -1], temps, top_k, top_p))
        drafts.append(_draw(p_d[-1], generator).int())
    return torch.stack(drafts, dim=1), torch.stack(p_d, dim=1)


def _accept_chain(tlogits, draft_toks, p_d, temps, top_k, top_p, generator):
    """Per-slot rejection chain over the verified logits ``(B, K+1, V)``; returns
    ``(tokens (B, K+1), n_out (B,))`` (exact target distribution, greedy bitwise)."""
    B, K1, V = tlogits.shape
    K = K1 - 1
    p_t = _dist_batch(tlogits.reshape(B * K1, V), temps.repeat_interleave(K1), top_k,
                      top_p).reshape(B, K1, V)
    u = torch.rand((B, K), generator=generator, device=tlogits.device)
    idx = draft_toks.long()[..., None]
    pt_x = p_t[:, :K].gather(2, idx)[..., 0]
    pd_x = p_d.gather(2, idx)[..., 0]
    accept = u < torch.clamp(pt_x / torch.clamp(pd_x, min=1e-30), max=1.0)
    n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1)  # (B,)
    bar = torch.arange(B, device=tlogits.device)
    p_t_at = p_t[bar, n_acc]
    p_d_at = torch.where((n_acc == K)[:, None], torch.zeros_like(p_t_at),
                         p_d[bar, torch.clamp(n_acc, max=K - 1)])
    final = _draw(_residual(p_t_at, p_d_at), generator).to(draft_toks.dtype)
    tokens = torch.cat([draft_toks, torch.zeros_like(draft_toks[:, :1])], dim=1)
    tokens[bar, n_acc] = final
    return tokens, n_acc + 1


def _batched_spec_round(tparams, dparams, prev, cur, pos, tables, tpool, dpool, generator,
                        temps, tcfg, dcfg, K, quantized, top_k, top_p, device, mesh=None,
                        verify=None):
    """One batched draft-and-verify round; returns ``(tokens (B, K+1), n_out (B,))``.
    Both pools are written in place: the target's K + 1 positions per slot. ``mesh``:
    the target's (this rank's slices and heads); the draft runs whole. ``verify(tparams,
    toks (B, K+1), pos (B, K+1), tables, tpool) -> (logits, tpool)`` is the target's
    forward: `paged_forward` on ``mesh`` by default, `parallel/pp_spec.make_pp_verify`
    on a pipeline."""
    if verify is None:
        verify = functools.partial(paged_forward, config=tcfg, quantized=quantized,
                                   device=device, mesh=mesh)
    draft_toks, p_d = _draft_propose(dparams, prev, cur, pos, tables, dpool, dcfg, K, temps,
                                     top_k, top_p, generator, device)
    tin = torch.cat([cur[:, None], draft_toks], dim=1)  # (B, K+1)
    tpos = pos[:, None] + torch.arange(K + 1, dtype=torch.int32, device=pos.device)[None]
    tlogits, _ = verify(tparams, tin, tpos, tables, tpool)
    return _accept_chain(tlogits, draft_toks, p_d, temps, top_k, top_p, generator)


def batched_spec_body(tparams, dparams, tpool, dpool, generator, tcfg, dcfg, quantized, device,
                      K, top_k, top_p, *, cur, prev, pos, tables, temps, out) -> None:
    """`_batched_spec_round` (the JAX package's `_batched_spec_round`) over
    `infer/decode_graph.PagedStep`'s device buffers: ``cur``, ``prev``, ``pos``,
    ``temps`` ``(B,)``, ``tables`` ``(B, AP)``. The round's tokens go to ``out[:, :K+1]``
    and its counts to ``out[:, -1]``, so one transfer reads both back. It reads nothing
    back to the host."""
    tokens, n_out = _batched_spec_round(tparams, dparams, prev, cur, pos, tables, tpool, dpool,
                                        generator, temps, tcfg, dcfg, K, quantized, top_k,
                                        top_p, device)
    out[:, :K + 1].copy_(tokens)
    out[:, -1].copy_(n_out)


def spec_span_body(tparams, dparams, tpool, dpool, tcfg, dcfg, quantized, attn_chunk, device,
                   prefill_attn, *, toks, pos, tables, last, out) -> None:
    """The target's prefill span (`infer/paged.paged_span_body`), then the draft's over
    the same buffers and into its own pool (the JAX package's draft span: plain
    attention over the gathered pages, from any position), as one body."""
    paged_span_body(tparams, tpool, tcfg, quantized, attn_chunk, device, prefill_attn,
                    toks=toks, pos=pos, tables=tables, last=last, out=out)
    paged_forward(dparams, toks, pos[None], tables, dpool, dcfg, False, device=device)


class SpeculativePagedEngine(PagedEngine):
    """Paged continuous-batching engine whose decode step is a batched speculative
    round: up to ``draft_k + 1`` tokens per slot per step."""

    def __init__(
        self,
        params,
        config: LLaMAConfig,
        *,
        draft_params,
        draft_config: LLaMAConfig,
        draft_k: int = 4,
        adaptive_k: bool = False,
        k_min: int = 1,
        k_ema_decay: float = 0.9,
        k_step_cost: Optional[float] = None,
        **kwargs,
    ):
        """``adaptive_k``: pick K each step from a small ladder in ``[k_min,
        draft_k]`` to maximize the predicted tokens per unit of step cost under the
        measured acceptance: E[tokens] = sum_{i<=K} a^i at the EMA acceptance ``a``,
        cost(K) = 1 + k_step_cost * K. ``k_step_cost=None`` takes the JAX package's
        calibration (0.065 per draft token over an int4 pool, 0.03 otherwise).

        ``mesh`` and ``pp_mesh`` (with ``pp_microbatches``) as on `PagedEngine`, for the
        target; ``draft_params`` are whole on every rank (module docstring)."""
        super().__init__(params, config, **kwargs)
        if k_step_cost is None:
            k_step_cost = 0.065 if self.quantized == "int4" else 0.03
        self.dparams = draft_params
        self.dcfg = draft_config
        self.K = draft_k
        self.K_max = draft_k
        self.adaptive_k = adaptive_k
        self.k_min = max(1, min(k_min, draft_k))
        self.k_ema_decay = k_ema_decay
        self.k_step_cost = k_step_cost
        self._k_ladder = sorted({self.k_min, self.K_max}
                                | {k for k in (1, 2, 4, 8, 16) if self.k_min <= k <= self.K_max})
        # the draft pool shares the page tables; bf16 values (quantizing the small
        # draft's cache buys nothing)
        self.dpool = init_page_pool(draft_config, self.n_pages, self.page, torch.bfloat16,
                                    quantized=False, device=self.device)
        self.prev = np.zeros(self.B, np.int32)
        # acceptance telemetry (see stats())
        self._spec_rounds = 0
        self._drafted = 0
        self._accepted = 0
        self._accept_ema: Optional[float] = None
        self.slot_drafted = np.zeros(self.B, np.int64)
        self.slot_accepted = np.zeros(self.B, np.int64)

    # -- hooks into the base engine's prefill and admission ------------------
    def _span_body(self):
        """Both spans in one body (`spec_span_body`)."""
        return functools.partial(spec_span_body, self.params, self.dparams, self.pool,
                                 self.dpool, self.config, self.dcfg, self.quantized,
                                 self.attn_chunk, self.device)

    def _prefill_span(self, toks, start_pos, table_pages, want_logits=True):
        """Prefill BOTH pools over the same span (the draft sees the same tokens at the
        same positions through the same tables): in one span body without a mesh, the
        draft's span after the target's on a mesh."""
        if len(toks) == 0:
            raise ValueError("speculative engine requires a non-empty prefill span "
                             "(give requests at least one prompt token past the prefix)")
        logits = super()._prefill_span(toks, start_pos, table_pages, want_logits)
        if self.mesh is not None:
            paged_forward(self.dparams, *self._span_inputs(toks, start_pos, table_pages),
                          self.dpool, self.dcfg, False, device=self.device)
        return logits

    def _activate(self, slot, req, logits, resuming, total_len):
        # the token at total_len - 1 is the last prefilled one: `prev` of round 1
        if resuming and len(req.tokens) >= 2:
            self.prev[slot] = req.tokens[-2]
        elif len(req.prompt):
            self.prev[slot] = req.prompt[-1]
        else:  # the prompt is all shared prefix: its tail
            self.prev[slot] = self._prefixes[req.prefix_id][1][-1]
        self.slot_drafted[slot] = 0
        self.slot_accepted[slot] = 0
        super()._activate(slot, req, logits, resuming, total_len)

    def _ensure_capacity(self) -> bool:
        """Reserve pages for the whole speculative horizon (pos .. pos + K)."""
        for slot, req in enumerate(self.slot_req):
            if req is None or slot in self.prefilling:
                continue
            needed = (int(self.pos[slot]) + self.K) // self.page
            while needed >= self.n_owned[slot]:
                got = self._alloc(1)
                if got is None:
                    return False
                self.tables[slot, self.n_owned[slot]] = got[0]
                self.n_owned[slot] += 1
        return True

    # -- stepping ------------------------------------------------------------
    def _round_tables(self, active) -> np.ndarray:
        """The page tables at the attend width that covers every active slot's pos + K."""
        max_pages = max((int(self.pos[r.slot]) + self.K) // self.page + 1 for r in active)
        ap = min(bucket_length(max_pages, minimum=1), self.maxP)
        return np.ascontiguousarray(self.tables[:, :ap])

    def _device_state(self, active):
        """cur, pos, tables (`_round_tables`), temps on the device: a mesh engine's
        eager round."""
        dev = self.device
        return (torch.tensor(self.cur, device=dev), torch.tensor(self.pos, device=dev),
                torch.tensor(self._round_tables(active), device=dev),
                torch.tensor(self.temps, device=dev))

    def _staged_round(self, body, static: tuple, **host):
        """One round through the engine's `PagedStep` (made at its first round, ``out``
        ``(B, K_max + 2)``: the round's tokens, up to K_max + 1 of them, then its counts):
        ``(tokens (B, K_max + 1), n_out (B,))`` on the host."""
        if self.decode_step is None:
            self.decode_step = PagedStep(self.device, body, (self.B, self.K_max + 2),
                                         capture=self._capture, generator=self.generator,
                                         pool=self._graph_pool)
        res = self.decode_step.run(static, **host)
        return res[:, :-1], res[:, -1]

    def _record_round(self, active, n_out):
        """Acceptance telemetry: n_out - 1 of K drafts survived the chain (before any
        budget or eos clamp, so it measures the draft, not request lengths)."""
        round_drafted = round_accepted = 0
        for r in active:
            acc = int(np.clip(n_out[r.slot] - 1, 0, self.K))
            self.slot_drafted[r.slot] += self.K
            self.slot_accepted[r.slot] += acc
            round_drafted += self.K
            round_accepted += acc
        self._spec_rounds += 1
        self._drafted += round_drafted
        self._accepted += round_accepted
        if round_drafted:
            rate = round_accepted / round_drafted
            self._accept_ema = (rate if self._accept_ema is None else
                                self.k_ema_decay * self._accept_ema
                                + (1.0 - self.k_ema_decay) * rate)

    def _emit(self, tokens, n_out, track_prev: bool):
        """Append each decoding slot's emitted tokens (clamped to its budget and cut
        after eos) and advance its position."""
        emitted = []
        for slot, req in enumerate(self.slot_req):
            if req is None or slot in self.prefilling:
                continue
            n = min(int(n_out[slot]), req.max_new_tokens - len(req.tokens))
            toks = tokens[slot, :n].tolist()
            if self.eos_id is not None and self.eos_id in toks:
                n = toks.index(self.eos_id) + 1
                toks = toks[:n]
            req.tokens.extend(toks)
            self.pos[slot] += n
            if track_prev:
                self.prev[slot] = toks[-2] if n >= 2 else int(self.cur[slot])
            self.cur[slot] = toks[-1]
            self._maybe_finish(req)
            if req.done:
                self._completed += 1
            emitted.extend((req.req_id, t, req.done) for t in toks)
        self._steps += 1
        self._tokens_out += len(emitted)
        return emitted

    def step(self) -> List[Tuple[int, int, bool]]:
        active = self._preempt_until_capacity()
        if not active:
            return []
        if self.mesh is None and self.pp_mesh is None:
            body = functools.partial(batched_spec_body, self.params, self.dparams, self.pool,
                                     self.dpool, self.generator, self.config, self.dcfg,
                                     self.quantized, self.device)
            tables = self._round_tables(active)
            tokens, n_out = self._staged_round(
                body, (self.K, self.top_k, self.top_p), cur=self.cur, prev=self.prev,
                pos=self.pos, tables=tables, temps=self.temps)
        else:
            cur, pos, tables, temps = self._device_state(active)
            tokens, n_out = _batched_spec_round(
                self.params, self.dparams, torch.tensor(self.prev, device=self.device), cur,
                pos, tables, self.pool, self.dpool, self.generator, temps, self.config,
                self.dcfg, self.K, self.quantized, self.top_k, self.top_p, self.device,
                self.mesh, self._pp_verify(),
            )
            tokens, n_out = tokens.cpu().numpy(), n_out.cpu().numpy()
        self._record_round(active, n_out)
        if self.adaptive_k and self._accept_ema is not None:
            self.K = self._pick_k(self._accept_ema)
        return self._emit(tokens, n_out, track_prev=True)

    def _pp_verify(self):
        """On a pipeline the target's verify through the stages, built for this step's K
        (nothing is compiled, so adaptive K needs no cache of programs); else None, the
        round's one-device forward."""
        if self.pp_mesh is None:
            return None
        from lit_llama_ja_tpu_torch.parallel.pp_spec import make_pp_verify

        return make_pp_verify(self.config, self.pp_mesh, T=self.K + 1,
                              n_micro=self.pp_microbatches, quantized=self.quantized,
                              device=self.device)

    # -- adaptive K ----------------------------------------------------------
    def _predicted_rate(self, alpha: float, k: int) -> float:
        """Predicted tokens per unit of step cost at chain acceptance ``alpha``:
        E[tokens] = sum_{i=0..k} alpha^i, cost = 1 + k_step_cost * k."""
        return sum(alpha**i for i in range(k + 1)) / (1.0 + self.k_step_cost * k)

    def _pick_k(self, alpha: float) -> int:
        best = max(self._k_ladder, key=lambda k: self._predicted_rate(alpha, k))
        # hysteresis: move only for a predicted gain above 3%
        if best != self.K and self._predicted_rate(alpha, best) > 1.03 * self._predicted_rate(
                alpha, self.K):
            return best
        return self.K

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["spec_rounds"] = self._spec_rounds
        s["tokens_drafted"] = self._drafted
        s["tokens_accepted"] = self._accepted
        s["acceptance_rate"] = self._accepted / max(self._drafted, 1)
        s["acceptance_ema"] = self._accept_ema if self._accept_ema is not None else -1.0
        s["draft_k"] = self.K
        s["tokens_per_round"] = self._tokens_out / max(self._spec_rounds, 1)
        s["per_slot_acceptance"] = [
            (self.slot_accepted[b] / self.slot_drafted[b]) if self.slot_drafted[b] else None
            for b in range(self.B)
        ]
        return s
