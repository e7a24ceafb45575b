"""Tree-structured speculative decoding in the paged serving engine (counterpart of
`lit_llama_ja_tpu/infer/tree_spec.py`; SpecInfer/Medusa style).

Instead of one draft chain of K tokens per slot, the draft proposes a static TREE of
candidates (branching ``(4, 2, 2)``: 4 children of the current token, each with 2
children, each with 2). The target verifies every tree node in one batched forward
with a tree mask (a node attends to the committed cache and its own ancestors), and a
per-slot recursive rejection walk (SpecInfer's multi-round speculative sampling) picks
a root-to-node path whose tokens follow the target distribution exactly: greedy output
is the target-only engine's.

Siblings share a cache position, so tree tokens cannot be written into the pool during
the forward: `tree_forward` writes nothing, attends to the gathered pages (masked below
the committed length) and to the tree's fresh k/v through the ancestor mask, and
returns each layer's k/v. After the walk `_path_writes` commits only the accepted
path's k/v (rejected depths and idle slots go to the trash page). The draft expands the
tree level by level with the same cache-free forward, and a last full-tree draft forward
gives its k/v for the same path commit, so both pools are complete below ``pos`` at the
start of every round.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.paged import (
    PagePool,
    _gathered,
    _inputs,
    _is_int4,
    _masked_softmax,
    _rope_table,
    commit_writes,
)
from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine, _dist_batch
from lit_llama_ja_tpu_torch.infer.speculative import _draw
from lit_llama_ja_tpu_torch.models.llama import (
    _qkv,
    apply_linear,
    block_config,
    layer_params,
    lm_head,
    mlp_block,
)
from lit_llama_ja_tpu_torch.ops.attention import int4_scores, int4_values, quantize_kv, quantize_kv4
from lit_llama_ja_tpu_torch.ops.norms import rmsnorm


def tree_topology(branching: Tuple[int, ...]):
    """Node arrays of the static candidate tree. Node 0 is the root (the committed
    token ``cur``); a level-``d`` node sits at cache position ``pos + d``. Returns
    numpy arrays: parents (NT,), depths (NT,), the self-inclusive ancestor mask
    (NT, NT), the children table (NT, c_max) (-1 padded), the node indices of each
    level and each node's rank among its siblings."""
    assert len(branching) >= 1 and all(b >= 1 for b in branching)
    parents, depths, ranks, levels, prev = [-1], [0], [0], [[0]], [0]
    for b in branching:
        new = []
        for p in prev:
            for r in range(b):
                new.append(len(parents))
                parents.append(p)
                depths.append(depths[p] + 1)
                ranks.append(r)
        levels.append(new)
        prev = new
    NT = len(parents)
    anc = np.zeros((NT, NT), bool)
    for i in range(NT):
        j = i
        while j != -1:
            anc[i, j] = True
            j = parents[j]
    c_max = max(branching)
    children = -np.ones((NT, c_max), np.int32)
    fill = np.zeros(NT, np.int32)
    for i in range(1, NT):
        p = parents[i]
        children[p, fill[p]] = i
        fill[p] += 1
    return {
        "parents": np.asarray(parents, np.int32),
        "depths": np.asarray(depths, np.int32),
        "anc": anc,
        "children": children,
        "levels": [np.asarray(lv, np.int32) for lv in levels],
        "ranks": np.asarray(ranks, np.int32),
        "n_nodes": NT,
        "depth": len(branching),
        "c_max": c_max,
    }


class TreeConsts:
    """`tree_topology`'s arrays of one branching on the device, built once (an engine
    builds them at its start), so that a round copies nothing from the host: the depths
    (NT,), the ancestor mask (NT, NT), the children table (NT, c_max), each level's node
    indices and each level's new nodes' sibling ranks, int64 but the mask. ``topo`` keeps
    the numpy arrays."""

    def __init__(self, branching: Tuple[int, ...], device):
        topo = self.topo = tree_topology(branching)
        self.branching = tuple(branching)

        def put(a, dtype=torch.long):
            return torch.as_tensor(a, device=device).to(dtype)

        self.depths = put(topo["depths"])
        self.anc = put(topo["anc"], torch.bool)
        self.children = put(topo["children"])
        self.levels = [put(lv) for lv in topo["levels"]]
        self.ranks = [put(topo["ranks"][lv]) for lv in topo["levels"]]


def _tree_attention(q, gath, fk, fv, pos_base, tmask, quantized):
    """Attention of W tree-node queries against [paged cache | fresh tree k/v].

    q, fk, fv: (B, nh, W, hd); gath: page-cache views (B, nh, S, ...); pos_base: (B,)
    committed length (cache columns at or past it hold stale writes and are masked);
    tmask: (W, W) ancestor mask. One softmax over the concatenated columns; the fresh
    side is never quantized."""
    B, nh, W, hd = q.shape
    S = gath["k"].shape[2]
    scale = 1.0 / (hd**0.5)
    cmask = (torch.arange(S, device=q.device)[None, :] < pos_base[:, None].long())
    cmask = cmask[:, None, None, :].expand(B, 1, W, S)
    mask = torch.cat([cmask, tmask[None, None].expand(B, 1, W, W)], dim=-1)
    att_t = torch.einsum("bhqd,bhsd->bhqs", q, fk.to(q.dtype))
    if quantized:
        if _is_int4(gath):
            att_c = int4_scores(q, gath["k"])
        else:
            att_c = torch.einsum("bhqd,bhsd->bhqs", q, gath["k"].to(q.dtype))
        att_c = att_c * gath["k_scale"][:, :, None, :].float()
        att = _masked_softmax(torch.cat([att_c, att_t.to(att_c.dtype)], -1) * scale, mask)
        ac = (att[..., :S] * gath["v_scale"][:, :, None, :]).to(q.dtype)
        at = att[..., S:].to(q.dtype)
        y_c = (int4_values(ac, gath["v"]) if _is_int4(gath)
               else torch.einsum("bhqs,bhsd->bhqd", ac, gath["v"].to(q.dtype)))
        return y_c + torch.einsum("bhqs,bhsd->bhqd", at, fv.to(q.dtype))
    att_c = torch.einsum("bhqd,bhsd->bhqs", q, gath["k"].to(q.dtype))
    att = _masked_softmax((torch.cat([att_c, att_t], -1) * scale).float(), mask).to(q.dtype)
    return (torch.einsum("bhqs,bhsd->bhqd", att[..., :S], gath["v"].to(q.dtype))
            + torch.einsum("bhqs,bhsd->bhqd", att[..., S:], fv.to(q.dtype)))


def tree_block_chain(blocks, pool: PagePool, x, pos, tables, config: LLaMAConfig,
                     depths: np.ndarray, tmask: np.ndarray, quantized, mesh=None):
    """The cache-write-free transformer blocks of `tree_forward` (between the embedding
    and the final norm); the ``blocks`` and ``pool`` leading L axis may be any
    contiguous layer slice (a pipeline stage's). x: (B, W, D); pos: (B,) committed
    length, node i at ``pos + depths[i]``. ``mesh``: this rank's slices and heads, as in
    `infer/paged.paged_block_chain`. Returns ``(x, ks, vs)`` with ks, vs (L, B, W, nh,
    hd), nh this rank's heads."""
    B, W = x.shape[:2]
    page = pool["k"].shape[3]
    config = block_config(config, mesh)
    node_pos = pos[:, None].long() + torch.as_tensor(depths, device=x.device).long()[None]
    rope_len = max(config.block_size, tables.shape[1] * page)
    rope_t = _rope_table(rope_len, config.head_dim, config.rope_base, x.device)[
        node_pos.clamp(0, rope_len - 1)]  # (B, W, hd/2, 2)
    tmask_t = torch.as_tensor(tmask, device=x.device)
    L = blocks["rms_1"]["scale"].shape[0]
    ks, vs = [], []
    for l in range(L):
        bp = layer_params(blocks, l, mesh)
        q, k, v = _qkv(bp["attn"], rmsnorm(x, bp["rms_1"]["scale"], config.norm_eps),
                       config.n_head, rope_t)  # (B, nh, W, hd)
        gath = _gathered({key: val[l] for key, val in pool.items()}, tables)
        y = _tree_attention(q, gath, k, v, pos, tmask_t, quantized)
        x = x + apply_linear(bp["attn"]["c_proj"], y.transpose(1, 2).reshape(B, W, -1))
        x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["rms_2"]["scale"], config.norm_eps))
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    return x, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def tree_forward(params, toks, pos, tables, pool: PagePool, config: LLaMAConfig,
                 depths: np.ndarray, tmask: np.ndarray, quantized, device="cuda", mesh=None):
    """Cache-write-free forward over W tree nodes (toks (B, W), node 0 = cur). Returns
    ``(logits (B, W, V), ks, vs)`` with ks, vs (L, B, W, nh, hd) for `_path_writes`.
    ``mesh``: this rank's slices, a pool of this rank's heads; the logits come back
    whole."""
    x, pos, tables = _inputs(params, toks, pos, tables, device, mesh)
    x, ks, vs = tree_block_chain(params["blocks"], pool, x, pos, tables, config, depths, tmask,
                                 quantized, mesh)
    x = rmsnorm(x, params["ln_f"]["scale"], config.norm_eps)
    return lm_head(params, x, mesh), ks, vs


def _path_writes(ks, vs, path, keep, pos, tables, page, quantized):
    """The commit payload of the accepted path's k/v: path (B, J) node indices
    (path[:, 0] = 0, the root), keep (B, J) (False goes to the trash page 0); depth j
    commits at ``pos + j``. Returns ``(writes, page_idx, offs)`` for `commit_writes`."""
    B, J = path.shape
    positions = pos[:, None].long() + torch.arange(J, device=pos.device)[None]
    pg = tables.gather(1, torch.div(positions, page, rounding_mode="floor")
                       .clamp(0, tables.shape[1] - 1))
    page_idx = torch.where(keep, pg, torch.zeros_like(pg))
    offs = positions % page
    bar = torch.arange(B, device=pos.device)[:, None]
    selk, selv = ks[:, bar, path], vs[:, bar, path]  # (L, B, J, nh, hd)
    if quantized == "int4":
        kq, ksc, vq, vsc = quantize_kv4(selk, selv)
    elif quantized:
        kq, ksc, vq, vsc = quantize_kv(selk, selv)
    else:  # commit_writes casts to the pool's dtype
        return {"k": selk, "v": selv}, page_idx, offs
    return {"k": kq, "v": vq, "k_scale": ksc[..., 0], "v_scale": vsc[..., 0]}, page_idx, offs


def tree_accept_walk(p_all, q_all, toks, branching: Tuple[int, ...], generator, temps,
                     consts: Optional[TreeConsts] = None):
    """Walk the tree from the root. At each node try its children in order: accept
    child token x with probability min(1, r(x) / q(x)); on a rejection fold the draft
    mass out of the residual, r <- norm(max(r - q, 0)). On a fully rejected level (or
    past a leaf) emit one token from r and stop. The output distribution is the
    target's (SpecInfer, algorithm 2; i.i.d. siblings); greedy (one-hot) dists reduce
    to exact argmax matching.

    p_all: (B, NT, V) target dists per node; q_all: (B, NT, V) draft dists (valid at
    non-leaf nodes); toks: (B, NT); ``consts``: the branching's `TreeConsts` (built here
    without). Returns ``(tokens (B, D+1), n_out (B,), path (B, D+1) node indices,
    n_acc (B,))``."""
    del temps
    if consts is None:
        consts = TreeConsts(branching, p_all.device)
    D, c_max = consts.topo["depth"], consts.topo["c_max"]
    B = p_all.shape[0]
    dev = p_all.device
    children = consts.children
    bar = torch.arange(B, device=dev)
    toks = toks.long()
    r = p_all[:, 0]  # the residual starts at the target's root dist
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(B, dtype=torch.long, device=dev)
    path = torch.zeros((B, D + 1), dtype=torch.long, device=dev)
    out = torch.zeros((B, D + 1), dtype=torch.long, device=dev)
    for d in range(1, D + 1):
        q_par = q_all[bar, cur]  # (B, V) the dist the children were drawn from
        accepted = torch.zeros(B, dtype=torch.bool, device=dev)
        nxt = torch.zeros(B, dtype=torch.long, device=dev)
        for ci in range(c_max):
            child = children[cur, ci]
            valid = alive & ~accepted & (child >= 0)
            childc = child.clamp(min=0)
            x = toks[bar, childc]
            u = torch.rand(B, generator=generator, device=dev)
            acc = valid & (u < r[bar, x] / torch.clamp(q_par[bar, x], min=1e-30))
            rej = valid & ~acc
            rnew = torch.clamp(r - q_par, min=0.0)
            rsum = rnew.sum(-1, keepdim=True)
            rnew = torch.where(rsum > 1e-30, rnew / torch.clamp(rsum, min=1e-30), r)
            r = torch.where(rej[:, None], rnew, r)
            accepted = accepted | acc
            nxt = torch.where(acc, childc, nxt)
        cur = torch.where(accepted, nxt, cur)
        n_acc = n_acc + accepted.long()
        path[:, d] = torch.where(accepted, nxt, torch.zeros_like(nxt))
        out[:, d - 1] = toks[bar, cur]
        r = torch.where(accepted[:, None], p_all[bar, cur], r)
        alive = alive & accepted
    out[bar, n_acc] = _draw(r, generator)
    return out, n_acc + 1, path, n_acc


def _tree_draft_propose(dparams, cur, pos, tables, dpool: PagePool, dcfg: LLaMAConfig,
                        consts: TreeConsts, temps, top_k, top_p, generator, device):
    """The draft side of a tree round: expand the tree level by level with cache-free
    forwards over the partial tree, then one full-tree forward for the draft's k/v.
    Returns ``(toks (B, NT), q_all (B, NT, V), dks, dvs (L, B, NT, nh, hd))``."""
    topo, branching = consts.topo, consts.branching
    NT, D = topo["n_nodes"], topo["depth"]
    B = cur.shape[0]
    V = dcfg.padded_vocab_size
    toks = torch.zeros((B, NT), dtype=torch.long, device=cur.device)
    toks[:, 0] = cur.long()
    q_all = torch.zeros((B, NT, V), dtype=torch.float32, device=cur.device)
    for d in range(D):
        W = int(topo["levels"][d][-1]) + 1  # nodes 0 .. the end of level d
        logits, _, _ = tree_forward(dparams, toks[:, :W], pos, tables, dpool, dcfg,
                                    consts.depths[:W], consts.anc[:W, :W], False, device)
        par_idx = consts.levels[d]
        n_par, b = len(par_idx), branching[d]
        par_logits = logits[:, par_idx]  # (B, n_par, V)
        dists = _dist_batch(par_logits.reshape(B * n_par, V), temps.repeat_interleave(n_par),
                            top_k, top_p).reshape(B, n_par, V)
        q_all[:, par_idx] = dists
        new_idx = consts.levels[d + 1]
        # i.i.d. draws from each parent's dist (temperature > 0), or the draft's top-b
        # tokens (greedy, distinct); new nodes are parent-major: node m belongs to
        # parent m // b at sibling rank m % b
        sampled = _draw(dists.repeat_interleave(b, dim=1), generator)
        top_toks = torch.topk(par_logits, b, dim=-1).indices  # (B, n_par, b)
        ranks = consts.ranks[d + 1]
        parent_of = torch.arange(n_par, device=cur.device).repeat_interleave(b)
        greedy = top_toks[:, parent_of, ranks]
        toks[:, new_idx] = torch.where((temps > 0)[:, None], sampled, greedy)
    _, dks, dvs = tree_forward(dparams, toks, pos, tables, dpool, dcfg, consts.depths,
                               consts.anc, False, device)
    return toks, q_all, dks, dvs


def _tree_spec_round(tparams, dparams, cur, pos, tpool, dpool, tables, generator, temps, tcfg,
                     dcfg, branching, quantized, top_k, top_p, device, mesh=None, verify=None,
                     consts: Optional[TreeConsts] = None):
    """One batched tree round: draft expansion, one target forward over every node,
    the walk, then the accepted path committed into both pools in place. ``mesh``: the
    target's (this rank's slices and heads); the draft runs whole. ``verify(tparams,
    toks (B, NT), pos (B,), tables, tpool) -> (logits, ks, vs)`` is the target's
    forward, the pool only read: `tree_forward` on ``mesh`` by default, `parallel/
    pp_spec.make_pp_tree_verify` on a pipeline (ks, vs then of this stage's layers, the
    layers of its pool). ``consts``: the branching's `TreeConsts` (built here without).
    Returns ``(tokens (B, D+1), n_out (B,))``."""
    if consts is None:
        consts = TreeConsts(branching, cur.device)
    NT, D = consts.topo["n_nodes"], consts.topo["depth"]
    B = cur.shape[0]
    if verify is None:
        verify = functools.partial(tree_forward, config=tcfg, depths=consts.depths,
                                   tmask=consts.anc, quantized=quantized, device=device,
                                   mesh=mesh)
    toks, q_all, dks, dvs = _tree_draft_propose(dparams, cur, pos, tables, dpool, dcfg, consts,
                                                temps, top_k, top_p, generator, device)
    tlogits, tks, tvs = verify(tparams, toks, pos, tables, tpool)
    TV = tlogits.shape[-1]
    p_all = _dist_batch(tlogits.reshape(B * NT, TV), temps.repeat_interleave(NT), top_k,
                        top_p).reshape(B, NT, TV)
    tokens, n_out, path, n_acc = tree_accept_walk(p_all, q_all, toks, branching, generator,
                                                  temps, consts)
    keep = torch.arange(D + 1, device=cur.device)[None, :] <= n_acc[:, None]
    page = dpool["k"].shape[3]
    commit_writes(tpool, *_path_writes(tks, tvs, path, keep, pos, tables, page, quantized))
    commit_writes(dpool, *_path_writes(dks, dvs, path, keep, pos, tables, page, False))
    return tokens, n_out


def tree_spec_body(tparams, dparams, tpool, dpool, generator, tcfg, dcfg, quantized, device,
                   consts: TreeConsts, top_k, top_p, *, cur, pos, tables, temps, out) -> None:
    """`_tree_spec_round` (the JAX package's `_tree_spec_round`) over
    `infer/decode_graph.PagedStep`'s device buffers and the engine's `TreeConsts`: the
    round's tokens go to ``out[:, :D+1]``, its counts to ``out[:, -1]``. It reads
    nothing back to the host."""
    tokens, n_out = _tree_spec_round(tparams, dparams, cur, pos, tpool, dpool, tables,
                                     generator, temps, tcfg, dcfg, consts.branching, quantized,
                                     top_k, top_p, device, consts=consts)
    out[:, :tokens.shape[1]].copy_(tokens)
    out[:, -1].copy_(n_out)


class TreeSpeculativePagedEngine(SpeculativePagedEngine):
    """Paged continuous-batching engine whose decode step is a batched TREE speculative
    round: up to ``len(tree) + 1`` tokens per slot per step, with ``tree[d]``
    candidates at level d. ``tree=(k,)`` is multi-sample speculation of depth 1;
    ``tree=(1, 1, ...)`` is the chain engine's lookahead. ``mesh`` and ``pp_mesh`` as
    on `SpeculativePagedEngine`: on a pipeline the target verifies through `parallel/
    pp_spec.make_pp_tree_verify`, and each stage commits the accepted path into its own
    layers' pool."""

    def __init__(self, params, config, *, tree: Tuple[int, ...] = (4, 2, 2), **kwargs):
        tree = tuple(int(b) for b in tree)
        super().__init__(params, config, draft_k=len(tree), **kwargs)
        self.tree = tree
        self.tree_consts = TreeConsts(tree, self.device)

    def _pp_verify(self):
        if self.pp_mesh is None:
            return None
        from lit_llama_ja_tpu_torch.parallel.pp_spec import make_pp_tree_verify

        return make_pp_tree_verify(self.config, self.pp_mesh, branching=self.tree,
                                   n_micro=self.pp_microbatches, quantized=self.quantized,
                                   device=self.device)

    def step(self) -> List[Tuple[int, int, bool]]:
        active = self._preempt_until_capacity()
        if not active:
            return []
        if self.mesh is None and self.pp_mesh is None:
            body = functools.partial(tree_spec_body, self.params, self.dparams, self.pool,
                                     self.dpool, self.generator, self.config, self.dcfg,
                                     self.quantized, self.device, self.tree_consts)
            tables = self._round_tables(active)
            tokens, n_out = self._staged_round(body, (self.top_k, self.top_p), cur=self.cur,
                                               pos=self.pos, tables=tables, temps=self.temps)
        else:
            cur, pos, tables, temps = self._device_state(active)
            tokens, n_out = _tree_spec_round(
                self.params, self.dparams, cur, pos, self.pool, self.dpool, tables,
                self.generator, temps, self.config, self.dcfg, self.tree, self.quantized,
                self.top_k, self.top_p, self.device, self.mesh, self._pp_verify(),
                consts=self.tree_consts,
            )
            tokens, n_out = tokens.cpu().numpy(), n_out.cpu().numpy()
        self._record_round(active, n_out)
        return self._emit(tokens, n_out, track_prev=False)
