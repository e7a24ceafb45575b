"""Speculative serving over a pipeline (counterpart of `lit_llama_ja_tpu/parallel/pp_spec.py`).

Two serving scalers composed: the layer pipeline of `parallel/pp_decode.py` and the
batched speculation of `infer/spec_serving.py` and `infer/tree_spec.py`.

* The DRAFT is small by construction: every stage holds it whole, with a whole pool of
  its own, and runs it alike (the same inputs, no communication).
* The TARGET's verify is the wavefront of `pp_decode.make_pp_span_forward` at the
  verify's width: ``K + 1`` tokens a slot for a chain, the tree's ``NT`` nodes for a
  tree (each stage then runs `infer/tree_spec.tree_block_chain` on its own layers). The
  last stage broadcasts the logits of every column.
* The round itself is the one-device round (`spec_serving._batched_spec_round`,
  `tree_spec._tree_spec_round`) with these verifies as its target forward: the
  rejection chain, the tree walk and the pool bookkeeping run alike on every rank, and
  each stage commits the accepted path into its own layers' pool. The JAX ``key`` is
  the engine's `torch.Generator`: every rank draws the same numbers in the same order
  (an idle tick of the wavefront draws nothing), so the ranks emit the one-device
  engine's tokens.

Nothing is compiled: a verify is a closure, built for each step from the step's K.
"""
from __future__ import annotations

from typing import Optional, Tuple

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.spec_serving import _batched_spec_round
from lit_llama_ja_tpu_torch.infer.tree_spec import _tree_spec_round, tree_block_chain, tree_topology
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh
from lit_llama_ja_tpu_torch.parallel.pp_decode import make_pp_span_forward


def make_pp_verify(config: LLaMAConfig, mesh: Mesh, *, T: int, n_micro: int = 1,
                   quantized=False, defer_commit: bool = False, device="cuda"):
    """The pipeline forward over ``(B, T)`` token spans with per-token positions: the
    wavefront at the verify's width. Returns ``verify(params, toks (B, T), pos (B, T),
    tables (B, AP), pool) -> (logits (B, T, V), pool)``, each stage's pool written in
    place; with ``defer_commit`` the pool is only read and ``-> (logits, writes)``, the
    writes' leaves ``(L_local, B, T, ...)`` for `pp_decode.make_pp_commit`."""
    return make_pp_span_forward(config, mesh, T=T, n_micro=n_micro, quantized=quantized,
                                defer_commit=defer_commit, device=device)


def make_pp_spec_round(tcfg: LLaMAConfig, dcfg: LLaMAConfig, mesh: Mesh, *, K: int,
                       n_micro: int = 1, quantized=False, device="cuda"):
    """The pipeline chain round: `infer/spec_serving._batched_spec_round` with
    `make_pp_verify` at ``T = K + 1`` as the target's forward. Returns ``round(tparams,
    dparams, prev, cur, pos, tables, tpool, dpool, generator, temps, top_k=None,
    top_p=None) -> (tokens (B, K+1), n_out (B,))``; the draft pool and each stage's
    target pool are written in place, as one device writes them."""
    verify = make_pp_verify(tcfg, mesh, T=K + 1, n_micro=n_micro, quantized=quantized,
                            device=device)

    def spec_round(tparams, dparams, prev, cur, pos, tables, tpool, dpool, generator, temps,
                   top_k: Optional[int] = None, top_p: Optional[float] = None):
        return _batched_spec_round(tparams, dparams, prev, cur, pos, tables, tpool, dpool,
                                   generator, temps, tcfg, dcfg, K, quantized, top_k, top_p,
                                   device, verify=verify)

    return spec_round


def make_pp_tree_verify(config: LLaMAConfig, mesh: Mesh, *, branching: Tuple[int, ...],
                        n_micro: int = 1, quantized=False, device="cuda"):
    """The wavefront over ``(B, NT)`` tree-node spans, each stage running
    `infer/tree_spec.tree_block_chain` on its layers (and its ``tp`` heads). The pool is
    only read (siblings share a position, so no node is written during the forward);
    each stage's fresh k/v come back for the path commit. Returns ``verify(params,
    toks (B, NT), pos (B,), tables (B, AP), pool) -> (logits (B, NT, V), ks, vs)``, ks
    and vs ``(L_local, B, NT, nh, hd)``. The positions are the ``(B,)`` committed
    lengths: the wavefront hands a micro-group its rows of them as they are."""
    topo = tree_topology(branching)

    def chain(blocks, pool, x, pos_m, tab_m):
        h, ks, vs = tree_block_chain(blocks, pool, x, pos_m, tab_m, config, topo["depths"],
                                     topo["anc"], quantized, mesh)
        return h, {"k": ks, "v": vs}

    inner = make_pp_span_forward(config, mesh, T=topo["n_nodes"], n_micro=n_micro,
                                 quantized=quantized, defer_commit=True, chain=chain,
                                 device=device)

    def verify(params, toks, pos, tables, pool):
        logits, writes = inner(params, toks, pos, tables, pool)
        return logits, writes["k"], writes["v"]

    return verify


def make_pp_tree_round(tcfg: LLaMAConfig, dcfg: LLaMAConfig, mesh: Mesh, *,
                       branching: Tuple[int, ...], n_micro: int = 1, quantized=False,
                       device="cuda"):
    """The pipeline tree round: `infer/tree_spec._tree_spec_round` with
    `make_pp_tree_verify` as the target's forward. Returns ``round(tparams, dparams,
    cur, pos, tables, tpool, dpool, generator, temps, top_k=None, top_p=None) ->
    (tokens (B, D+1), n_out (B,))``. The draft commits the accepted path into its whole
    pool on every rank; each stage commits it into its own layers' target pool, with the
    same pages and offsets on every rank."""
    verify = make_pp_tree_verify(tcfg, mesh, branching=branching, n_micro=n_micro,
                                 quantized=quantized, device=device)

    def tree_round(tparams, dparams, cur, pos, tables, tpool, dpool, generator, temps,
                   top_k: Optional[int] = None, top_p: Optional[float] = None):
        return _tree_spec_round(tparams, dparams, cur, pos, tpool, dpool, tables, generator,
                                temps, tcfg, dcfg, branching, quantized, top_k, top_p, device,
                                verify=verify)

    return tree_round
