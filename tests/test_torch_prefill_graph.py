"""The serving engines' prefill spans as device programs (`infer/decode_graph.SpanStep`
over `infer/paged.paged_span_body`, `infer/spec_serving.spec_span_body` and
`infer/serving.stripe_prefill_body`) against the JAX package's jitted spans on the CPU.

On a CUDA device each span body is captured in a CUDA graph, one a (span length, attend
width, ``prefill_attn``) or a prompt bucket, and replayed; on the CPU the same body runs
in a host call, and that is what these tests drive, every body under
`torch_port_helpers.guarded_bodies` (no host read, no tensor built from host data),
counted apart from the decode steps. `PagedEngine` with whole spans, spans over a
registered prefix, chunked spans and a preempted request's re-prefill, over bf16, int8
and int4 pools; the stripe `Engine`; the chain and tree engines, whose one span body
fills the draft's pool too. Tolerance: greedy tokens and `stats()` equal to the JAX
engines'; a span body's pool bytes and last-row logits equal to the eager span's (the
forward `_prefill_span` ran before) bit for bit.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import guarded_bodies, random_tree, to_port  # noqa: F401 (a fixture)

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import paged as jpaged
from lit_llama_ja_tpu.infer import spec_serving as jspec
from lit_llama_ja_tpu.infer import tree_spec as jtree
from lit_llama_ja_tpu.infer.serving import Engine as JEngine

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import paged as tpaged
from lit_llama_ja_tpu_torch.infer import serving as tserving
from lit_llama_ja_tpu_torch.infer.generate import bucket_length
from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine

CFG = dict(block_size=64, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
DCFG = dict(block_size=64, vocab_size=64, n_layer=1, n_head=2, n_embd=16)
# a pool of 11 usable pages of 4 tokens: the longest request is preempted and re-admitted
PAGED = dict(max_batch=2, n_pages=12, page_size=4, prefill_chunk=5)


@pytest.fixture(scope="module")
def models():
    """(jax params, port params) of the target and the draft, from one numpy seed."""
    rng = np.random.default_rng(21)
    out = []
    for cfg in (CFG, DCFG):
        jc = JConfig(**cfg)
        jparams = jax.tree.map(jnp.asarray, random_tree(rng, cfg["n_layer"], cfg["n_embd"],
                                                        jc.n_hidden, jc.padded_vocab_size,
                                                        std=0.3))
        out.append((jparams, to_port(jparams)))
    return out


def _tokens(rng, *lengths):
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32) for n in lengths]


def _recorded_spans(engine):
    """Record every prefill span of a port engine: ``(start, length)``."""
    spans, span = [], engine._prefill_span

    def recorded(toks, start_pos, table_pages, want_logits=True):
        spans.append((int(start_pos), len(toks)))
        return span(toks, start_pos, table_pages, want_logits)

    engine._prefill_span = recorded
    return spans


def _serve(engine, prefix, requests, new):
    """Register ``prefix``, queue ``(prompt, on the prefix)`` requests, step until every
    one is done; the tokens by request id."""
    pid = engine.register_prefix(prefix)
    ids = [engine.add_request(p, new, prefix_id=pid if shared else None)
           for p, shared in requests]
    reqs = {r.req_id: r for r in engine.queue}
    while not all(r.done for r in reqs.values()):
        engine.step()
    return {rid: list(reqs[rid].tokens) for rid in ids}


def _span_keys(engine, spans):
    """The graph keys of ``spans``: (P, attend width, prefill_attn)."""
    keys = set()
    for start, n in spans:
        P = bucket_length(n)
        keys.add((P, bucket_length((start + P + engine.page - 1) // engine.page, minimum=1),
                  start == 0))
    return keys


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_paged_spans_match_jax(models, rng, guarded_bodies, kv):
    """A registered prefix (a whole span from 0), a request over it (a span from past
    0), a 13-token prompt in chunks of 5 and short whole prompts, on a pool that makes
    the engine preempt and re-prefill a request: the JAX engine's greedy tokens and
    stats; every span ran one guarded span body, one graph a key."""
    (jp, tp), _ = models
    prefix = _tokens(rng, 9)[0]
    reqs = [(p, shared) for p, shared in zip(_tokens(rng, 3, 13, 4, 6), (True, False, False,
                                                                         False))]
    jeng = jpaged.PagedEngine(jp, JConfig(**CFG), quantize_kv=kv, **PAGED)
    teng = tpaged.PagedEngine(tp, LLaMAConfig(**CFG), quantize_kv=kv, device="cpu", **PAGED)
    spans = _recorded_spans(teng)
    want = _serve(jeng, prefix, reqs, 12)
    got = _serve(teng, prefix, reqs, 12)
    assert got == want
    assert teng.stats() == jeng.stats()
    assert teng.stats()["preempts"] > 0
    starts = [s for s, _ in spans]
    assert 0 in starts and 8 in starts and 5 in starts  # from 0, past the prefix, a chunk
    assert guarded_bodies["spans"] == len(spans) and guarded_bodies["n"] == teng.stats()["steps"]
    assert set(teng.span_step.graphs) == _span_keys(teng, spans)
    assert all(not g.capture_enabled and g.kind == "span" for g in teng.span_step.graphs.values())


def test_stripe_prefill_matches_jax(models, rng, guarded_bodies):
    """The stripe engine's slot prefill body, one graph a prompt bucket: the JAX engine's
    greedy tokens and stats over an int8 cache, a span a request."""
    (jp, tp), _ = models
    prompts = _tokens(rng, 3, 20, 5, 12)
    jeng = JEngine(jp, JConfig(**CFG), max_batch=2, quantize_kv=True)
    teng = tserving.Engine(tp, LLaMAConfig(**CFG), max_batch=2, quantize_kv="int8",
                           device="cpu")
    want = jeng.run([(p, 6) for p in prompts])
    got = teng.run([(p, 6) for p in prompts])
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats()
    assert guarded_bodies["spans"] == len(prompts)
    assert guarded_bodies["n"] == teng.stats()["steps"]
    assert set(teng.prefill_step.graphs) == {(bucket_length(len(p)),) for p in prompts}


@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_spec_spans_match_jax(models, rng, guarded_bodies, kind):
    """The chain and tree engines' span body (the target's span, then the draft's into
    its own pool): the JAX engines' greedy tokens and stats with a 13-token prompt in
    chunks of 5 (a span from position 0, two past it); one span body a span, the tree's
    inherited from the chain's."""
    (jt, tt), (jd, td) = models
    prompts = _tokens(rng, 13)
    extra = dict(draft_k=3) if kind == "chain" else dict(tree=(2, 2))
    kw = dict(max_batch=2, n_pages=40, page_size=4, prefill_chunk=5, **extra)
    jcls, tcls = ((jspec.SpeculativePagedEngine, SpeculativePagedEngine) if kind == "chain"
                  else (jtree.TreeSpeculativePagedEngine, TreeSpeculativePagedEngine))
    jeng = jcls(jt, JConfig(**CFG), draft_params=jd, draft_config=JConfig(**DCFG), **kw)
    teng = tcls(tt, LLaMAConfig(**CFG), draft_params=td, draft_config=LLaMAConfig(**DCFG),
                device="cpu", **kw)
    spans = _recorded_spans(teng)
    want = jeng.run([(p, 8) for p in prompts])
    got = teng.run([(p, 8) for p in prompts])
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats()
    assert guarded_bodies["spans"] == len(spans) == 3  # 5 + 5 + 3 tokens
    assert guarded_bodies["n"] == teng.stats()["spec_rounds"]
    assert set(teng.span_step.graphs) == _span_keys(teng, spans)
    assert "_prefill_span" not in vars(TreeSpeculativePagedEngine)
    assert "_span_body" not in vars(TreeSpeculativePagedEngine)


def _eager_span(engine, pools, toks, start, pages, want_logits=True):
    """The eager span that `_prefill_span` ran before its body: the forward of the
    padded span on ``pools`` (copies of the engine's target pool and, for a speculative
    engine, its draft pool), the logits of the last real row."""
    padded, pos, table = engine._span_inputs(toks, start, pages)
    logits = tpaged.paged_forward(engine.params, padded, pos, table, pools[0], engine.config,
                                  engine.quantized, attn_chunk=engine.attn_chunk,
                                  prefill_attn=start == 0, device="cpu")[0]
    if len(pools) > 1:
        tpaged.paged_forward(engine.dparams, padded, pos, table, pools[1], engine.dcfg, False,
                             device="cpu")
    return logits[0, len(toks) - 1]


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
@pytest.mark.parametrize("spec", [False, True])
def test_span_body_equals_eager_span(models, rng, guarded_bodies, kv, spec):
    """A span from position 0 over two pages and one that continues it from position 7
    (the plain gather over the pool): each span body's logits and every pool's bytes,
    the draft's too, equal the eager span's."""
    (_, tp), (_, td) = models
    kw = dict(max_batch=2, n_pages=12, page_size=4, quantize_kv=kv, device="cpu")
    if spec:
        engine = SpeculativePagedEngine(tp, LLaMAConfig(**CFG), draft_params=td,
                                        draft_config=LLaMAConfig(**DCFG), **kw)
    else:
        engine = tpaged.PagedEngine(tp, LLaMAConfig(**CFG), **kw)
    pools = [engine.pool] + ([engine.dpool] if spec else [])
    eager = [{k: v.clone() for k, v in pool.items()} for pool in pools]
    a, b = _tokens(rng, 7, 5)
    pages = [3, 5, 8]
    for toks, start in ((a, 0), (b, 7)):
        want = _eager_span(engine, eager, toks, start, pages)
        got = engine._prefill_span(toks, start, pages)
        assert torch.equal(got, want)
        for pool, ref in zip(pools, eager):
            for k in pool:
                assert torch.equal(pool[k], ref[k]), k
    assert guarded_bodies["spans"] == 2
    assert set(engine.span_step.graphs) == _span_keys(engine, [(0, 7), (7, 5)])
    assert len(engine.span_step.graphs) == 2


def test_stripe_body_equals_eager_prefill(models, rng, guarded_bodies):
    """The stripe prefill body over an int8 cache at slot 1 (stale rows of another
    prompt past the span): its logits and the whole cache's bytes equal the eager
    `_prefill_slot`'s on a view of the stripe."""
    (_, tp), _ = models
    engine = tserving.Engine(tp, LLaMAConfig(**CFG), max_batch=2, quantize_kv="int8",
                             device="cpu")
    for k, v in engine.cache.items():
        v.copy_(torch.randint(-5, 6, v.shape, generator=torch.Generator().manual_seed(1))
                .to(v.dtype))
    eager = {k: v.clone() for k, v in engine.cache.items()}
    prompt = _tokens(rng, 6)[0]
    padded = np.zeros((1, bucket_length(6)), np.int64)
    padded[0, :6] = prompt
    want = tserving._prefill_slot(engine.params, torch.from_numpy(padded[0]), 6, eager, 1,
                                  engine.config, "cpu")
    got = engine._prefill_step().run((), toks=padded, slot=np.array([1]), last=np.array([5]))
    assert torch.equal(got, want)
    for k in eager:
        assert torch.equal(engine.cache[k], eager[k]), k
    assert guarded_bodies["spans"] == 1


def test_mesh_engines_keep_eager_spans(models, rng):
    """A pipeline engine (one stage here) runs its spans eagerly: it makes no span step,
    and gives the tokens of the engine that does."""
    from lit_llama_ja_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"dp": 1, "fsdp": 1, "tp": 1, "pp": 1}, rank=0, distributed=False)
    prompts = _tokens(rng, 5, 9)
    kw = dict(max_batch=2, n_pages=16, page_size=4, prefill_chunk=5, device="cpu")
    outs = []
    for extra in ({"pp_mesh": mesh}, {}):
        eng = tpaged.PagedEngine(models[0][1], LLaMAConfig(**CFG), **kw, **extra)
        outs.append(eng.run([(p, 4) for p in prompts]))
        assert (eng.span_step is None) == bool(extra)
    assert sorted(outs[0]) == sorted(outs[1])
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


def test_span_steps_go_with_their_engine(models, rng):
    """No reference cycle holds a span step: a served paged, speculative or stripe
    engine and its span step are freed by the engine's last reference, the cyclic
    collector off (on the card their graphs and the pool they share go with them)."""
    (_, tp), (_, td) = models
    prompt = _tokens(rng, 6)[0]
    kw = dict(max_batch=2, n_pages=16, page_size=4, device="cpu")
    makes = [lambda: tpaged.PagedEngine(tp, LLaMAConfig(**CFG), quantize_kv="int8", **kw),
             lambda: SpeculativePagedEngine(tp, LLaMAConfig(**CFG), draft_params=td,
                                            draft_config=LLaMAConfig(**DCFG), **kw),
             lambda: tserving.Engine(tp, LLaMAConfig(**CFG), max_batch=2, device="cpu")]
    gc.disable()
    try:
        for make in makes:
            eng = make()
            eng.run([(prompt, 3)])
            step = eng.prefill_step if isinstance(eng, tserving.Engine) else eng.span_step
            assert step.graphs
            gone, step_gone = weakref.ref(eng), weakref.ref(step)
            del eng, step
            assert gone() is None and step_gone() is None
    finally:
        gc.enable()
