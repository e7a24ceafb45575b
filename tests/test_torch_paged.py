"""The PyTorch port's paged serving path against the JAX package on the CPU: the plain
version of the paged decode-attention kernels (K7, K8) against the Pallas kernels in
interpret mode and the gather path, the page pool, one paged forward over fp, int8
and int4 pools, and `PagedEngine` token for token (greedy) with equal `stats()`.

Inputs come from numpy with a seed and feed both packages. Tolerances: 1e-5 for the
attention function alone (the same f32 math), 1e-4 for logits after a forward (f32
sums taken in other orders over a few layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import paged as jpaged
from lit_llama_ja_tpu.ops.pallas import paged_attention as jpa

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import paged as tpaged
from lit_llama_ja_tpu_torch.ops.cuda import paged_attention as tpa

from torch_port_helpers import quantize_int4_tree, random_tree, to_port

CFG = dict(block_size=64, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
KERNELS = {"paged_decode_attention": (jpa.paged_decode_attention, tpa.paged_decode_attention),
           "paged_decode_attention_db": (jpa.paged_decode_attention_db,
                                         tpa.paged_decode_attention_db)}


def _pages(rng, B=3, nh=4, hd=32, page=8, AP=4):
    """int8 pages with scales, a shuffled non-contiguous table per slot, and a q."""
    P = B * AP + 1
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kp = rng.integers(-127, 128, (P, nh, page, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (P, nh, page, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (P, nh, page)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (P, nh, page)).astype(np.float32)
    tables = (rng.permutation(P - 1)[: B * AP].reshape(B, AP) + 1).astype(np.int32)
    return q, kp, ks, vp, vs, tables


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("hd", [32, 78])
def test_kernel_plain_version_matches_pallas_and_gather(rng, kernel, hd):
    """K7 / K8's plain version against the Pallas kernel (interpret mode) and against
    the JAX gather path, at mixed fill levels: a fresh slot (pos 0), a page edge, a
    full table."""
    args = _pages(rng, hd=hd)
    pos = np.array([0, 15, 31], np.int32)
    jfn, tfn = KERNELS[kernel]
    want = np.asarray(jfn(*map(jnp.asarray, args), jnp.asarray(pos), interpret=True))
    cache_l = dict(zip(("k", "k_scale", "v", "v_scale"), map(jnp.asarray, args[1:5])))
    gath = jpaged._gathered(cache_l, jnp.asarray(args[5]))
    gather = np.asarray(jpaged._paged_attention(jnp.asarray(args[0])[:, :, None], gath,
                                                jnp.asarray(pos)[:, None], True))[:, :, 0]
    before = tfn.launches
    got = tfn(*map(torch.from_numpy, args), torch.from_numpy(pos)).numpy()
    assert tfn.launches == before  # the plain version is not a launch
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, gather, atol=1e-5, rtol=1e-5)


def test_kernel_plain_version_edges(rng):
    """A table wider than the valid pages whose unused entries are the trash page
    holding junk: the junk never reaches the output (exact 0 weights)."""
    q, kp, ks, vp, vs, tables = _pages(rng, B=2, AP=4)
    tables[:, 2:] = 0
    ks[0] = np.nan  # junk in the trash page
    pos = np.array([0, 12], np.int32)
    got = tpa.paged_decode_attention_ref(*map(torch.from_numpy, (q, kp, ks, vp, vs, tables,
                                                                 pos)))
    narrow = tpa.paged_decode_attention_ref(*map(torch.from_numpy, (q, kp, ks, vp, vs,
                                                                    tables[:, :2].copy(), pos)))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, narrow, rtol=0, atol=0)


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_init_page_pool(kv):
    cfg = dict(CFG, n_head=4)
    want = jpaged.init_page_pool(JConfig(**cfg), 5, 8, quantized=kv)
    got = tpaged.init_page_pool(LLaMAConfig(**cfg), 5, 8, quantized=kv, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        np.testing.assert_array_equal(got[key].float().numpy(), np.asarray(want[key], np.float32))


def _random_pool(rng, pool):
    """Random contents for a pool of the leaves, shapes and dtypes of ``pool`` (JAX
    arrays or tensors), as numpy: int8 or uint8 levels, f32 scales, and values that
    bf16 holds exactly for an fp pool."""
    out = {}
    for key, val in pool.items():
        shape, dtype = tuple(val.shape), str(val.dtype)
        if key.endswith("scale"):
            out[key] = rng.uniform(0.005, 0.05, shape).astype(np.float32)
        elif dtype.endswith("uint8"):
            out[key] = rng.integers(0, 256, shape).astype(np.uint8)
        elif dtype.endswith("int8"):
            out[key] = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            out[key] = (rng.standard_normal(shape) * 0.5).astype(jnp.bfloat16).astype(np.float32)
    return out


def _pool_to_port(npool, like):
    return {k: torch.from_numpy(v).to(like[k].dtype) for k, v in npool.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_paged_forward_matches_jax(rng, kv, T, use_kernel, monkeypatch):
    """One write-then-attend forward over a pool with history: a batched decode
    (T = 1, B = 3, each slot at its own position) or a prefill span of 8 tokens from
    position 5; logits at 1e-4 and the pool after the step. The pool's bytes match
    up to one quantization level where the two frameworks' f32 projections land on a
    rounding boundary (ROADMAP.md, queue 3), and bf16 fp entries to one bf16 ulp; a
    flipped level moves the logits, which are then held at 1e-3."""
    jcfg, cfg = JConfig(**CFG), LLaMAConfig(**CFG)
    tree = random_tree(rng, CFG["n_layer"], CFG["n_embd"], jcfg.n_hidden,
                       jcfg.padded_vocab_size, std=0.2)
    jparams = jax.tree.map(jnp.asarray, tree)
    page = 4
    jpool = jpaged.init_page_pool(jcfg, 13, page, quantized=kv)
    npool = _random_pool(rng, jpool)
    if T == 1:
        B, AP = 3, 4
        pos = np.array([[2], [9], [15]], np.int32)
        tables = (rng.permutation(12)[: B * AP].reshape(B, AP) + 1).astype(np.int32)
    else:
        B, AP = 1, 4
        pos = (5 + np.arange(T, dtype=np.int32))[None]
        tables = np.array([[3, 7, 1, 11]], np.int32)
    toks = rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)

    def jax_forward(flag):
        jpool_in = {k: jnp.asarray(v, jpool[k].dtype) for k, v in npool.items()}
        return jpaged.paged_forward(jparams, jnp.asarray(toks), jnp.asarray(pos),
                                    jnp.asarray(tables), jpool_in, jcfg, kv, flag)

    if not (use_kernel and kv == "int8" and T == 1):
        want, jout = jax_forward(use_kernel)
    else:
        # JAX's kernel route hands the Pallas kernel a bf16 q; the port keeps f32 on
        # the CPU, so it is held to JAX's f32 route (which the JAX package's own
        # test holds equal to the kernel route) and to the kernel route within bf16
        orig = jpa.paged_decode_attention
        monkeypatch.setattr(jpa, "paged_decode_attention",
                            lambda *a, **k: orig(*a, interpret=True, **k))
        bf16_route, _ = jax_forward(True)
        want, jout = jax_forward(False)
    tpool = _pool_to_port(npool, tpaged.init_page_pool(cfg, 13, page, quantized=kv,
                                                       device="cpu"))
    got, tout = tpaged.paged_forward(to_port(jparams), toks, pos, tables, tpool, cfg, kv,
                                     use_kernel, device="cpu")
    assert tout is tpool  # written in place
    flipped = False
    for key in tout:
        a, b = tout[key].float().numpy(), np.asarray(jout[key], np.float32)
        if key.endswith("scale"):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        elif kv:
            a, b = a.astype(np.int16), b.astype(np.int16)
            if kv == "int4":  # compare the nibbles
                a = np.stack([a & 15, a >> 4])
                b = np.stack([b & 15, b >> 4])
            d = np.abs(a - b)
            assert d.max() <= 1 and (d != 0).mean() < 0.01
            flipped |= bool(d.any())
        else:
            np.testing.assert_allclose(a, b, rtol=2**-7, atol=1e-6)
    # a level that flipped at a rounding boundary moves the logits by up to ~1e-3
    tol = 1e-3 if flipped else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    if use_kernel and kv == "int8" and T == 1:
        np.testing.assert_allclose(got.numpy(), np.asarray(bf16_route), atol=5e-2)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_paged_forward_read_and_commit_match_jax(rng, kv, T):
    """The deferred route: `paged_forward_read` leaves the pool untouched and
    `commit_writes` lands its writes afterwards; logits and the pool after the commit
    equal JAX's deferred route, and the port's write-then-attend forward within 1e-4
    (the bound the JAX package holds its two routes to)."""
    jcfg, cfg = JConfig(**CFG), LLaMAConfig(**CFG)
    tree = random_tree(rng, CFG["n_layer"], CFG["n_embd"], jcfg.n_hidden,
                       jcfg.padded_vocab_size, std=0.2)
    jparams = jax.tree.map(jnp.asarray, tree)
    page = 4
    jpool = jpaged.init_page_pool(jcfg, 13, page, quantized=kv)
    npool = _random_pool(rng, jpool)
    B = 3 if T == 1 else 1
    pos = (np.array([[2], [9], [15]], np.int32) if T == 1
           else (5 + np.arange(T, dtype=np.int32))[None])
    tables = (rng.permutation(12)[: B * 4].reshape(B, 4) + 1).astype(np.int32)
    toks = rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    jpool_in = {k: jnp.asarray(v, jpool[k].dtype) for k, v in npool.items()}
    want, jw, jpi, jof = jpaged.paged_forward_read(jparams, jnp.asarray(toks), jnp.asarray(pos),
                                                   jnp.asarray(tables), jpool_in, jcfg, kv)
    jout = jpaged.commit_writes(jpool_in, jw, jpi, jof)

    def port_pool():
        return _pool_to_port(npool, tpaged.init_page_pool(cfg, 13, page, quantized=kv,
                                                          device="cpu"))

    tparams = to_port(jparams)
    tpool = port_pool()
    got, w, pi, of = tpaged.paged_forward_read(tparams, toks, pos, tables, tpool, cfg, kv,
                                               device="cpu")
    for key, val in port_pool().items():
        assert torch.equal(tpool[key], val)  # read-only
    tpaged.commit_writes(tpool, w, pi, of)
    flipped = False
    for key in tpool:
        a, b = tpool[key].float().numpy(), np.asarray(jout[key], np.float32)
        if key.endswith("scale"):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        elif kv:
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            if kv == "int4":
                d = np.abs(np.stack([a.astype(np.int16) & 15, a.astype(np.int16) >> 4])
                           - np.stack([b.astype(np.int16) & 15, b.astype(np.int16) >> 4]))
            assert d.max() <= 1 and (d != 0).mean() < 0.01
            flipped |= bool(d.any())
        else:
            np.testing.assert_allclose(a, b, rtol=2**-7, atol=1e-6)
    tol = 1e-3 if flipped else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    direct, dpool = tpaged.paged_forward(tparams, toks, pos, tables, port_pool(), cfg, kv,
                                         device="cpu")
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-4, rtol=1e-4)
    for key in tpool:
        assert torch.equal(dpool[key], tpool[key])


# -- the engine --------------------------------------------------------------------

def _engine_pair(model, **kw):
    jparams, tparams = model
    return (jpaged.PagedEngine(jparams, JConfig(**CFG), **kw),
            tpaged.PagedEngine(tparams, LLaMAConfig(**CFG), device="cpu", **kw))


@pytest.fixture(scope="module")
def model():
    tree = random_tree(np.random.default_rng(7), CFG["n_layer"], CFG["n_embd"],
                       JConfig(**CFG).n_hidden, JConfig(**CFG).padded_vocab_size, std=0.3)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, to_port(jparams)


def _prompts(rng, lengths):
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32) for n in lengths]


# name -> (engine kwargs, prompt lengths, max_new_tokens)
ENGINE_CASES = {
    "one_request": (dict(max_batch=2, n_pages=32, page_size=4), (6,), 8),
    "more_requests_than_slots": (dict(max_batch=2, n_pages=32, page_size=4), (4, 7, 5, 3, 6), 5),
    "small_pool_backpressure": (dict(max_batch=2, n_pages=9, page_size=4), (4,) * 5, 4),
    "preemption_and_resume": (dict(max_batch=2, n_pages=9, page_size=4), (10, 10), 16),
    "chunked_prefill": (dict(max_batch=3, n_pages=32, page_size=4, prefill_chunk=8),
                        (19, 4, 11), 7),
    "int8_pool": (dict(max_batch=3, n_pages=32, page_size=4, quantize_kv="int8"), (5, 9, 3), 8),
    "int4_pool": (dict(max_batch=3, n_pages=32, page_size=4, quantize_kv="int4"), (5, 9, 3), 8),
    "page_8_attn_chunk": (dict(max_batch=12, n_pages=48, page_size=8), (5, 9, 3, 7), 8),
    "pipelined_commit": (dict(max_batch=3, n_pages=32, page_size=4, quantize_kv="int8",
                              pipelined_commit=True), (5, 9, 3), 8),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_jax(model, rng, case):
    kw, lengths, new = ENGINE_CASES[case]
    prompts = _prompts(rng, lengths)
    jeng, teng = _engine_pair(model, **kw)
    want = jeng.run([(p, new) for p in prompts])
    got = teng.run([(p, new) for p in prompts])
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats()
    if case == "preemption_and_resume":
        assert teng.stats()["preempts"] > 0
    assert teng.stats()["pages_used"] == 0 and (teng.page_refs[1:] == 0).all()


def test_engine_eos_matches_jax(model, rng):
    prompt = _prompts(rng, (4,))[0]
    probe = jpaged.PagedEngine(model[0], JConfig(**CFG), max_batch=2, n_pages=16, page_size=4)
    eos = int(probe.run([(prompt, 6)])[0][len(prompt) + 1])
    jeng, teng = _engine_pair(model, max_batch=2, n_pages=16, page_size=4, eos_id=eos)
    want, got = jeng.run([(prompt, 6)]), teng.run([(prompt, 6)])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][-1] == eos and teng.stats() == jeng.stats()


@pytest.mark.parametrize("kv", [False, "int8"])
def test_engine_prefix_sharing_matches_jax(model, rng, kv):
    """Requests over one registered prefix (two full pages and a tail), chunked: the
    same tokens and stats as JAX's engine, one copy of the prefix's pages."""
    prefix = _prompts(rng, (11,))[0]
    conts = _prompts(rng, (3, 14))
    kw = dict(max_batch=2, n_pages=32, page_size=4, quantize_kv=kv, prefill_chunk=8)
    jeng, teng = _engine_pair(model, **kw)
    free = len(teng.free)
    jpid, tpid = jeng.register_prefix(prefix), teng.register_prefix(prefix)
    assert free - len(teng.free) == 11 // 4
    want = jeng.run([(c, 6) for c in conts], prefix_id=jpid)
    got = teng.run([(c, 6) for c in conts], prefix_id=tpid)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats() and teng.stats()["pages_used"] == 11 // 4
    teng.release_prefix(tpid)
    assert len(teng.free) == free


def test_engine_int4_weights_matches_jax(model, rng):
    jq = quantize_int4_tree(model[0])
    prompts = _prompts(rng, (6, 9))
    kw = dict(max_batch=2, n_pages=32, page_size=4, quantize_kv="int8")
    jeng = jpaged.PagedEngine(jq, JConfig(**CFG), **kw)
    teng = tpaged.PagedEngine(to_port(jq), LLaMAConfig(**CFG), device="cpu", **kw)
    want, got = jeng.run([(p, 7) for p in prompts]), teng.run([(p, 7) for p in prompts])
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats()


def test_engine_pool_too_small_raises(model, rng):
    eng = tpaged.PagedEngine(model[1], LLaMAConfig(**CFG), max_batch=1, n_pages=3, page_size=4,
                             device="cpu")
    with pytest.raises(RuntimeError, match="page pool too small"):
        eng.run([(_prompts(rng, (30,))[0], 4)])


def test_engine_unported_options_raise(model):
    """Pipeline serving is ported (tests/test_torch_pp_decode.py); what it cannot take
    raises before any rank waits on another: a second mesh beside ``pp_mesh``, slots that
    do not split into the micro-groups, layers that do not split over the stages."""
    from lit_llama_ja_tpu_torch.parallel.mesh import Mesh

    def pp_mesh(pp):
        return Mesh({"dp": 1, "fsdp": 1, "tp": 1, "pp": pp}, rank=0, distributed=False)

    cfg = LLaMAConfig(**CFG)
    with pytest.raises(ValueError, match="pass one mesh"):
        tpaged.PagedEngine(model[1], cfg, pp_mesh=pp_mesh(2), mesh=pp_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="does not split into 2 micro-groups"):
        tpaged.PagedEngine(model[1], cfg, max_batch=3, pp_mesh=pp_mesh(2), pp_microbatches=2,
                           device="cpu")
    with pytest.raises(ValueError, match="does not split over pp=4"):
        tpaged.PagedEngine(model[1], cfg, pp_mesh=pp_mesh(4), device="cpu")


def test_sample_next_token_distribution():
    """Per-slot sampling: greedy rows take the argmax; a tempered row's draws follow
    softmax(logits / t) restricted to the top-k (chi-square over 20,000 draws)."""
    n = 20000
    logits = torch.tensor([[0.0, 1.0, 2.0, 0.5, -1.0]]).repeat(2 * n, 1)
    temps = torch.tensor([0.0, 0.7]).repeat(n)  # alternating greedy and tempered slots
    g = torch.Generator().manual_seed(0)
    draws = tpaged.sample_next_token(logits, temps, 4, None, g).numpy().reshape(n, 2)
    assert (draws[:, 0] == 2).all()
    counts = np.bincount(draws[:, 1], minlength=5)
    p = torch.softmax(logits[1, :4] / 0.7, -1).numpy()
    assert counts[4] == 0  # outside the top-4
    expected = p * len(draws)
    chi2 = ((counts[:4] - expected) ** 2 / expected).sum()
    assert chi2 < 16.3  # 3 degrees of freedom, p = 0.001
