"""The decode step as one device program (`lit_llama_ja_tpu_torch/infer/decode_graph.py`)
against the JAX package's compiled decodes on the CPU.

On a CUDA device the step body is captured in a CUDA graph and replayed; on the CPU the
same body runs in a host loop, and that is what these tests drive: `GenerateStep` after
an eager prefill gives the greedy tokens of the JAX `generate` (fp, int8 and int4
caches, a cache that rolls, an MoE config), and `PagedEngine`'s buffer-fed decode the
tokens of the JAX `PagedEngine` (int8 and int4 pools, a shared prefix, a preemption).
A guard (`torch_port_helpers.guarded_bodies`) runs every body with the tensor methods
that read a value back to the host, and the functions that make tensors of host data,
patched to raise. Tolerance: greedy tokens equal.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (  # noqa: F401 (a fixture)
    guarded_bodies,
    no_host_reads,
    quantize_int4_tree,
    random_tree,
    to_port,
)

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer import generate as jgen
from lit_llama_ja_tpu.infer import paged as jpaged
from lit_llama_ja_tpu.models import llama as jl
from lit_llama_ja_tpu.models import moe as jmoe

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import decode_graph
from lit_llama_ja_tpu_torch.infer import generate as tgen
from lit_llama_ja_tpu_torch.infer import paged as tpaged
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import moe as tmoe
from lit_llama_ja_tpu_torch.models.llama import init_kv_cache
from lit_llama_ja_tpu_torch.ops.sampling import categorical

CFG = dict(block_size=24, vocab_size=96, n_layer=2, n_head=4, n_embd=64)
MOE_CFG = dict(block_size=16, vocab_size=96, n_layer=2, n_head=2, n_embd=16, n_expert=8,
               n_expert_active=2)
PAGED_CFG = dict(block_size=64, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
@pytest.fixture(scope="module")
def dense():
    p = quantize_int4_tree(jl.init_params(jax.random.PRNGKey(3), JConfig(**CFG)))
    return p, to_port(p)


def _host_loop(tp, cfg, prompt, new, kv, cache_len=None):
    """`generate`'s prefill, then the step body ``new - 1`` times in a host loop:
    the new tokens and the `GenerateStep`."""
    T = len(prompt)
    P = tgen.bucket_length(T)
    S = max(cache_len or min(T + new, cfg.block_size), P)
    cache = init_kv_cache(cfg, 1, S, torch.float32, quantized=kv, device="cpu")
    padded = torch.zeros((1, P), dtype=torch.long)
    padded[0, :T] = torch.from_numpy(prompt)
    logits, cache = tgen._cached_forward(tp, padded, torch.arange(P), cache, cfg,
                                         prefill_attn=True, device="cpu")
    first = torch.argmax(logits[0, T - 1], dim=-1)
    step = tgen.decode_step(tp, cfg, cache, first, T, new, temperature=0.0, device="cpu")
    assert not any(g.capture_enabled for g in step.graphs.values())
    for _ in range(new - 1):
        step.run()
    return step.out.numpy(), step


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
@pytest.mark.parametrize("rolls", [False, True])
def test_step_body_matches_jax_generate(dense, rng, guarded_bodies, kv, rolls):
    """Greedy tokens of the step body in a host loop against the JAX `generate`; with
    ``rolls`` 24 new tokens after a 7-token prompt pass the 24-slot cache (block_size),
    so the roll-left variant of the step runs from position 24 on."""
    jp, tp = dense
    prompt = rng.integers(0, CFG["vocab_size"], size=(7,)).astype(np.int32)
    new = 24 if rolls else 10
    want = np.asarray(jgen.generate(jp, JConfig(**CFG), jnp.asarray(prompt), new,
                                    temperature=0.0, quantize_kv=kv))[len(prompt):]
    got, step = _host_loop(tp, LLaMAConfig(**CFG), prompt, new, kv)
    np.testing.assert_array_equal(got, want)
    assert guarded_bodies["n"] == new - 1
    assert step.host_pos == len(prompt) + new - 1
    assert (step.host_pos > step.S) == rolls
    full = tgen.generate(tp, LLaMAConfig(**CFG), prompt, new, temperature=0.0,
                         quantize_kv=kv, device="cpu")
    np.testing.assert_array_equal(full[len(prompt):], want)


def test_step_body_matches_jax_generate_moe(rng, guarded_bodies):
    """An `MoEConfig` checkpoint: its step body (the sparse MLP at the decode capacity)
    gives the JAX `generate`'s greedy tokens, past a cache that rolls."""
    tree = random_tree(np.random.default_rng(5), MOE_CFG["n_layer"], MOE_CFG["n_embd"],
                       tmoe.MoEConfig(**MOE_CFG).n_hidden,
                       tmoe.MoEConfig(**MOE_CFG).padded_vocab_size)
    rng_w = np.random.default_rng(6)
    L, D, E = MOE_CFG["n_layer"], MOE_CFG["n_embd"], MOE_CFG["n_expert"]
    H = tmoe.MoEConfig(**MOE_CFG).n_hidden
    tree["blocks"].pop("mlp")
    tree["blocks"]["moe"] = {
        "router": {"weight": rng_w.standard_normal((L, D, E)).astype(np.float32)},
        "c_fc1": {"weight": (0.1 * rng_w.standard_normal((L, E, D, H))).astype(np.float32)},
        "c_fc2": {"weight": (0.1 * rng_w.standard_normal((L, E, D, H))).astype(np.float32)},
        "c_proj": {"weight": (0.1 * rng_w.standard_normal((L, E, H, D))).astype(np.float32)},
    }
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_numpy(tree, device="cpu")
    jcfg, cfg = jmoe.MoEConfig(**MOE_CFG), tmoe.MoEConfig(**MOE_CFG)
    prompt = rng.integers(0, MOE_CFG["vocab_size"], (5,)).astype(np.int32)
    want = np.asarray(jgen.generate(jtree, jcfg, jnp.asarray(prompt), 14,
                                    temperature=0.0))[len(prompt):]
    got, step = _host_loop(ttree, cfg, prompt, 14, False)
    np.testing.assert_array_equal(got, want)
    assert step.host_pos > step.S  # 5 + 13 positions over a 16-slot cache
    assert guarded_bodies["n"] == 13


@pytest.fixture(scope="module")
def paged_model():
    tree = random_tree(np.random.default_rng(7), PAGED_CFG["n_layer"], PAGED_CFG["n_embd"],
                       JConfig(**PAGED_CFG).n_hidden, JConfig(**PAGED_CFG).padded_vocab_size,
                       std=0.3)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, to_port(jparams)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_paged_buffer_fed_decode_matches_jax(paged_model, rng, guarded_bodies, kv):
    """Requests over a registered prefix (two shared pages and a tail) on a pool small
    enough that a slot is preempted and resumes: the buffer-fed decode gives the JAX
    engine's tokens and stats; every decode step ran a step body."""
    jparams, tparams = paged_model
    prefix = rng.integers(0, PAGED_CFG["vocab_size"], (9,)).astype(np.int32)
    conts = [rng.integers(0, PAGED_CFG["vocab_size"], (n,)).astype(np.int32) for n in (6, 7)]
    kw = dict(max_batch=2, n_pages=12, page_size=4, quantize_kv=kv)
    jeng = jpaged.PagedEngine(jparams, JConfig(**PAGED_CFG), **kw)
    teng = tpaged.PagedEngine(tparams, LLaMAConfig(**PAGED_CFG), device="cpu", **kw)
    jpid, tpid = jeng.register_prefix(prefix), teng.register_prefix(prefix)
    want = jeng.run([(c, 16) for c in conts], prefix_id=jpid)
    got = teng.run([(c, 16) for c in conts], prefix_id=tpid)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats()
    assert teng.stats()["preempts"] > 0
    assert guarded_bodies["n"] == teng.stats()["steps"]
    widths = {key[0] for key in teng.decode_step.graphs}
    assert widths and all(w & (w - 1) == 0 for w in widths)  # one step a width bucket


def test_mesh_engines_keep_the_host_fed_step(paged_model, rng):
    """A pipeline engine's steps stage through the host: it makes no buffer-fed step,
    where an engine without a mesh makes one at its first decode step; both give the
    same tokens."""
    from lit_llama_ja_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"dp": 1, "fsdp": 1, "tp": 1, "pp": 1}, rank=0, distributed=False)
    prompt = rng.integers(0, PAGED_CFG["vocab_size"], (5,)).astype(np.int32)
    kw = dict(max_batch=2, n_pages=16, page_size=4, device="cpu")
    outs = []
    for extra in ({"pp_mesh": mesh}, {}):
        eng = tpaged.PagedEngine(paged_model[1], LLaMAConfig(**PAGED_CFG), **kw, **extra)
        assert eng.decode_step is None
        outs.append(eng.run([(prompt, 4)]))
        assert (eng.decode_step is None) == bool(extra)
    assert sorted(outs[0]) == sorted(outs[1])
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


def test_steps_and_engines_go_with_their_last_reference(dense, paged_model, rng):
    """No reference cycle holds a decode step: a `GenerateStep` and a served
    `PagedEngine` are freed by their last reference, the cyclic collector off (on the
    card their graphs, the graphs' pool and the engine's KV pool go with them)."""
    prompt = rng.integers(0, CFG["vocab_size"], size=(5,)).astype(np.int32)
    gc.disable()
    try:
        _, step = _host_loop(dense[1], LLaMAConfig(**CFG), prompt, 4, "int8")
        gone = weakref.ref(step)
        del step
        assert gone() is None
        eng = tpaged.PagedEngine(paged_model[1], LLaMAConfig(**PAGED_CFG), max_batch=2,
                                 n_pages=16, page_size=4, quantize_kv="int8", device="cpu")
        short = prompt % PAGED_CFG["vocab_size"]
        eng.run([(short, 4), (short[:3], 3)])
        assert eng.decode_step.graphs
        gone = weakref.ref(eng)
        del eng
        assert gone() is None
    finally:
        gc.enable()


def test_guard_refuses_host_reads():
    """The guard itself: each patched method raises inside and works again after; so do
    `torch.tensor`, `torch.as_tensor` and `torch.from_numpy` of host data, while a
    tensor passes through them."""
    t = torch.tensor([3])
    for read in (lambda: t.item(), lambda: t.cpu(), lambda: t.tolist(), lambda: t.numpy(),
                 lambda: int(t), lambda: bool(t), lambda: float(t), lambda: [0, 1][t]):
        with no_host_reads(), pytest.raises(AssertionError, match="read a tensor back"):
            read()
    host = np.arange(3, dtype=np.int32)
    for build in (lambda: torch.tensor(host), lambda: torch.tensor([1, 2]),
                  lambda: torch.as_tensor(host), lambda: torch.as_tensor([0.5]),
                  lambda: torch.as_tensor(3), lambda: torch.from_numpy(host)):
        with no_host_reads(), pytest.raises(AssertionError, match="from host data"):
            build()
    with no_host_reads():
        assert torch.as_tensor(t, dtype=torch.float32).dtype == torch.float32
    assert t.item() == 3 and int(t) == 3 and bool(t) and t.tolist() == [3]
    assert torch.as_tensor(host).tolist() == [0, 1, 2] == torch.from_numpy(host).tolist()


def test_categorical_is_multinomials_draw():
    """The capturable draw equals `torch.multinomial(probs, 1)` from the same generator
    state, bit for bit, and leaves the generator in the same state."""
    probs = torch.softmax(torch.randn((5, 300), generator=torch.Generator().manual_seed(0)),
                          -1)
    for seed in range(8):
        g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        torch.testing.assert_close(categorical(probs, g2), want, rtol=0, atol=0)
        torch.testing.assert_close(torch.rand(4, generator=g2), torch.rand(4, generator=g1),
                                   rtol=0, atol=0)


def test_sampled_generation_is_seeded(dense, rng):
    """A sampled run through the step body: the same generator seed gives the same
    tokens, another seed other tokens."""
    _, tp = dense
    prompt = rng.integers(0, CFG["vocab_size"], size=(6,)).astype(np.int32)

    def run(seed):
        return tgen.generate(tp, LLaMAConfig(**CFG), prompt, 12, temperature=1.5,
                             generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_decode_graph_needs_cuda_to_capture():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        decode_graph.DecodeGraph(lambda: None, "cpu", capture=True)
