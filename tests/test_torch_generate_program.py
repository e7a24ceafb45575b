"""`generate` and `speculative_generate` as programs held across calls
(`lit_llama_ja_tpu_torch/infer/generate.GenerateProgram`, `infer/speculative.SpecProgram`,
held by `infer/decode_graph.HeldPrograms`) against the JAX package on the CPU.

The JAX package's jit cache keeps one compiled program a key of static arguments; the
port keeps one program a key (those arguments, the prompt's bucket, the generator) over
one set of param leaves: its buffers, its caches and its bodies (the prefill span, the
decode step or round). On the CPU the bodies run in host calls over the held buffers,
and that is what these tests drive. A sequence of calls on the held programs (a longer
prompt, a shorter one in the same bucket, another bucket, a run that rolls past the
cache, an EOS cut; fp, int8 and int4 caches; an MoE config) gives the JAX package's
greedy tokens, and each held call leaves its cache equal in bits to a fresh
``cuda_graph=False`` call's. A second call with a key builds no program; new leaves drop
the old programs, as does `release_programs`; the number of keys held is bounded. Every
body runs under `torch_port_helpers.guarded_bodies`. Tolerance: greedy tokens and cache
bytes equal.
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
from lit_llama_ja_tpu.infer import generate as jgen
from lit_llama_ja_tpu.infer.speculative import speculative_generate as jspeculative_generate
from lit_llama_ja_tpu.models import moe as jmoe

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import generate as tgen
from lit_llama_ja_tpu_torch.infer import speculative as tspec
from lit_llama_ja_tpu_torch.infer.decode_graph import release_programs
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import moe as tmoe

CFG = dict(block_size=64, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
DCFG = dict(block_size=64, vocab_size=64, n_layer=1, n_head=2, n_embd=16)
MOE_CFG = dict(block_size=64, vocab_size=64, n_layer=2, n_head=2, n_embd=32, n_expert=4,
               n_expert_active=2)
# (prompt length, new tokens): 30 and 20 share the bucket 32 and, at 44 new tokens, the
# cache's 64 slots (block_size), and the first rolls past them; 10 is another bucket
SEQUENCE = ((30, 44), (20, 44), (10, 12))


@pytest.fixture(autouse=True)
def _one_thread_no_programs():
    """One intra-op thread (the bodies are many tiny ops), no program held before or
    after a case, and the counts of programs built from 0."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    release_programs()
    tgen.PROGRAMS.built = tspec.PROGRAMS.built = 0
    yield
    release_programs()
    torch.set_num_threads(n)


def _tree(cfg, seed):
    jc = JConfig(**cfg)
    tree = random_tree(np.random.default_rng(seed), cfg["n_layer"], cfg["n_embd"], jc.n_hidden,
                       jc.padded_vocab_size, std=0.3)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, to_port(jparams)


@pytest.fixture(scope="module")
def dense():
    return _tree(CFG, 21)


@pytest.fixture(scope="module")
def draft():
    return _tree(DCFG, 22)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (n,)).astype(np.int32)


class _Caches:
    """The KV caches the fresh (``cuda_graph=False``) programs made, in order."""

    def __init__(self, monkeypatch, module):
        self.made = []
        init = module.init_kv_cache

        def kept(*args, **kwargs):
            self.made.append(init(*args, **kwargs))
            return self.made[-1]

        monkeypatch.setattr(module, "init_kv_cache", kept)


def _assert_same_cache(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_held_sequence_matches_jax_and_fresh_calls(dense, guarded_bodies, monkeypatch, kv):
    """The sequence of `SEQUENCE` on held programs: greedy tokens equal to the JAX
    `generate`'s; after each call the held cache equal in bits to a fresh call's; the
    shorter prompt in the bucket (a second call of its key) builds no program; one
    prefill span a call, a decode step a token after the first."""
    jp, tp = dense
    cfg, jcfg = LLaMAConfig(**CFG), JConfig(**CFG)
    caches = _Caches(monkeypatch, tgen)
    spans = steps = 0
    for i, (T, new) in enumerate(SEQUENCE):
        prompt = _prompt(T, i)
        want = np.asarray(jgen.generate(jp, jcfg, jnp.asarray(prompt), new, temperature=0.0,
                                        quantize_kv=kv))
        built = tgen.PROGRAMS.built
        got = tgen.generate(tp, cfg, prompt, new, temperature=0.0, quantize_kv=kv,
                            device="cpu")
        np.testing.assert_array_equal(got, want)
        assert tgen.PROGRAMS.built - built == (1 if i != 1 else 0)
        spans, steps = spans + 1, steps + new - 1
        assert (guarded_bodies["spans"], guarded_bodies["n"]) == (spans, steps)
        held = tgen.PROGRAMS.last
        fresh = tgen.generate(tp, cfg, prompt, new, temperature=0.0, quantize_kv=kv,
                              device="cpu", cuda_graph=False)
        np.testing.assert_array_equal(fresh, want)
        assert tgen.PROGRAMS.last is held
        _assert_same_cache(held.cache, caches.made[-1])
        spans, steps = spans + 1, steps + new - 1
    assert held.step.host_pos == SEQUENCE[-1][0] + SEQUENCE[-1][1] - 1
    assert len(tgen.PROGRAMS.programs) == 2


def test_held_program_rolls_and_cuts_at_eos(dense, guarded_bodies):
    """The held program of the 30-token prompt rolls its cache past 64 slots; a later
    call of the same key with an ``eos_id`` (a host cut, outside the key) reuses it and
    cuts where the JAX package does."""
    jp, tp = dense
    cfg, jcfg = LLaMAConfig(**CFG), JConfig(**CFG)
    T, new = SEQUENCE[0]
    prompt = _prompt(T, 0)
    full = tgen.generate(tp, cfg, prompt, new, temperature=0.0, device="cpu")
    program = tgen.PROGRAMS.last
    assert program.step.host_pos > program.step.S and program.step.graphs[True] is not None
    eos = int(full[T + 5])
    want = np.asarray(jgen.generate(jp, jcfg, jnp.asarray(prompt), new, temperature=0.0,
                                    eos_id=eos))
    got = tgen.generate(tp, cfg, prompt, new, temperature=0.0, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[-1] == eos and len(got) <= T + 6
    assert tgen.PROGRAMS.built == 1 and tgen.PROGRAMS.last is program
    assert guarded_bodies["spans"] == 2


def test_held_program_moe(guarded_bodies, monkeypatch):
    """An `MoEConfig`: the held program decodes through the sparse MLP; two prompts of
    one bucket on one program (its cache pinned to 64 slots) give the JAX `generate`'s
    tokens, and the second a fresh call's cache."""
    L, D, E = MOE_CFG["n_layer"], MOE_CFG["n_embd"], MOE_CFG["n_expert"]
    jcfg, cfg = jmoe.MoEConfig(**MOE_CFG), tmoe.MoEConfig(**MOE_CFG)
    tree = random_tree(np.random.default_rng(23), L, D, cfg.n_hidden, cfg.padded_vocab_size,
                       std=0.3)
    rng = np.random.default_rng(24)
    H = cfg.n_hidden
    tree["blocks"].pop("mlp")
    tree["blocks"]["moe"] = {
        "router": {"weight": rng.standard_normal((L, D, E)).astype(np.float32)},
        "c_fc1": {"weight": (0.3 * rng.standard_normal((L, E, D, H))).astype(np.float32)},
        "c_fc2": {"weight": (0.3 * rng.standard_normal((L, E, D, H))).astype(np.float32)},
        "c_proj": {"weight": (0.3 * rng.standard_normal((L, E, H, D))).astype(np.float32)},
    }
    jtree, ttree = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")
    caches = _Caches(monkeypatch, tgen)
    kw = dict(temperature=0.0, quantize_kv="int8", max_seq_length=64, device="cpu")
    for i, T in enumerate((14, 11)):
        prompt = _prompt(T, 30 + i)
        want = np.asarray(jgen.generate(jtree, jcfg, jnp.asarray(prompt), 38,
                                        temperature=0.0, quantize_kv="int8",
                                        max_seq_length=64))
        got = tgen.generate(ttree, cfg, prompt, 38, **kw)
        np.testing.assert_array_equal(got, want)
        assert tgen.PROGRAMS.built == 1
    held = tgen.PROGRAMS.last
    tgen.generate(ttree, cfg, prompt, 38, cuda_graph=False, **kw)
    assert tgen.PROGRAMS.built == 1
    _assert_same_cache(held.cache, caches.made[-1])
    assert guarded_bodies["spans"] == 3


def test_new_leaves_and_release_drop_the_programs(dense):
    """The holder keeps the leaves its programs read; a call over other leaves drops
    those programs and leaves (a weakref to an old leaf dies), and so does
    `release_programs`."""
    _, tp = dense
    cfg = LLaMAConfig(**CFG)
    prompt = _prompt(12, 5)
    copy = {k: v for k, v in tp.items()}
    copy["ln_f"] = {"scale": tp["ln_f"]["scale"].clone()}
    old = weakref.ref(copy["ln_f"]["scale"])
    want = tgen.generate(copy, cfg, prompt, 6, temperature=0.0, device="cpu")
    first = weakref.ref(tgen.PROGRAMS.last)
    del copy
    gc.collect()
    assert old() is not None and first() is not None  # held by the program
    got = tgen.generate(tp, cfg, prompt, 6, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    gc.collect()
    assert old() is None and first() is None
    assert list(tgen.PROGRAMS.programs) and tgen.PROGRAMS.built == 2
    held = weakref.ref(tgen.PROGRAMS.last)
    release_programs()
    gc.collect()
    assert held() is None and not tgen.PROGRAMS.programs and tgen.PROGRAMS.bound is None


def test_keys_held_per_tree_are_bounded(dense, monkeypatch):
    """At most ``max_keys`` keys a tree: a call of a new key past them drops the least
    recently used, and a call of a dropped key builds it again."""
    _, tp = dense
    cfg = LLaMAConfig(**CFG)
    monkeypatch.setattr(tgen.PROGRAMS, "max_keys", 2)
    prompt = _prompt(12, 6)

    def call(new):
        tgen.generate(tp, cfg, prompt, new, temperature=0.0, device="cpu")
        return [key[3] for key in tgen.PROGRAMS.programs]  # max_new_tokens of each key

    assert call(3) == [3]
    assert call(4) == [3, 4]
    assert call(3) == [4, 3]  # a hit moves to the end
    assert call(5) == [3, 5]  # 4 was the least recently used
    assert tgen.PROGRAMS.built == 3
    assert call(4) == [5, 4] and tgen.PROGRAMS.built == 4


def test_fresh_calls_hold_nothing(dense):
    """``cuda_graph=False`` runs a fresh program each call, held nowhere."""
    _, tp = dense
    out = [tgen.generate(tp, LLaMAConfig(**CFG), _prompt(9, 7), 5, temperature=0.0,
                         device="cpu", cuda_graph=False) for _ in range(2)]
    np.testing.assert_array_equal(out[0], out[1])
    assert tgen.PROGRAMS.built == 0 and not tgen.PROGRAMS.programs


def test_sampled_held_calls_repeat_under_one_seed(dense):
    """A tempered held call draws from the caller's generator: the same seed gives the
    same tokens on the held program as on a fresh one, and the generator is part of the
    key."""
    _, tp = dense
    cfg = LLaMAConfig(**CFG)
    prompt = _prompt(12, 8)
    g = torch.Generator().manual_seed(3)
    kw = dict(temperature=0.9, top_k=20, device="cpu")
    a = tgen.generate(tp, cfg, prompt, 10, generator=g, **kw)
    g.manual_seed(3)
    b = tgen.generate(tp, cfg, prompt, 10, generator=g, **kw)
    c = tgen.generate(tp, cfg, prompt, 10, generator=torch.Generator().manual_seed(3),
                      cuda_graph=False, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    assert tgen.PROGRAMS.built == 1
    tgen.generate(tp, cfg, prompt, 10, generator=torch.Generator().manual_seed(3), **kw)
    assert tgen.PROGRAMS.built == 2


@pytest.mark.parametrize("K", [2, 4])
def test_held_speculative_matches_jax(dense, draft, guarded_bodies, monkeypatch, K):
    """Greedy `speculative_generate` on held programs (an int4 target cache): two prompts
    of one bucket (one key, the second call building nothing), each call's tokens and
    stats equal to the JAX package's, and both caches equal in bits to a fresh call's
    (another bucket's key: `test_held_speculative_eos_and_new_draft`)."""
    (jt, tt), (jd, td) = dense, draft
    tcfg, dcfg = LLaMAConfig(**CFG), LLaMAConfig(**DCFG)
    caches = _Caches(monkeypatch, tspec)
    rounds = 0
    for i, T in enumerate((13, 10)):
        prompt = _prompt(T, 40 + i)
        stats, jstats = {}, {}
        jgot = jspeculative_generate(jt, JConfig(**CFG), jd, JConfig(**DCFG), prompt, 16, K=K,
                                     temperature=0.0, quantize_kv="int4", stats_out=jstats)
        got = tspec.speculative_generate(tt, tcfg, td, dcfg, prompt, 16, K=K, temperature=0.0,
                                         quantize_kv="int4", stats_out=stats, device="cpu")
        np.testing.assert_array_equal(got, jgot)
        assert stats == jstats and tspec.PROGRAMS.built == 1
        rounds += stats["rounds"]
        assert guarded_bodies["n"] == rounds and guarded_bodies["spans"] == 2 * i + 1
        held = tspec.PROGRAMS.last
        fresh = tspec.speculative_generate(tt, tcfg, td, dcfg, prompt, 16, K=K,
                                           temperature=0.0, quantize_kv="int4", device="cpu",
                                           cuda_graph=False)
        np.testing.assert_array_equal(fresh, got)
        _assert_same_cache(held.tcache, caches.made[-2])
        _assert_same_cache(held.dcache, caches.made[-1])
        rounds += stats["rounds"]
    assert len(tspec.PROGRAMS.programs) == 1 and tspec.PROGRAMS.bound is not None


def test_held_speculative_eos_and_new_draft(dense, draft):
    """An ``eos_id`` is part of the speculative key (the loop tests it on the device),
    and so is the bucket (a 20-token prompt); a self-draft (other leaves) drops the
    programs of the old pair."""
    (jt, tt), (jd, td) = dense, draft
    tcfg, dcfg = LLaMAConfig(**CFG), LLaMAConfig(**DCFG)
    prompt = _prompt(20, 50)
    full = tspec.speculative_generate(tt, tcfg, td, dcfg, prompt, 16, K=3, temperature=0.0,
                                      device="cpu")
    eos = int(full[20 + 4])
    want = jspeculative_generate(jt, JConfig(**CFG), jd, JConfig(**DCFG), prompt, 16, K=3,
                                 temperature=0.0, eos_id=eos)
    got = tspec.speculative_generate(tt, tcfg, td, dcfg, prompt, 16, K=3, temperature=0.0,
                                     eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert tspec.PROGRAMS.built == 2 and len(tspec.PROGRAMS.programs) == 2
    old = weakref.ref(tspec.PROGRAMS.last)
    self_draft = tspec.speculative_generate(tt, tcfg, tt, tcfg, prompt, 16, K=3,
                                            temperature=0.0, device="cpu")
    np.testing.assert_array_equal(self_draft, full)
    gc.collect()
    assert old() is None and len(tspec.PROGRAMS.programs) == 1


class _IdTokenizer:
    """Token ids as text: "3 17 5" <-> [3, 17, 5]; no EOS in the vocabulary's use."""

    eos_id = 63

    def encode(self, text, bos=True, eos=False):
        return [int(t) for t in text.split()]

    def decode(self, ids):
        return " ".join(str(int(t)) for t in ids)


@pytest.mark.parametrize("draft_path", [None, "draft"])
def test_cli_samples_share_one_program(dense, draft, guarded_bodies, monkeypatch, capsys,
                                       draft_path):
    """`generate_cli.main --num_samples 3` (sampled, one generator) runs its samples on
    one held program: one built, one prefill span a sample; with a draft checkpoint the
    same for `speculative_generate`'s program."""
    from lit_llama_ja_tpu_torch.cli import generate_cli

    (_, tt), (_, td) = dense, draft
    models = {"target": (tt, LLaMAConfig(**CFG)), "draft": (td, LLaMAConfig(**DCFG))}
    monkeypatch.setattr(generate_cli, "load_model_any",
                        lambda path, quantize, device, mesh: models[str(path)])
    monkeypatch.setattr(generate_cli, "load_tokenizer", lambda _: _IdTokenizer())
    generate_cli.main(prompt=" ".join(map(str, _prompt(11, 60))), num_samples=3,
                      max_new_tokens=8, top_k=20, temperature=0.8, checkpoint_path="target",
                      tokenizer_path="ids", draft_checkpoint_path=draft_path, draft_k=2,
                      device="cpu")
    held = tspec.PROGRAMS if draft_path else tgen.PROGRAMS
    assert held.built == 1 and len(held.programs) == 1
    assert guarded_bodies["spans"] == 3
    samples = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(samples) == 3 and len(set(samples)) > 1  # the draws go on across samples
