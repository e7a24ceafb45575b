"""The PyTorch port's slot-stripe serving engine against the JAX package's on the CPU
(greedy tokens and `stats()` equal), and the serve CLI end to end with
``device="cpu"`` over both engines, on a tiny registered config with a byte-level BPE
tokenizer trained in the test's directory (as `tests/test_torch_cli.py` does). The
comparisons with the JAX engine run every decode step's body under
`torch_port_helpers.guarded_bodies`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.infer.serving import Engine as JEngine

from lit_llama_ja_tpu_torch.cli import serve_cli
from lit_llama_ja_tpu_torch.core import config as tconfig
from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
from lit_llama_ja_tpu_torch.infer.serving import Engine
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer
from lit_llama_ja_tpu_torch.models.llama import init_params

from torch_port_helpers import guarded_bodies, random_tree, to_port  # noqa: F401 (a fixture)

CFG = dict(block_size=64, vocab_size=64, n_layer=2, n_head=4, n_embd=32)


@pytest.fixture(scope="module")
def model():
    tree = random_tree(np.random.default_rng(3), CFG["n_layer"], CFG["n_embd"],
                       JConfig(**CFG).n_hidden, JConfig(**CFG).padded_vocab_size, std=0.3)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, to_port(jparams)


def _prompts(rng, lengths):
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("kv", [False, "int8"])
@pytest.mark.parametrize("lengths,max_batch", [((6,), 2), ((4, 7, 5), 3), ((4, 9, 3, 6, 5), 2)])
def test_stripe_engine_matches_jax(model, rng, guarded_bodies, kv, lengths, max_batch):
    prompts = _prompts(rng, lengths)
    jeng = JEngine(model[0], JConfig(**CFG), max_batch=max_batch, quantize_kv=bool(kv))
    teng = Engine(model[1], tconfig.LLaMAConfig(**CFG), max_batch=max_batch, quantize_kv=kv,
                  device="cpu")
    want = jeng.run([(p, 6) for p in prompts])
    got = teng.run([(p, 6) for p in prompts])
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.stats() == jeng.stats()
    assert guarded_bodies["n"] == teng.stats()["steps"] > 0


def test_stripe_engine_eos_and_int4_refused(model, rng, guarded_bodies):
    prompt = _prompts(rng, (4,))[0]
    probe = JEngine(model[0], JConfig(**CFG), max_batch=2)
    eos = int(probe.run([(prompt, 6)])[0][len(prompt) + 1])
    jeng = JEngine(model[0], JConfig(**CFG), max_batch=2, eos_id=eos)
    teng = Engine(model[1], tconfig.LLaMAConfig(**CFG), max_batch=2, eos_id=eos, device="cpu")
    want, got = jeng.run([(prompt, 6)]), teng.run([(prompt, 6)])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][-1] == eos and teng.stats() == jeng.stats()
    with pytest.raises(ValueError, match="int8 KV cache at most"):
        Engine(model[1], tconfig.LLaMAConfig(**CFG), quantize_kv="int4", device="cpu")


def test_stripe_engine_samples(model, rng):
    """Tempered top-p sampling through the fused step: in-vocab tokens, and the same
    tokens from the same seed."""
    prompt = _prompts(rng, (5,))[0]
    outs = [Engine(model[1], tconfig.LLaMAConfig(**CFG), max_batch=2, seed=4, device="cpu")
            .run([(prompt, 6)], temperature=0.9, top_p=0.8)[0] for _ in range(2)]
    assert len(outs[0]) == len(prompt) + 6
    assert (outs[0] >= 0).all() and (outs[0] < CFG["vocab_size"]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


TINY = dict(block_size=32, vocab_size=320, n_layer=2, n_head=4, n_embd=64)
WORDS = ["tokyo", "kyoto", "osaka", "sakura", "yama", "kawa", "umi", "sora", "hana", "tori"]


@pytest.fixture
def setup(tmp_path, monkeypatch):
    """A tokenizer and a checkpoint directory of random weights."""
    monkeypatch.setitem(tconfig.llama_configs, "tiny", TINY)
    rng = np.random.default_rng(0)
    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(" ".join(rng.choice(WORDS, size=12)) for _ in range(300)))
    tok = HFTokenizer.train(str(text), str(tmp_path), vocab_size=300)
    config = tconfig.LLaMAConfig.from_name("tiny")
    params = init_params(torch.Generator().manual_seed(0), config, device="cpu")
    save_checkpoint(tmp_path / "fp", params, config)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("tokyo kyoto\n\nsakura yama kawa\numi\n")
    return tmp_path, tok, str(prompts)


@pytest.mark.parametrize("kw", [dict(), dict(quantize_kv="int8", prefill_chunk=2),
                                dict(quantize_kv="none", quantize="gptq.int4"),
                                dict(paged=False), dict(paged=False, quantize_kv="none")])
def test_serve_cli(setup, capsys, kw):
    tmp, tok, prompts = setup
    serve_cli.main(prompts_file=prompts, checkpoint_path=str(tmp / "fp"), tokenizer_path=tok,
                   max_new_tokens=5, max_batch=2, max_seq_length=32, temperature=0.0,
                   device="cpu", **kw)
    out = capsys.readouterr()
    texts = out.out.split("--- request ")[1:]
    assert len(texts) == 3
    for text, start in zip(texts, ("tokyo kyoto", "sakura yama kawa", "umi")):
        assert text.split("\n", 1)[1].startswith(start)
    assert "3 requests" in out.err and "tokens/s aggregate" in out.err
    if kw.get("paged") is False and "quantize_kv" not in kw:
        assert "using int8" in out.err


def test_serve_cli_greedy_matches_engine(setup, capsys):
    """The CLI's greedy text is the paged engine's tokens, decoded."""
    tmp, tok, _ = setup
    config = tconfig.LLaMAConfig.from_name("tiny")
    params = init_params(torch.Generator().manual_seed(0), config, device="cpu")
    tokenizer = HFTokenizer(tok)
    ids = tokenizer.encode("osaka hana", bos=True, eos=False)
    eng = PagedEngine(params, config, max_batch=8, n_pages=8 * 32 // 16 + 1, page_size=16,
                      max_pages_per_slot=2, quantize_kv="int4", eos_id=tokenizer.eos_id,
                      device="cpu")
    want = tokenizer.decode(eng.run([(ids, 6)])[0])
    serve_cli.main(prompt="osaka hana", n_requests=1, checkpoint_path=str(tmp / "fp"),
                   tokenizer_path=tok, max_new_tokens=6, max_seq_length=32, temperature=0.0,
                   device="cpu")
    assert capsys.readouterr().out.split("--- request 0 ---\n")[1].rstrip("\n") == want


def test_serve_cli_refuses_unported_options(setup):
    """Every mesh option of the JAX package's CLI is ported (tp/fsdp in
    tests/test_torch_parallel.py and tests/test_torch_mesh_serving.py, pp in
    tests/test_torch_pp_decode.py and tests/test_torch_pp_spec.py, with a draft and with
    the stripe engine); what is left to refuse is a mesh that one rank cannot hold."""
    tmp, tok, _ = setup
    common = dict(checkpoint_path=str(tmp / "fp"), tokenizer_path=tok, device="cpu")
    draft = dict(draft_checkpoint_path=str(tmp / "fp"))
    for kw in (dict(tp=2), dict(fsdp=2), dict(pp_stages=2), dict(pp_stages=2, **draft),
               dict(tp=2, **draft), dict(paged=False, tp=2), dict(paged=False, pp_stages=2)):
        with pytest.raises(ValueError, match="does not cover 1 ranks"):
            serve_cli.main(**kw, **common)
