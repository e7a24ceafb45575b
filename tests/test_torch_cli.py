"""The PyTorch port's generate, quantize, evaluate and convert CLIs end to end on the CPU
(``device="cpu"``), with a byte-level BPE tokenizer trained in the test's directory by
the port's `HFTokenizer.train`, on a tiny config registered for the test.
"""
import re

import numpy as np
import pytest
import torch

from lit_llama_ja_tpu_torch.cli import convert_cli, evaluate_cli, generate_cli, quantize_cli
from lit_llama_ja_tpu_torch.core import config as tconfig
from lit_llama_ja_tpu_torch.infer.evaluate import perplexity
from lit_llama_ja_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from lit_llama_ja_tpu_torch.io.convert import native_to_hf_state_dict, native_to_lit_state_dict
from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer
from lit_llama_ja_tpu_torch.models.llama import forward, init_params
from lit_llama_ja_tpu_torch.utils.cli import CLI

TINY = dict(block_size=32, vocab_size=320, n_layer=2, n_head=4, n_embd=64)
WORDS = ["tokyo", "kyoto", "osaka", "sakura", "yama", "kawa", "umi", "sora", "hana", "tori"]


@pytest.fixture
def setup(tmp_path, monkeypatch):
    """A tokenizer, a text file and a checkpoint directory of random weights."""
    monkeypatch.setitem(tconfig.llama_configs, "tiny", TINY)
    monkeypatch.setitem(tconfig.llama_model_sizes, TINY["n_embd"], "tiny")  # for a .pth
    rng = np.random.default_rng(0)
    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(" ".join(rng.choice(WORDS, size=12)) for _ in range(300)))
    tok = HFTokenizer.train(str(text), str(tmp_path), vocab_size=300)
    assert HFTokenizer(tok).vocab_size <= TINY["vocab_size"]
    config = tconfig.LLaMAConfig.from_name("tiny")
    params = init_params(torch.Generator().manual_seed(0), config, device="cpu")
    params = {k: ({kk: v * 5 for kk, v in sub.items()} if k in ("wte", "lm_head") else sub)
              for k, sub in params.items()}  # a less uniform next-token distribution
    save_checkpoint(tmp_path / "fp", params, config)
    return tmp_path, str(text), tok, params, config


@pytest.mark.parametrize("quantize", [None, "llm.int8", "llm.int8-dyn", "rtn.int2-g32",
                                      "gptq.mix-g32"])
def test_generate_cli(setup, capsys, quantize):
    tmp, _, tok, _, _ = setup
    generate_cli.main(prompt="tokyo kyoto", checkpoint_path=str(tmp / "fp"),
                      tokenizer_path=tok, quantize=quantize, max_new_tokens=6, top_k=20,
                      temperature=0.0, quantize_kv="int8", device="cpu")
    out = capsys.readouterr()
    assert out.out.startswith("tokyo kyoto")
    assert "tokens/sec" in out.err


def test_generate_cli_refuses_unported_options(setup):
    tmp, _, tok, _, _ = setup
    with pytest.raises(NotImplementedError, match="slice 6"):
        generate_cli.main(checkpoint_path=str(tmp / "fp"), tokenizer_path=tok,
                          draft_checkpoint_path=str(tmp / "fp"), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 7"):
        generate_cli.main(checkpoint_path=str(tmp / "fp"), tokenizer_path=tok, tp=2,
                          device="cpu")


def test_quantize_then_evaluate_cli(setup, capsys):
    """GPTQ calibration on the local text, save, then both evaluation protocols on the
    saved checkpoint; the printed perplexity is the library's on the same tree."""
    tmp, text, tok, _, config = setup
    out_dir = tmp / "q3"
    CLI(quantize_cli.main, args=[
        "--checkpoint-path", str(tmp / "fp"), "--output-path", str(out_dir),
        "--tokenizer-path", tok, "--n-samples", "3", "--quantize", "gptq.int3",
        "--calib-text-path", text, "--device", "cpu"])
    assert "calibrating on 3 x 32 tokens" in capsys.readouterr().err
    qparams, qconfig = load_checkpoint(out_dir, device="cpu")
    assert qconfig == config and "qweight_hi" in qparams["blocks"]["mlp"]["c_proj"]

    evaluate_cli.main(datasets=text, checkpoint_path=str(out_dir), tokenizer_path=tok,
                      device="cpu")
    line = capsys.readouterr().out
    ppl = float(re.search(r"perplexity (\S+)", line).group(1))
    want = perplexity(qparams, config, HFTokenizer(tok).encode(open(text).read()), device="cpu")
    assert abs(ppl - want) <= 1e-4 * want  # printed to four decimals
    evaluate_cli.main(datasets=text, checkpoint_path=str(out_dir), tokenizer_path=tok,
                      kv_cache="int4", kv_windows=1, device="cpu")
    assert "decode-path perplexity (kv=int4)" in capsys.readouterr().out


def test_quantize_cli_default_output_path(setup):
    tmp, text, tok, _, _ = setup
    quantize_cli.main(checkpoint_path=str(tmp / "fp"), tokenizer_path=tok, n_samples=1,
                      quantize="gptq.mix-g32", calib_text_path=text, device="cpu")
    assert (tmp / "llama-gptq.mix-a4m2h4-g32" / "params.pt").exists()
    with pytest.raises(RuntimeError, match="unsupported"):
        quantize_cli.main(checkpoint_path=str(tmp / "fp"), quantize="llm.int8", device="cpu")


@pytest.mark.parametrize("quantize", [None, "llm.int8-rtn", "gptq.int4"])
def test_load_model_any_from_pth(setup, quantize):
    tmp, _, _, params, config = setup
    path = tmp / "lit-llama.pth"
    torch.save(native_to_lit_state_dict(params), path)
    got, cfg = generate_cli.load_model_any(path, quantize, device="cpu")
    assert cfg == config
    from_dir, _ = generate_cli.load_model_any(tmp / "fp", quantize, device="cpu")
    ids = torch.arange(10)[None]
    assert torch.allclose(forward(got, ids, config, device="cpu"),
                          forward(from_dir, ids, config, device="cpu"), atol=1e-5)


def test_convert_cli_meta_and_hf(setup):
    tmp, _, _, params, config = setup
    lit = native_to_lit_state_dict(params)
    meta = {"tok_embeddings.weight": lit["transformer.wte.weight"],
            "output.weight": lit["lm_head.weight"], "norm.weight": lit["transformer.ln_f.scale"]}
    D = config.n_embd
    for i in range(config.n_layer):
        h = f"transformer.h.{i}."
        qkv = lit[h + "attn.c_attn.weight"]
        meta.update({
            f"layers.{i}.attention.wq.weight": qkv[:D], f"layers.{i}.attention.wk.weight":
            qkv[D : 2 * D], f"layers.{i}.attention.wv.weight": qkv[2 * D :],
            f"layers.{i}.attention.wo.weight": lit[h + "attn.c_proj.weight"],
            f"layers.{i}.feed_forward.w1.weight": lit[h + "mlp.c_fc1.weight"],
            f"layers.{i}.feed_forward.w2.weight": lit[h + "mlp.c_proj.weight"],
            f"layers.{i}.feed_forward.w3.weight": lit[h + "mlp.c_fc2.weight"],
            f"layers.{i}.attention_norm.weight": lit[h + "rms_1.scale"],
            f"layers.{i}.ffn_norm.weight": lit[h + "rms_2.scale"],
        })
    (tmp / "meta").mkdir()
    torch.save({k: v.contiguous() for k, v in meta.items()}, tmp / "meta" / "consolidated.00.pth")
    convert_cli.convert_meta_checkpoint(str(tmp / "meta"), str(tmp / "out"), model_size="tiny")
    convert_cli.convert_meta_checkpoint(str(tmp / "meta"), str(tmp / "out"), model_size="tiny",
                                        to_native=False)
    back, _ = load_checkpoint(tmp / "out" / "native", device="cpu")
    assert torch.equal(back["blocks"]["attn"]["c_attn"]["weight"],
                       params["blocks"]["attn"]["c_attn"]["weight"])
    assert (tmp / "out" / "lit-llama.pth").exists()

    (tmp / "hf").mkdir()
    torch.save({k: v.contiguous() for k, v in native_to_hf_state_dict(params, config).items()},
               tmp / "hf" / "pytorch_model.bin")
    convert_cli.convert_hf_checkpoint(str(tmp / "hf"), str(tmp / "out-hf"), model_size="tiny")
    back, _ = load_checkpoint(tmp / "out-hf" / "native", device="cpu")
    for mod, name in (("attn", "c_attn"), ("mlp", "c_proj")):
        torch.testing.assert_close(back["blocks"][mod][name]["weight"],
                                   params["blocks"][mod][name]["weight"], rtol=0, atol=0)
