"""Parity of the port's finetuning path with the JAX package's, on the CPU: the SFT train
step (`train/step.make_sft_train_step`), the finetune, generate and evaluate CLIs of
the PEFT variants, and the LoRA conversions.

One numpy tree (base, LoRA and adapter leaves drawn from a seed, adapter gating
nonzero) feeds both packages; each package saves it as its own checkpoint, and the
PEFT ``.npz`` files cross between them. Tolerances: losses after three f32 steps
``rtol = 1e-5``, every leaf ``atol = 1e-4`` (as `tests/test_torch_train.py`: Adam
turns a last-bit difference of a near-zero gradient into a visible step); perplexity
``rtol = 1e-4``; f32 weights ``atol = 1e-5 * max|want|``; greedy tokens equal.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import flat_numpy, random_tree, to_port

from lit_llama_ja_tpu.cli import convert_cli as jconvert_cli
from lit_llama_ja_tpu.cli import evaluate_cli as jevaluate_cli
from lit_llama_ja_tpu.cli import generate_finetuned as jgenerate_ft
from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.io import checkpoint as jckpt
from lit_llama_ja_tpu.io.convert import lora_checkpoint_to_native as j_lora_to_native
from lit_llama_ja_tpu.models import adapter as jad
from lit_llama_ja_tpu.models import lora as jlora
from lit_llama_ja_tpu.train import step as jstep
from lit_llama_ja_tpu.train.lr import cosine_with_warmup as j_cosine

from lit_llama_ja_tpu_torch.cli import convert_cli, evaluate_cli, finetune_cli, generate_finetuned
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.data.sft import prepare_sample, save_sft_dataset, sft_batches
from lit_llama_ja_tpu_torch.io import checkpoint as tckpt
from lit_llama_ja_tpu_torch.io.convert import lora_checkpoint_to_native
from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer
from lit_llama_ja_tpu_torch.models import adapter as tad
from lit_llama_ja_tpu_torch.models import llama as tl
from lit_llama_ja_tpu_torch.models import lora as tlora
from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw, make_sft_train_step

CFG = dict(block_size=128, vocab_size=320, n_layer=2, n_head=4, n_embd=32)
ADAPTER = dict(adapter_prompt_length=4, adapter_start_layer=1)
WORDS = ["tokyo", "kyoto", "osaka", "sakura", "yama", "kawa", "umi", "sora", "hana", "tori"]
VARIANTS = ["lora", "adapter", "adapter_v2", "full"]
T, STEPS = 24, 3


class FakeTok:
    bos_id, eos_id, pad_id = 1, 2, 0

    def encode(self, s, bos=True, eos=False, max_length=-1, pad=False):
        toks = [3 + (ord(c) % 60) for c in s[:40]]
        toks = ([self.bos_id] if bos else []) + toks + ([self.eos_id] if eos else [])
        return np.asarray(toks[:max_length] if max_length > 0 else toks, np.int32)


def peft_leaves(rng):
    L, D, nh = CFG["n_layer"], CFG["n_embd"], CFG["n_head"]
    return ({"lora_A": (rng.standard_normal((L, D, 4)) * 0.2).astype(np.float32),
             "lora_B": (rng.standard_normal((L, 2, 2, D)) * 0.2).astype(np.float32),
             "lora_alpha": np.full((L,), 4.0, np.float32)},
            {"adapter_wte": rng.standard_normal((L, ADAPTER["adapter_prompt_length"], D)
                                                ).astype(np.float32),
             "gating_factor": (0.5 * rng.standard_normal((L, nh))).astype(np.float32)})


def v2_tree(rng, tree):
    """The v2 tree of ``tree`` with random scales and biases."""
    out = jax.tree.map(np.asarray, jad.add_adapter_v2(jax.tree.map(jnp.asarray, tree)))
    for leaf in [out["blocks"][m][n] for m, n in tad.V2_LINEARS] + [out["lm_head"]]:
        leaf["adapter_scale"] = (1 + 0.2 * rng.standard_normal(leaf["adapter_scale"].shape)
                                 ).astype(np.float32)
        leaf["adapter_bias"] = (0.1 * rng.standard_normal(leaf["adapter_bias"].shape)
                                ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A tokenizer, a text file, an SFT dataset, the base as a checkpoint of each
    package, and the PEFT leaves."""
    root = tmp_path_factory.mktemp("ft")
    rng = np.random.default_rng(7)
    text = root / "corpus.txt"
    text.write_text("\n".join(" ".join(rng.choice(WORDS, size=10)) for _ in range(60)))
    tok = HFTokenizer.train(str(text), str(root), vocab_size=300)
    config = LLaMAConfig(**CFG)
    base = random_tree(rng, config.n_layer, config.n_embd, config.n_hidden, config.vocab_size,
                       std=0.3)
    jckpt.save_checkpoint(root / "base_jax", jax.tree.map(jnp.asarray, base), JConfig(**CFG))
    tckpt.save_checkpoint(root / "base_torch", to_port(base), config)
    samples = [prepare_sample({"instruction": f"task {i}", "input": "", "output": "done " * i},
                              FakeTok(), T) for i in range(8)]
    save_sft_dataset(samples, root / "train.pt")
    save_sft_dataset(samples[:4], root / "test.pt")
    lora, adapter = peft_leaves(rng)
    return dict(root=root, text=str(text), tok=tok, base=base, lora=lora, adapter=adapter,
                rng=rng, samples=samples)


def variant_setup(ws, variant):
    """(tree, JAX trainable predicate, port predicate, JAX forward, port forward)."""
    base, rng = ws["base"], np.random.default_rng(11)
    jcfg = jad.AdapterConfig(**CFG, **ADAPTER)
    tcfg = tad.AdapterConfig(**CFG, **ADAPTER)
    if variant == "lora":
        return jlora.add_lora(base, ws["lora"]), jlora.lora_trainable, tlora.lora_trainable, \
            None, None
    if variant == "full":
        return base, None, None, None, None
    tree = jad.add_adapter(base, ws["adapter"])
    jpred, tpred = jad.adapter_trainable, tad.adapter_trainable
    if variant == "adapter_v2":
        tree, jpred, tpred = v2_tree(rng, tree), jad.adapter_v2_trainable, tad.adapter_v2_trainable
    return (tree, jpred, tpred, lambda p, x: jad.adapter_forward(p, x, jcfg),
            lambda p, x: tad.adapter_forward(p, x, tcfg, device="cpu"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_sft_step_matches_jax(ws, variant):
    """Three SFT steps (2 micro-batches of 2, dropout 0): the losses and every leaf
    against JAX's; a PEFT step leaves the frozen leaves bit-identical."""
    tree, jpred, tpred, jfwd, tfwd = variant_setup(ws, variant)
    batches = sft_batches(ws["samples"], 2, T, seed=3)
    data = [{k: np.stack([m[k] for m in (next(batches), next(batches))])
             for k in ("input_ids", "labels")} for _ in range(STEPS)]

    jopt = jstep.make_adamw(j_cosine(1e-2, 1, STEPS, 1e-3), weight_decay=0.02)
    jfn = jax.jit(jstep.make_sft_train_step(JConfig(**CFG), jopt, forward_fn=jfwd,
                                            trainable_pred=jpred))
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt_state = jstep.init_opt_state(jopt, jparams, trainable_pred=jpred)
    topt = make_adamw(cosine_with_warmup(1e-2, 1, STEPS, 1e-3), weight_decay=0.02)
    tfn = make_sft_train_step(LLaMAConfig(**CFG), topt, forward_fn=tfwd, trainable_pred=tpred,
                              device="cpu")
    tparams = to_port(tree)
    topt_state = init_opt_state(topt, tparams, trainable_pred=tpred)
    for batch in data:
        jparams, jopt_state, jloss = jfn(jparams, jopt_state, jax.tree.map(jnp.asarray, batch),
                                         jax.random.PRNGKey(0))
        tparams, topt_state, tloss = tfn(tparams, topt_state, batch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got, want, before = flat_numpy(tparams), flat_numpy(jparams), flat_numpy(tree)
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
        if tpred is not None and not tpred(k):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
        moved += not np.array_equal(got[k], before[k])
    assert moved > 0


def run_finetune(ws, variant, out, **kw):
    return finetune_cli._finetune_driver(
        data_dir=str(ws["root"]), pretrained_path=str(ws["root"] / "base_torch"),
        out_dir=str(out), variant=variant, learning_rate=1e-2, weight_decay=0.0,
        micro_batch_size=2, batch_size=4, max_iters=3, warmup_iters=1, max_seq_length=T,
        eval_interval=2, save_interval=2, eval_iters=2, log_interval=1, lora_r=2,
        lora_alpha=4, device="cpu", **kw)


@pytest.mark.parametrize("variant", VARIANTS)
def test_finetune_cli_end_to_end(ws, tmp_path, capsys, variant):
    """`_finetune_driver`, shared by the four finetune CLIs: logged losses, a validation, saves at
    iteration 1 and at the end; a PEFT save holds the JAX package's keys for the
    variant, and leaves the frozen leaves as loaded."""
    params = run_finetune(ws, variant, tmp_path)
    log = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss (\S+), time", log)]
    assert len(losses) == 3 and all(np.isfinite(losses)), log
    assert "step 1: val loss" in log and f"Saving {variant} weights" in log
    base = flat_numpy(ws["base"])
    if variant == "full":
        saved = sorted(p.name for p in tmp_path.iterdir())
        assert saved == ["iter-000001", "iter-000003"]
        restored, cfg = tckpt.load_checkpoint(tmp_path / "iter-000003", device="cpu")
        assert cfg == LLaMAConfig(**CFG)
        assert sorted(flat_numpy(restored)) == sorted(base)
        return
    assert sorted(p.name for p in tmp_path.iterdir()) == ["iter-000001.npz", "iter-000003.npz"]
    with np.load(tmp_path / "iter-000003.npz") as f:
        keys = sorted(f.files)
    tree, _, tpred, _, _ = variant_setup(ws, variant)
    extract = {"lora": jlora.extract_lora, "adapter": jad.extract_adapter_state,
               "adapter_v2": jad.extract_adapter_v2_state}[variant]
    assert keys == sorted(extract(jax.tree.map(jnp.asarray, tree)))
    for k, v in flat_numpy(params).items():
        if not tpred(k) and "lora_alpha" not in k and k in base:
            np.testing.assert_array_equal(v, base[k], err_msg=k)


def jax_greedy(fn, capsys, **kw):
    fn(**kw, max_new_tokens=5, temperature=0.0)
    return capsys.readouterr().out


@pytest.mark.parametrize("variant", ["lora", "adapter"])
def test_npz_crosses_packages_and_generates_the_same_tokens(ws, tmp_path, capsys, variant):
    """A PEFT ``.npz`` written by one package loads in the other's
    `generate_finetuned`, both ways, and both give the same greedy text."""
    leaves = ws["lora"] if variant == "lora" else {f"adapter/{k}": v
                                                  for k, v in ws["adapter"].items()}
    jckpt.save_state_npz(tmp_path / "jax.npz", leaves)
    tckpt.save_state_npz(tmp_path / "torch.npz", to_port(leaves))
    arg = "lora_path" if variant == "lora" else "adapter_path"
    main = "main_lora" if variant == "lora" else "main_adapter"
    common = dict(prompt="tokyo kyoto", tokenizer_path=ws["tok"])
    want = jax_greedy(getattr(jgenerate_ft, main), capsys, **common,
                      checkpoint_path=str(ws["root"] / "base_jax"),
                      **{arg: str(tmp_path / "torch.npz")})
    ids = getattr(generate_finetuned, main)(**common, checkpoint_path=str(ws["root"] / "base_torch"),
                                            max_new_tokens=5, temperature=0.0, device="cpu",
                                            **{arg: str(tmp_path / "jax.npz")})
    got = capsys.readouterr().out
    assert got == want and len(ids) > 5


def v1_layout(state):
    """A v2 state in the layout the JAX CLIs read: the v1 leaves under ``adapter/``."""
    return {k.replace("blocks/adapter/", "adapter/"): v for k, v in state.items()}


@pytest.mark.parametrize("variant", ["lora", "adapter", "adapter_v2"])
def test_evaluate_peft_matches_jax(ws, tmp_path, capsys, variant):
    if variant == "lora":
        state, main, kw = ws["lora"], "main_lora", {}
    else:
        tree = jad.add_adapter(ws["base"], ws["adapter"])
        state = {f"adapter/{k}": v for k, v in ws["adapter"].items()}
        main, kw = "main_adapter", {}
        if variant == "adapter_v2":
            state = v1_layout(jad.extract_adapter_v2_state(v2_tree(ws["rng"], tree)))
            kw = dict(v2=True)
    npz = tmp_path / "state.npz"
    jckpt.save_state_npz(npz, jax.tree.map(np.asarray, state))
    arg = "lora_path" if variant == "lora" else "adapter_path"
    common = dict(datasets=ws["text"], tokenizer_path=ws["tok"], **{arg: str(npz)}, **kw)
    getattr(jevaluate_cli, main)(checkpoint_path=str(ws["root"] / "base_jax"), **common)
    want = float(re.search(r"perplexity (\S+)", capsys.readouterr().out).group(1))
    got = getattr(evaluate_cli, main)(checkpoint_path=str(ws["root"] / "base_torch"),
                                      device="cpu", **common)
    assert list(got) == [ws["text"]]
    np.testing.assert_allclose(got[ws["text"]], want, rtol=1e-4)


def test_v2_state_of_the_finetune_cli_loads_in_the_port(ws, tmp_path):
    """`extract_adapter_v2_state` keeps the v1 leaves under ``blocks/adapter``: the
    port's loader reads them there, where the JAX CLIs look under ``adapter/`` alone and
    raise (ROADMAP.md, queue 3)."""
    tree = v2_tree(ws["rng"], jad.add_adapter(ws["base"], ws["adapter"]))
    state = tad.extract_adapter_v2_state(to_port(tree))
    tckpt.save_state_npz(tmp_path / "v2.npz", state)
    params, acfg = generate_finetuned.load_adapter(ws["root"] / "base_torch", tmp_path / "v2.npz",
                                                   None, True, torch.device("cpu"))
    got, want = flat_numpy(params), flat_numpy(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError, match="adapter"):
        jevaluate_cli.main_adapter(datasets=ws["text"], adapter_path=str(tmp_path / "v2.npz"),
                                   checkpoint_path=str(ws["root"] / "base_jax"),
                                   tokenizer_path=ws["tok"], v2=True)


def test_convert_lora_weights_matches_jax(ws, tmp_path, capsys):
    npz = tmp_path / "lora.npz"
    tckpt.save_state_npz(npz, to_port(ws["lora"]))
    jconvert_cli.convert_lora_weights(str(npz), str(ws["root"] / "base_jax"), str(tmp_path / "j"))
    convert_cli.convert_lora_weights(str(npz), str(ws["root"] / "base_torch"),
                                     str(tmp_path / "t"), device="cpu")
    assert "saved merged checkpoint" in capsys.readouterr().out
    want, _ = jckpt.load_checkpoint(tmp_path / "j")
    got, cfg = tckpt.load_checkpoint(tmp_path / "t", device="cpu")
    assert cfg == LLaMAConfig(**CFG)
    got, want = flat_numpy(got), flat_numpy(want)
    assert sorted(got) == sorted(want) and "blocks/attn/c_attn/lora_A" not in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max())
    # the merged checkpoint's logits are the base's with the LoRA branch
    idx = torch.as_tensor(ws["rng"].integers(0, CFG["vocab_size"], (1, 16)))
    merged = tl.forward(tckpt.load_checkpoint(tmp_path / "t", device="cpu")[0], idx,
                        LLaMAConfig(**CFG), device="cpu")
    branch = tl.forward(to_port(jlora.add_lora(ws["base"], ws["lora"])), idx,
                        LLaMAConfig(**CFG), device="cpu")
    torch.testing.assert_close(merged, branch, rtol=0, atol=1e-5 * branch.abs().max().item())


def test_lora_checkpoint_to_native_matches_jax(rng):
    L, D, g, r = 3, 16, 2, 4
    sd = {}
    for i in range(L):
        sd[f"transformer.h.{i}.attn.c_attn.lora_A"] = torch.randn(g * r, D)
        sd[f"transformer.h.{i}.attn.c_attn.lora_B"] = torch.randn(g * D, r)
    cfg = dict(n_layer=L, n_embd=D, n_head=2, vocab_size=64)
    got = lora_checkpoint_to_native(sd, LLaMAConfig(**cfg), alpha=16)
    want = j_lora_to_native(sd, JConfig(**cfg), alpha=16)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


CALLS = {
    "generate_lora": (jgenerate_ft.main_lora, generate_finetuned.main_lora, "lora",
                      dict(prompt="tokyo", max_new_tokens=2)),
    "evaluate_lora": (jevaluate_cli.main_lora, evaluate_cli.main_lora, "lora", {}),
    "generate_adapter_v2": (jgenerate_ft.main_adapter, generate_finetuned.main_adapter,
                            "adapter", dict(prompt="tokyo", max_new_tokens=2, v2=True)),
    "evaluate_adapter_v2": (jevaluate_cli.main_adapter, evaluate_cli.main_adapter, "adapter",
                            dict(v2=True)),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_peft_on_a_quantized_base_raises_in_both_packages(ws, tmp_path, call):
    """The reference quirks the port keeps: merging LoRA into a quantized base and
    Adapter v2 on one both need a plain ``weight`` and raise KeyError('weight')."""
    jfn, tfn, kind, kw = CALLS[call]
    npz = tmp_path / "state.npz"
    leaves = ws["lora"] if kind == "lora" else {f"adapter/{k}": v for k, v in ws["adapter"].items()}
    jckpt.save_state_npz(npz, leaves)
    if "generate" not in call:
        kw = dict(kw, datasets=ws["text"])
    kw = dict(kw, tokenizer_path=ws["tok"], quantize="llm.int8",
              **{f"{kind}_path": str(npz)})
    with pytest.raises(KeyError, match="weight"):
        jfn(checkpoint_path=str(ws["root"] / "base_jax"), **kw)
    with pytest.raises(KeyError, match="weight"):
        tfn(checkpoint_path=str(ws["root"] / "base_torch"), device="cpu", **kw)


def test_finetune_refuses_meshes(ws, tmp_path):
    """Without a process group a mesh of two ranks is refused (the meshes themselves run
    under one: tests/test_torch_mesh_finetune.py)."""
    for kw in (dict(dp=2), dict(fsdp=2), dict(tp=2)):
        with pytest.raises(ValueError, match="does not cover 1 ranks"):
            finetune_cli.main_lora(data_dir=str(ws["root"]), out_dir=str(tmp_path),
                                   pretrained_path=str(ws["root"] / "base_torch"),
                                   device="cpu", **kw)


def test_new_entry_points_need_the_card_unless_asked_for_the_cpu(ws, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, cfg = ws["root"], LLaMAConfig(**CFG)
    acfg = tad.AdapterConfig(**CFG, **ADAPTER)
    npz = tmp_path / "lora.npz"
    jckpt.save_state_npz(npz, ws["lora"])
    tree = to_port(jad.add_adapter(ws["base"], ws["adapter"]))
    ids = torch.zeros((1, 3), dtype=torch.long)
    calls = [
        lambda: finetune_cli.main_lora(data_dir=str(root), out_dir=str(tmp_path),
                                       pretrained_path=str(root / "base_torch")),
        lambda: finetune_cli.main_full(data_dir=str(root), out_dir=str(tmp_path),
                                       pretrained_path=str(root / "base_torch")),
        lambda: generate_finetuned.main_lora(lora_path=str(npz), tokenizer_path=ws["tok"],
                                             checkpoint_path=str(root / "base_torch")),
        lambda: generate_finetuned.main_adapter(adapter_path=str(npz), tokenizer_path=ws["tok"],
                                                checkpoint_path=str(root / "base_torch")),
        lambda: evaluate_cli.main_lora(lora_path=str(npz), tokenizer_path=ws["tok"],
                                       checkpoint_path=str(root / "base_torch")),
        lambda: convert_cli.convert_lora_weights(str(npz), str(root / "base_torch"),
                                                 str(tmp_path / "m")),
        lambda: tlora.init_lora_params(torch.Generator(), cfg, r=2),
        lambda: tad.init_adapter_params(torch.Generator(), acfg),
        lambda: tad.adapter_forward(tree, ids, acfg),
        lambda: tad.adapter_forward_with_cache(tree, ids, torch.arange(3),
                                               tl.init_kv_cache(cfg, 1, 4, device="cpu"), acfg),
        lambda: make_sft_train_step(cfg, make_adamw(1e-3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
