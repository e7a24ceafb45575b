"""Finetuning on a mesh (`train/step.make_sft_train_step(mesh=)`, `models/adapter.
adapter_forward(mesh=)`, the PEFT leaves on the tensor-parallel linears of
`parallel/sharded.py`, and `cli/finetune_cli.py` under a process group) on the CPU, over
2 and 4 gloo ranks (`test_torch_dist_ranks.spawn`).

Oracles: (a) the port's one-rank SFT step on the same tree, batch and dropout seed;
(b) the JAX package's single-device `make_sft_train_step` at dropout 0, as
`tests/test_train.py::test_sharded_sft_step_matches_unsharded` holds its sharded step.
The tree is the tiny config of `tests/test_train.py` (one layer, 2 heads, 16 wide) from
a numpy seed, with LoRA B, the adapter gating and the v2 scales and biases non-zero, so
that every PEFT leaf moves the logits and gets a gradient; the labels end in ignored
positions of different lengths, so that the ranks' rows hold different label counts.
Tolerances: f32 on every side, the sums taken in other orders across ranks, so losses
and every leaf after two steps agree to 1e-5 absolute; a replicated leaf is equal in
bits on every rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import finetune_cli_runs, mesh_finetune_runs, sft_steps, spawn
from torch_port_helpers import flat_numpy, random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import adapter as jad
from lit_llama_ja_tpu.models import lora as jlora
from lit_llama_ja_tpu.train import step as jstep

from lit_llama_ja_tpu_torch.cli import finetune_cli
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.data.sft import prepare_sample, save_sft_dataset
from lit_llama_ja_tpu_torch.io import checkpoint as tckpt
from lit_llama_ja_tpu_torch.models import adapter as tad

CFG = dict(block_size=16, vocab_size=32, n_layer=1, n_head=2, n_embd=16)
CLI_CFG = dict(CFG, block_size=256)  # the CLIs pad every sample to 256 tokens
ADAPTER = dict(adapter_prompt_length=4, adapter_start_layer=0)
MESHES = {2: [dict(dp=2, fsdp=1, tp=1), dict(fsdp=2, tp=1), dict(fsdp=1, tp=2)],
          4: [dict(fsdp=2, tp=2)]}
CASES = {"full": ("full", 0.0), "lora": ("lora", 0.0), "lora_drop": ("lora", 0.05),
         "adapter": ("adapter", 0.0), "adapter_v2": ("adapter_v2", 0.0)}
JAX_VARIANTS = ("full", "lora", "adapter")
STEPS, LR, ATOL = 2, 1e-3, 1e-5


class FakeTok:
    bos_id, eos_id, pad_id = 1, 2, 0

    def encode(self, s, bos=True, eos=False, max_length=-1, pad=False):
        toks = [3 + (ord(c) % 28) for c in s[:40]]
        toks = ([self.bos_id] if bos else []) + toks + ([self.eos_id] if eos else [])
        return np.asarray(toks[:max_length] if max_length > 0 else toks, np.int32)


def numpy_trees(rng):
    """The numpy trees of every variant, in the layout both packages share."""
    cfg = LLaMAConfig(**CFG)
    L, D, nh = cfg.n_layer, cfg.n_embd, cfg.n_head
    base = random_tree(rng, L, D, cfg.n_hidden, cfg.padded_vocab_size, std=0.3)
    c_attn = base["blocks"]["attn"]["c_attn"]
    lora = {**base, "blocks": {**base["blocks"], "attn": {**base["blocks"]["attn"], "c_attn": {
        **c_attn,
        "lora_A": (rng.standard_normal((L, D, 4)) * 0.3).astype(np.float32),
        "lora_B": (rng.standard_normal((L, 2, 2, D)) * 0.3).astype(np.float32),
        "lora_alpha": np.full((L,), 4.0, np.float32)}}}}
    adapter = {**base, "blocks": {**base["blocks"], "adapter": {
        "adapter_wte": rng.standard_normal((L, ADAPTER["adapter_prompt_length"], D)
                                           ).astype(np.float32),
        "gating_factor": (0.5 * rng.standard_normal((L, nh))).astype(np.float32)}}}
    v2 = jax.tree.map(np.asarray, jad.add_adapter_v2(jax.tree.map(jnp.asarray, adapter)))
    for m, n in tad.V2_LINEARS:
        v2["blocks"][m][n] = dict(v2["blocks"][m][n])
    v2["lm_head"] = dict(v2["lm_head"])
    for leaf in [v2["blocks"][m][n] for m, n in tad.V2_LINEARS] + [v2["lm_head"]]:
        leaf["adapter_scale"] = (1 + 0.2 * rng.standard_normal(leaf["adapter_scale"].shape)
                                 ).astype(np.float32)
        leaf["adapter_bias"] = (0.1 * rng.standard_normal(leaf["adapter_bias"].shape)
                                ).astype(np.float32)
    return {"full": base, "lora": lora, "adapter": adapter, "adapter_v2": v2}


def sft_batch(rng, A=2, B=4, T=12):
    """``(A, B, T)`` ids and labels, each row's labels ignored past a different length."""
    ids = rng.integers(3, CFG["vocab_size"], (A, B, T)).astype(np.int32)
    labels = ids.copy()
    for a in range(A):
        for b in range(B):
            labels[a, b, 3 + (3 * a + 2 * b) % (T - 3):] = -1
    return {"input_ids": ids, "labels": labels}


def configs():
    return LLaMAConfig(**CFG), tad.AdapterConfig(**CFG, **ADAPTER)


def cases(trees):
    cfg, acfg = configs()
    return {name: (to_port(trees[variant]), acfg if variant.startswith("adapter") else cfg,
                   variant, dropout)
            for name, (variant, dropout) in CASES.items()}


def jax_steps(trees, batch):
    """JAX's single-device SFT steps (dropout 0) of ``JAX_VARIANTS``: losses and trees."""
    jcfg = JConfig(**CFG)
    jacfg = jad.AdapterConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)},
                              **ADAPTER)
    setups = {"full": (None, None), "lora": (jlora.lora_trainable, None),
              "adapter": (jad.adapter_trainable,
                          lambda p, x: jad.adapter_forward(p, x, jacfg))}
    out = {}
    for variant in JAX_VARIANTS:
        pred, fwd = setups[variant]
        opt = jstep.make_adamw(LR, weight_decay=0.01)
        fn = jax.jit(jstep.make_sft_train_step(jcfg, opt, forward_fn=fwd, trainable_pred=pred))
        params = jax.tree.map(jnp.asarray, trees[variant])
        state = jstep.init_opt_state(opt, params, trainable_pred=pred)
        losses = []
        for _ in range(STEPS):
            params, state, loss = fn(params, state, jax.tree.map(jnp.asarray, batch),
                                     jax.random.PRNGKey(0))
            losses.append(float(loss))
        out[variant] = (np.asarray(losses), flat_numpy(params))
    return out


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Both worlds' runs, with the one-rank oracles and JAX's steps computed meanwhile;
    the 2-rank world also runs the finetune CLIs (tp 2 and fsdp 2)."""
    root = tmp_path_factory.mktemp("mesh_ft")
    rng = np.random.default_rng(0)
    trees = numpy_trees(rng)
    batch = sft_batch(rng)
    samples = [prepare_sample({"instruction": f"task {i}", "input": "", "output": "done " * i},
                              FakeTok(), 64) for i in range(8)]
    save_sft_dataset(samples, root / "train.pt")
    save_sft_dataset(samples[:4], root / "test.pt")
    tckpt.save_checkpoint(root / "base", to_port(trees["full"]), LLaMAConfig(**CLI_CFG))
    common = dict(data_dir=str(root), pretrained_path=str(root / "base"), max_iters=STEPS,
                  micro_batch_size=2, batch_size=4, device="cpu")
    cli = {"lora_tp": ("main_lora", dict(common, tp=2, lora_r=2, lora_alpha=4,
                                         out_dir=str(root / "lora_tp"))),
           "v2_tp": ("main_adapter_v2", dict(common, tp=2, out_dir=str(root / "v2_tp"))),
           "full_fsdp": ("main_full", dict(common, fsdp=2, out_dir=str(root / "full_fsdp")))}
    one_cli = {name: (main, {**{k: v for k, v in kw.items() if k not in ("tp", "fsdp")},
                             "out_dir": kw["out_dir"] + "_one"})
               for name, (main, kw) in cli.items()}

    def meanwhile():  # fresh trees: the ranks share the storage of the tensors they get
        one = {name: sft_steps(*case, batch, STEPS, LR) for name, case in cases(trees).items()}
        return one, jax_steps(trees, batch), finetune_cli_runs(one_cli)

    ranks, (one, jax_out, one_cli_losses) = spawn(
        mesh_finetune_runs, 2, root, cases(trees), batch, MESHES[2], STEPS, LR, cli,
        meanwhile=meanwhile)
    ranks = {2: ranks, 4: spawn(mesh_finetune_runs, 4, root, cases(trees), batch, MESHES[4],
                                STEPS, LR)}
    return dict(root=root, trees=trees, ranks=ranks, one=one, jax=jax_out,
                one_cli=one_cli_losses)


def _runs(ws, world):
    for m, dims in enumerate(MESHES[world]):
        for name in CASES:
            yield dims, name, [out[f"{m}/{name}"] for out in ws["ranks"][world]]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_sft_step_matches_one_rank(ws, world):
    """Every variant (LoRA at dropout 0 and 0.05) on every mesh: the losses and every
    leaf of the gathered tree against the port's one-rank steps; the PEFT steps leave
    the frozen base as it was, and move what they train."""
    for dims, name, outs in _runs(ws, world):
        want_loss, want_tree = ws["one"][name]
        want = flat_numpy(want_tree)
        before = flat_numpy(cases(ws["trees"])[name][0])
        for out in outs:
            np.testing.assert_allclose(out["loss"].numpy(), want_loss.numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"{dims} {name}")
            got = flat_numpy(out["params"])
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                           err_msg=f"{dims} {name} {k}")
        moved = [k for k in want if not np.array_equal(want[k], before[k])]
        assert moved, name
        if name != "full":
            assert all(k.split("/")[-1] not in ("weight",) for k in moved), (name, moved)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_sft_step_matches_jax(ws, world):
    """Full, LoRA and Adapter v1 at dropout 0 against JAX's single-device SFT step."""
    for dims, name, outs in _runs(ws, world):
        if name not in JAX_VARIANTS:
            continue
        want_loss, want = ws["jax"][name]
        for out in outs:
            np.testing.assert_allclose(out["loss"].numpy(), want_loss, rtol=0, atol=ATOL)
            got = flat_numpy(out["params"])
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                           err_msg=f"{dims} {name} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_leaves_equal_in_bits_on_every_rank(ws, world):
    """After two steps every leaf of spec ``P()`` (the PEFT leaves, the norms) is the
    same bits on every rank: the tp ranks' partial gradients of the cut leaves were
    summed before the update."""
    for dims, name, outs in _runs(ws, world):
        first = outs[0]["replicated"]
        assert any(k.endswith(("lora_A", "gating_factor", "adapter_bias", "scale"))
                   for k in first)
        for out in outs[1:]:
            assert sorted(out["replicated"]) == sorted(first)
            for k, v in out["replicated"].items():
                assert torch.equal(v, first[k]), (dims, name, k)


def test_dropout_masks_are_one_ranks(ws):
    """LoRA at dropout 0.05 differs from dropout 0 (the masks are drawn), and every mesh
    gives the one-rank loss: the masks are those one rank draws."""
    assert not torch.allclose(ws["one"]["lora_drop"][0], ws["one"]["lora"][0], atol=1e-4)


def test_finetune_clis_on_a_mesh_match_one_rank(ws):
    """`main_lora` and `main_adapter_v2` at tp 2 and `main_full` at fsdp 2: the step
    losses and the saves equal the one-rank CLI's; the full save loads back whole."""
    root, got = ws["root"], ws["ranks"][2][0]["cli"]
    for name, want in ws["one_cli"].items():
        assert torch.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)
    for name in ("lora_tp", "v2_tp"):
        with np.load(root / name / "iter-000002.npz") as f, \
                np.load(root / f"{name}_one" / "iter-000002.npz") as g:
            assert sorted(f.files) == sorted(g.files)
            for k in f.files:
                np.testing.assert_allclose(f[k], g[k], rtol=0, atol=ATOL, err_msg=k)
    restored, cfg = tckpt.load_checkpoint(root / "full_fsdp" / "iter-000002", device="cpu")
    want, _ = tckpt.load_checkpoint(root / "full_fsdp_one" / "iter-000002", device="cpu")
    assert cfg == LLaMAConfig(**CLI_CFG)
    got, want = flat_numpy(restored), flat_numpy(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


def test_finetune_mesh_arguments_are_checked(ws):
    """A micro-batch that does not split over dp·fsdp raises JAX's message on the ranks;
    without a process group a mesh of more than one rank raises."""
    assert "micro_batch_size=1 must divide over dp*fsdp=2" in ws["ranks"][2][0]["cli_error"]
    with pytest.raises(ValueError, match="does not cover"):
        finetune_cli.main_lora(data_dir="x", pretrained_path="x", out_dir="x", dp=2,
                               device="cpu")
