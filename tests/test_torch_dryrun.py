"""The port's quick check (`lit_llama_ja_tpu_torch/dryrun.py`) against `__graft_entry__.py`
on the CPU: `entry` against JAX's `entry`, and `main(4, device="cpu")` (4 gloo ranks)
against the port's one-rank steps on the same params.

Tolerances: `entry` runs bf16 on both sides (JAX's params carried across), whose
8-bit mantissa (a relative step of 2^-8) compounds over 6 layers and a 35008-way
head, so the logits agree to 2e-2 of the largest; the mesh steps run f32 on every
side, the sums taken in other orders across ranks, so their losses agree to 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from lit_llama_ja_tpu_torch import dryrun
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import llama
from lit_llama_ja_tpu_torch.models import lora as lora_mod
from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
from lit_llama_ja_tpu_torch.train.step import (
    init_opt_state,
    make_adamw,
    make_sft_train_step,
    make_train_step,
)

BF16_REL = 2e-2
TINY = dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=32)


def test_entry_matches_jax():
    fn, (params, idx) = dryrun.entry(device="cpu")
    assert params["wte"]["weight"].dtype == torch.bfloat16 and idx.shape == (1, 32)
    assert fn(params, idx).shape == (1, 32, 35008)
    jfn, (jparams, jidx) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jidx), np.float32)
    got = fn(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
             torch.tensor(np.asarray(jidx)).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


@pytest.fixture(scope="module")
def run():
    return dryrun.main(4, device="cpu")


def test_main_prints_every_step(run):
    lines = run["lines"]
    assert lines[0] == "mesh: dp=1 fsdp=2 tp=2"
    oks = [line for line in lines[1:] if line.startswith("dryrun_multichip(4): ")]
    assert len(oks) == 6 and all(" OK" in line for line in oks), lines
    assert "pp=2×tp=2×dp=1 GPipe" in lines[3] and "pp=2×tp=2 paged-engine" in lines[4]
    assert "ep=4 MoE (E=8 top-2)" in lines[5] and "T=64 logits=(1, 64, 128)" in lines[6]
    assert set(run["loss"]) == {"train", "lora_sft", "gpipe", "moe_ep"}
    assert all(np.isfinite(v) for v in run["loss"].values())
    assert run["tokens"] == 9 and run["sp_logits_finite"]
    # on the CPU the wrappers run their plain versions: nothing counts as a launch
    assert all(v == 0 for step in run["launches"].values() for v in step.values())


def test_mesh_steps_match_one_rank(run):
    """The dp×fsdp×tp train and LoRA-SFT losses against the port's one-rank steps on
    the same params and batch."""
    config = LLaMAConfig(**TINY)
    batch = torch.as_tensor(np.random.default_rng(0).integers(0, 128, size=(1, 4, 33)))
    params = llama.init_params(torch.Generator().manual_seed(0), config, device="cpu")
    opt = make_adamw(cosine_with_warmup(1e-3, 10, 100, 1e-4))
    _, _, loss = make_train_step(config, opt, device="cpu")(
        params, init_opt_state(opt, params), batch)
    np.testing.assert_allclose(run["loss"]["train"], float(loss), rtol=0, atol=1e-5)

    lp = lora_mod.init_lora_params(torch.Generator().manual_seed(5), config, r=2, alpha=4,
                                   device="cpu")
    tree = lora_mod.add_lora(llama.init_params(torch.Generator().manual_seed(5), config,
                                               device="cpu"), lp)
    opt = make_adamw(1e-3, weight_decay=0.0)
    step = make_sft_train_step(config, opt, trainable_pred=lora_mod.lora_trainable,
                               device="cpu")
    _, _, loss = step(tree, init_opt_state(opt, tree, trainable_pred=lora_mod.lora_trainable),
                      {"input_ids": batch[:, :, :-1], "labels": batch[:, :, 1:]},
                      torch.Generator().manual_seed(6))
    np.testing.assert_allclose(run["loss"]["lora_sft"], float(loss), rtol=0, atol=1e-5)


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.entry()
