"""The pretraining slice as a whole, on the CPU: the port's `pretrain_cli.main`
(``device="cpu"``) on a tiny config registered for the test, reading two data
prefixes, against the JAX package's `make_train_step` + `train_loop` on the same
initial weights and the same batches (the JAX package's own `create_dataset` and
`batch_iterator`). The JAX CLI itself is not the oracle: it would shard over the
tests' 8 virtual devices and take its C++ reader for a single source.

Tolerance: the metrics' train and validation losses agree to 1e-4 (f32 on both sides,
summed in other orders). ``--resume`` from a saved train state continues bitwise.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_helpers import random_tree

from lit_llama_ja_tpu.cli.pretrain_cli import create_dataset as j_create_dataset
from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.data.packed_dataset import batch_iterator as j_batch_iterator
from lit_llama_ja_tpu.train import step as jstep
from lit_llama_ja_tpu.train import trainer as jtrainer
from lit_llama_ja_tpu.train.lr import cosine_with_warmup as j_cosine

from lit_llama_ja_tpu_torch.cli import pretrain_cli
from lit_llama_ja_tpu_torch.core import config as tconfig
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy

REPO = Path(__file__).resolve().parents[1]
TINY = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
RUN = dict(model_size="tiny", max_iters=6, warmup_iters=2, learning_rate=1e-2,
           micro_batch_size=2, batch_size=4, save_interval=3, eval_interval=3, eval_iters=2,
           log_interval=1, seed=7, train_prefixes="a,b", val_prefixes="a,b", device="cpu")


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(tconfig.llama_configs, "tiny", TINY)
    return tconfig.LLaMAConfig.from_name("tiny")


@pytest.fixture
def data(tmp_path):
    """Two prefixes of packed chunk files for train and for val."""
    rng = np.random.default_rng(0)
    T1 = TINY["block_size"] + 1
    for split in ("train", "val"):
        os.makedirs(tmp_path / split)
        for prefix in ("a", "b"):
            b = PackedDatasetBuilder(str(tmp_path / split), prefix, T1 * 8, 0, vocab_size=64)
            for _ in range(3):
                b.add_array(rng.integers(1, 64, T1 * 8).astype(np.uint16))
            b.write_reminder()
    return tmp_path


@pytest.fixture
def init_dir(tmp_path, tiny):
    """The initial weights, as a port checkpoint for ``--load-dir``."""
    tree = random_tree(np.random.default_rng(1), tiny.n_layer, tiny.n_embd, tiny.n_hidden,
                       tiny.padded_vocab_size)
    save_checkpoint(tmp_path / "init", params_from_numpy(tree, device="cpu"), tiny)
    return tmp_path / "init", tree


def _metrics(out_dir):
    lines = Path(out_dir, "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _run_jax(tree, data, out_dir):
    """The JAX package's step and loop with the CLI's settings and reader."""
    cfg = JConfig(**TINY)
    sched = j_cosine(RUN["learning_rate"], RUN["warmup_iters"], RUN["max_iters"],
                     RUN["learning_rate"] / 10)
    opt = jstep.make_adamw(sched, weight_decay=0.1, grad_clip=1.0)
    params = jax.tree.map(jnp.asarray, tree)
    mix = [("a", 1.0), ("b", 1.0)]
    seed, mb = RUN["seed"], RUN["micro_batch_size"]
    train_ds = j_create_dataset(str(data / "train"), mix, cfg.block_size + 1, seed=seed + 1)
    val_ds = j_create_dataset(str(data / "val"), mix, cfg.block_size + 1, seed=seed + 2,
                              shuffle=False)
    validate = jtrainer.make_validate_fn(cfg, RUN["eval_iters"],
                                         lambda: j_batch_iterator(val_ds, mb))
    os.makedirs(out_dir)
    loop_cfg = jtrainer.TrainLoopConfig(
        max_iters=RUN["max_iters"], log_interval=1, eval_interval=RUN["eval_interval"],
        save_interval=10**9, eval_iters=RUN["eval_iters"],
        grad_accum_steps=RUN["batch_size"] // mb, micro_batch_size=mb,
        block_size=cfg.block_size, metrics_file=str(Path(out_dir) / "metrics.jsonl"))
    jtrainer.train_loop(jax.jit(jstep.make_train_step(cfg, opt)), params,
                        jstep.init_opt_state(opt, params), j_batch_iterator(iter(train_ds), mb),
                        loop_cfg, lr_schedule=sched, validate_fn=validate)
    return _metrics(out_dir)


def _run_port(data, out_dir, **kw):
    pretrain_cli.main(train_data_dir=str(data / "train"), val_data_dir=str(data / "val"),
                      out_dir=str(out_dir), **{**RUN, **kw})
    return _metrics(out_dir)


def test_pretrain_cli_matches_jax_and_resumes_exactly(tmp_path, data, init_dir, monkeypatch):
    load_dir, tree = init_dir
    saved = pretrain_cli.save_train_state

    def save_and_snapshot(path, params, opt_state, config, meta):
        saved(path, params, opt_state, config, meta)
        if meta["iter"] == 2:  # keep the mid-run state that a later save overwrites
            shutil.copytree(path, tmp_path / "state-iter2")

    monkeypatch.setattr(pretrain_cli, "save_train_state", save_and_snapshot)
    got = _run_port(data, tmp_path / "port", load_dir=str(load_dir))
    want = _run_jax(tree, data, tmp_path / "jax")

    assert [r["iter"] for r in got] == [r["iter"] for r in want] == [0, 1, 2, 2, 3, 4, 5, 5]
    for g, w in zip(got, want):
        key = "train_loss" if "train_loss" in g else "val_loss"
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4, err_msg=str(g))
        if key == "train_loss":
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    out = tmp_path / "port"
    assert {"iter-000002-ckpt", "iter-000005-ckpt", "iter-000006-ckpt", "state-latest"} <= set(
        os.listdir(out))
    assert json.loads((out / "state-latest" / "meta.json").read_text()) == {"iter": 5}

    # iters 3-5 again from the state saved after iter 2: the same losses, bit for bit
    # (the step counter and the speed are the new run's own)
    resumed = _run_port(data, tmp_path / "resumed", resume=str(tmp_path / "state-iter2"))

    def strip(records):
        return [{k: v for k, v in r.items() if k not in ("step", "tokens_per_sec")}
                for r in records]

    assert strip(resumed) == strip(got[4:])


@pytest.mark.parametrize("kw", [dict(dp=2), dict(tp=2), dict(fsdp=2), dict(moe_experts=4)])
def test_pretrain_cli_refuses_meshes_and_moe(tmp_path, kw):
    with pytest.raises(NotImplementedError, match="slice 7"):
        pretrain_cli.main(out_dir=str(tmp_path), device="cpu", **kw)


def test_shakespeare_and_module_entry_point(tmp_path):
    data_dir = tmp_path / "shakespeare"
    os.makedirs(data_dir)
    np.random.default_rng(2).integers(0, 100, 400).astype(np.uint16).tofile(
        data_dir / "train.bin")
    pretrain_cli.main_shakespeare(data_dir=str(data_dir), out_dir=str(tmp_path / "out"),
                                  max_iters=2, block_size=16, n_layer=1, n_head=2, n_embd=16,
                                  micro_batch_size=2, log_interval=1, device="cpu")
    assert (tmp_path / "out" / "final" / "params.pt").exists()
    help_text = subprocess.run(
        [sys.executable, "-m", "lit_llama_ja_tpu_torch.cli.pretrain_cli", "-h"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=120).stdout
    assert "--resume" in help_text and "--device" in help_text
