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


@pytest.mark.parametrize("kw", [dict(dp=2), dict(tp=2), dict(fsdp=2)])
def test_pretrain_cli_refuses_meshes_and_moe(tmp_path, kw):
    """Without a process group the world is one rank: a mesh of two is refused (the
    sharded CLI runs are in tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="does not cover 1 ranks"):
        pretrain_cli.main(out_dir=str(tmp_path), device="cpu", **kw)


# --- MoE through both CLIs, one data source (the C++ reader on both sides) ---------

MOE = dict(moe_experts=4, moe_topk=2)
MOE_RUN = dict(RUN, train_prefixes="a", val_prefixes="a", max_iters=4, save_interval=2,
               eval_interval=2, **MOE)


@pytest.fixture
def moe_init(tmp_path, monkeypatch, tiny):
    """The initial MoE weights as a port checkpoint and a JAX (Orbax) checkpoint, and
    the JAX CLI confined to one of the tests' virtual devices."""
    from lit_llama_ja_tpu.core import config as jconfig
    from lit_llama_ja_tpu.io.checkpoint import save_checkpoint as j_save
    from lit_llama_ja_tpu.models.moe import MoEConfig as JMoE
    from lit_llama_ja_tpu.parallel import mesh as jmesh

    from lit_llama_ja_tpu_torch.models.moe import MoEConfig

    monkeypatch.setitem(jconfig.llama_configs, "tiny", TINY)
    one = jax.devices()[:1]
    make_mesh = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda **kw: make_mesh(devices=one, **kw))
    cfg = MoEConfig.from_name("tiny", n_expert=4, n_expert_active=2)
    rng = np.random.default_rng(5)
    tree = random_tree(rng, cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.padded_vocab_size)
    mlp = tree["blocks"].pop("mlp")
    tree["blocks"]["moe"] = {
        "router": {"weight": rng.standard_normal((cfg.n_layer, cfg.n_embd, 4)).astype(
            np.float32)},
        **{k: {"weight": np.stack([v["weight"] * (1 + 0.2 * e) for e in range(4)], axis=1)}
           for k, v in mlp.items()}}
    save_checkpoint(tmp_path / "init_port", params_from_numpy(tree, device="cpu"), cfg)
    j_save(tmp_path / "init_jax", jax.tree.map(jnp.asarray, tree),
           JMoE.from_name("tiny", n_expert=4, n_expert_active=2))
    return tmp_path / "init_port", tmp_path / "init_jax"


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("step", "tokens_per_sec")}
            for r in records]


def test_moe_pretrain_cli_matches_the_jax_cli(tmp_path, data, moe_init, monkeypatch, capsys):
    """Four steps of a 4-expert top-2 model through both CLIs from the same weights
    and the same single source: the same losses and learning rates (1e-4, f32); the
    port's `--resume` from the state saved after iter 1 continues bit for bit. The
    JAX CLI's resume of an MoE state raises in `load_train_state`, which rebuilds a
    dense `LLaMAConfig` from the expert fields (ROADMAP.md, queue 3)."""
    from lit_llama_ja_tpu.cli import pretrain_cli as j_cli

    port_init, jax_init = moe_init
    saved = pretrain_cli.save_train_state

    def save_and_snapshot(path, params, opt_state, config, meta):
        saved(path, params, opt_state, config, meta)
        if meta["iter"] == 1:
            shutil.copytree(path, tmp_path / "state-iter1")

    monkeypatch.setattr(pretrain_cli, "save_train_state", save_and_snapshot)
    common = dict(train_data_dir=str(data / "train"), **{k: v for k, v in MOE_RUN.items()
                                                          if k != "device"})
    pretrain_cli.main(out_dir=str(tmp_path / "port"), load_dir=str(port_init), device="cpu",
                      **common)
    assert "using native C++ packed reader" in capsys.readouterr().out
    got = _metrics(tmp_path / "port")
    # one save of the JAX run's state (after iter 3), for its resume below
    j_cli.main(out_dir=str(tmp_path / "jax"), load_dir=str(jax_init),
               **{**common, "save_interval": 4})
    want = _metrics(tmp_path / "jax")
    assert [r["iter"] for r in got] == [r["iter"] for r in want] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    from lit_llama_ja_tpu_torch.io.checkpoint import load_checkpoint
    from lit_llama_ja_tpu_torch.models.moe import MoEConfig

    _, cfg = load_checkpoint(tmp_path / "port" / "iter-000004-ckpt", device="cpu")
    assert isinstance(cfg, MoEConfig) and cfg.n_expert == 4

    resumed_dir = tmp_path / "resumed"
    pretrain_cli.main(out_dir=str(resumed_dir), resume=str(tmp_path / "state-iter1"),
                      device="cpu", **common)
    assert _strip(_metrics(resumed_dir)) == _strip(got[2:])
    with pytest.raises(TypeError, match="n_expert"):
        j_cli.main(out_dir=str(tmp_path / "jax_resumed"),
                   resume=str(tmp_path / "jax" / "state-latest"), **common)


def test_moe_validation_raises_in_both_clis(tmp_path, data, moe_init):
    """The JAX CLI validates an MoE model with the dense forward, which finds no
    ``mlp`` leaf: KeyError('mlp') at the first evaluation. The port keeps it."""
    from lit_llama_ja_tpu.cli import pretrain_cli as j_cli

    port_init, jax_init = moe_init
    common = dict(train_data_dir=str(data / "train"), val_data_dir=str(data / "val"),
                  **{k: v for k, v in MOE_RUN.items() if k != "device"})
    with pytest.raises(KeyError, match="mlp"):
        j_cli.main(out_dir=str(tmp_path / "jax"), load_dir=str(jax_init), **common)
    with pytest.raises(KeyError, match="mlp"):
        pretrain_cli.main(out_dir=str(tmp_path / "port"), load_dir=str(port_init),
                          device="cpu", **common)
    # both trained up to the first evaluation
    assert [r["iter"] for r in _metrics(tmp_path / "port")] == [0, 1]


def test_native_reader_falls_back_to_the_python_reader(tmp_path, data, init_dir, monkeypatch,
                                                       capsys):
    """Where the C++ reader does not build, the CLI says so and reads the single
    source through the Python reader."""
    from lit_llama_ja_tpu_torch.data import native_loader

    def no_reader(*args, **kw):
        raise RuntimeError("g++ packed_reader.cpp failed")

    monkeypatch.setattr(native_loader, "NativePackedBatches", no_reader)
    run = dict(RUN, train_prefixes="a", max_iters=2)
    pretrain_cli.main(train_data_dir=str(data / "train"), out_dir=str(tmp_path / "out"),
                      load_dir=str(init_dir[0]), **run)
    out = capsys.readouterr().out
    assert "native reader unavailable (g++ packed_reader.cpp failed); using Python reader" in out
    assert [r["iter"] for r in _metrics(tmp_path / "out")] == [0, 1]


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
