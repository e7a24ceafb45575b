"""The port's sharded train step and the three CLIs on gloo ranks (CPU), mirroring the
train-step case of tests/test_parallel.py and tests/test_moe.py's fsdp x tp step.

Oracles: the port's single-rank step and the JAX package's step on the same tree and
batch (the MoE tree against the port's single-rank step, which tests/test_torch_moe.py
holds to JAX's), and each CLI on one rank. Tolerances: losses 1e-5 relative and
parameters after two AdamW steps at lr 1e-2 5e-4 absolute (f32, another summation
order; Adam divides by the root of the second moment, which magnifies the last bits of
a small gradient); the CLIs' losses 1e-5 relative, their tokens equal.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import CharTokenizer, cli_runs, moe_routing, spawn, train_steps
from torch_port_helpers import flat_numpy, random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.train import step as jstep

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.models.moe import (
    MoEConfig,
    forward_moe,
    init_moe_params,
    make_moe_train_step,
)
from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw, make_train_step

CFG = dict(block_size=16, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
MOE_CFG = dict(CFG, n_expert=4, n_expert_active=2, capacity_factor=4.0)


TRAIN_MESHES = {2: [dict(fsdp=2, tp=1), dict(fsdp=1, tp=2)], 4: [dict(dp=2, fsdp=1, tp=2)]}


def _jax_steps(tree_np, batch, n_steps):
    opt = jstep.make_adamw(lambda _: 1e-2, grad_clip=0.5)
    params = jax.tree.map(jnp.asarray, tree_np)
    step = jax.jit(jstep.make_train_step(JConfig(**CFG), opt))
    state, losses = opt.init(params), []
    for _ in range(n_steps):
        params, state, loss = step(params, state, jnp.asarray(batch.numpy()))
        losses.append(float(loss))
    return params, losses


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The dense and the MoE tree, two sharded steps on every mesh of TRAIN_MESHES (one
    spawn a world), with the single-rank port step and the JAX step as oracles."""
    rng = np.random.default_rng(3)
    dense = random_tree(rng, 2, 32, LLaMAConfig(**CFG).n_hidden, 64)
    moe = init_moe_params(torch.Generator().manual_seed(4), MoEConfig(**MOE_CFG), device="cpu")
    cases = {"dense": (to_port(dense), LLaMAConfig(**CFG), False),
             "moe": (moe, MoEConfig(**MOE_CFG), True)}
    batch = torch.as_tensor(rng.integers(0, 64, (2, 4, 17)))
    tmp = tmp_path_factory.mktemp("train")
    ranks = {w: spawn(train_steps, w, tmp, cases, batch, TRAIN_MESHES[w], 2) for w in (2, 4)}
    return dense, cases, batch, ranks


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_sharded_train_step_matches_single_rank_and_jax(train_runs, moe):
    """Two AdamW steps (clip 0.5) on 2 and 4 ranks: the batch over (dp, fsdp), the
    leaves over fsdp and tp; the losses and the gathered parameters against the
    single-rank port step and, for the dense tree, the JAX step."""
    dense, cases, batch, ranks = train_runs
    name = "moe" if moe else "dense"
    cfg = cases[name][1]
    opt = make_adamw(lambda _: 1e-2, grad_clip=0.5)
    ref = jax.tree.map(lambda t: t.clone(), cases[name][0])
    step = (make_moe_train_step if moe else make_train_step)(cfg, opt, device="cpu")
    state, ref_losses = init_opt_state(opt, ref), []
    for _ in range(2):
        ref, state, loss = step(ref, state, batch)
        ref_losses.append(float(loss))
    want, want_jax = flat_numpy(ref), None
    if not moe:
        jparams, jlosses = _jax_steps(dense, batch, 2)
        np.testing.assert_allclose(ref_losses, jlosses, rtol=1e-5)
        want_jax = flat_numpy(jparams)
    for world, meshes in TRAIN_MESHES.items():
        for out in ranks[world]:
            for m in range(len(meshes)):
                got_run = out[f"{m}/{name}"]
                np.testing.assert_allclose(got_run["loss"].numpy(), ref_losses, rtol=1e-5)
                got = flat_numpy(got_run["params"])
                for path in want:
                    np.testing.assert_allclose(got[path], want[path], atol=5e-4,
                                               err_msg=path)
                    if want_jax is not None:
                        np.testing.assert_allclose(got[path], want_jax[path], atol=5e-4,
                                                   err_msg=path)


# --- MoE routing on a batch mesh -------------------------------------------------

DROP_CFG = dict(MOE_CFG, capacity_factor=1.0)
ROUTING_MESHES = [dict(dp=2, fsdp=1, tp=1), dict(fsdp=2, tp=1)]
ROUTING_LR = 1e-3


def test_moe_routing_on_a_batch_mesh_matches_single_rank(tmp_path):
    """At a capacity factor where routes drop, an MoE step whose batch is split over dp 2
    or fsdp 2 routes the global batch as one rank does (the capacity of the global token
    count, the global k-major slot order): the `dropped` share (after the average over the
    ranks), the step's loss and the parameters after one AdamW step at lr 1e-3 equal the
    one-rank step's on the global batch within 1e-6 (f32, the same kept routes; sums in
    another order across ranks)."""
    cfg = MoEConfig(**DROP_CFG)
    moe = init_moe_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    batch = torch.as_tensor(np.random.default_rng(3).integers(0, 64, (2, 4, 17)))
    _, aux = forward_moe(moe, batch[0, :, :-1], cfg, device="cpu")
    assert float(aux["dropped"]) > 0.05  # the capacity binds
    ref = jax.tree.map(lambda t: t.clone(), moe)
    opt = make_adamw(lambda _: ROUTING_LR, grad_clip=0.5)
    ref, _, loss = make_moe_train_step(cfg, opt, device="cpu")(ref, init_opt_state(opt, ref),
                                                               batch)
    want = flat_numpy(ref)
    ranks = spawn(moe_routing, 2, tmp_path, moe, cfg, batch, ROUTING_MESHES, ROUTING_LR)
    for out in ranks:
        for m, dims in enumerate(ROUTING_MESHES):
            got = out[m]
            assert abs(float(got["dropped"]) - float(aux["dropped"])) <= 1e-6, dims
            np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)
            params = flat_numpy(got["params"])
            for path in want:
                np.testing.assert_allclose(params[path], want[path], atol=1e-6,
                                           err_msg=f"{dims} {path}")


# --- the CLIs on 2 ranks --------------------------------------------------------

TINY = dict(block_size=16, vocab_size=256, n_layer=2, n_head=4, n_embd=32)
RUN = dict(model_size="tiny", max_iters=3, warmup_iters=1, learning_rate=1e-2,
           micro_batch_size=2, batch_size=2, save_interval=2, eval_interval=100,
           eval_iters=1, log_interval=1, seed=7, train_prefixes="a", device="cpu")


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory, monkeypatch_module):
    from lit_llama_ja_tpu_torch.core import config as tconfig

    root = tmp_path_factory.mktemp("cli")
    monkeypatch_module.setitem(tconfig.llama_configs, "tiny", TINY)
    rng = np.random.default_rng(0)
    T1 = TINY["block_size"] + 1
    (root / "train").mkdir()
    b = PackedDatasetBuilder(str(root / "train"), "a", T1 * 8, 0, vocab_size=256)
    for _ in range(3):
        b.add_array(rng.integers(1, 256, T1 * 8).astype(np.uint16))
    b.write_reminder()
    config = tconfig.LLaMAConfig.from_name("tiny")
    params = to_port(random_tree(rng, 2, 32, config.n_hidden, 256, std=0.05))
    for key in ("wte", "lm_head"):  # a less uniform next-token distribution
        params[key]["weight"] = params[key]["weight"] * 5
    save_checkpoint(root / "fp", params, config)
    return root


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _losses(out_dir):
    lines = Path(out_dir, "metrics.jsonl").read_text().splitlines()
    return [json.loads(x)["train_loss"] for x in lines if "train_loss" in json.loads(x)]


def test_cli_runs_on_two_ranks_match_one(cli_setup):
    """pretrain_cli ``--fsdp 2`` and ``--tp 2`` (with a resume under ``--fsdp 2``),
    generate_cli ``--tp 2`` and serve_cli ``--tp 2`` on 2 gloo ranks against the same
    CLIs on one rank."""
    from lit_llama_ja_tpu_torch.cli import pretrain_cli

    root = cli_setup
    data = dict(RUN, train_data_dir=str(root / "train"))
    pretrain_cli.main(out_dir=str(root / "one"), **data)
    gen = dict(checkpoint_path=str(root / "fp"), tokenizer_path="unused", prompt="kyoto",
               max_new_tokens=5, temperature=0.0, quantize_kv="int8", device="cpu")
    serve = dict(checkpoint_path=str(root / "fp"), tokenizer_path="unused", prompt="osaka",
                 n_requests=2, max_new_tokens=4, max_seq_length=32, temperature=0.0,
                 quantize_kv="int8", device="cpu")
    single = cli_runs(0, 1, str(root), TINY, [("generate", gen), ("serve", serve)])
    runs = [("pretrain-fsdp", dict(data, out_dir=str(root / "fsdp"), fsdp=2)),
            ("pretrain-tp", dict(data, out_dir=str(root / "tp"), tp=2, fsdp=1)),
            ("pretrain-resume", dict(data, out_dir=str(root / "resume"), fsdp=2, max_iters=3,
                                     resume=str(root / "fsdp" / "state-latest"))),
            ("generate", dict(gen, tp=2)), ("serve", dict(serve, tp=2))]
    out = spawn(cli_runs, 2, root, str(root), TINY, runs)[0]
    want = _losses(root / "one")
    assert len(want) == 3
    np.testing.assert_allclose(_losses(root / "fsdp"), want, rtol=1e-5)
    np.testing.assert_allclose(_losses(root / "tp"), want, rtol=1e-5)
    # the state saved after iter 1 resumes at iter 2 and continues the same losses
    np.testing.assert_allclose(_losses(root / "resume"), want[2:], rtol=1e-5)
    assert out["generate"] == single["generate"] and out["generate"].startswith(
        CharTokenizer().decode(CharTokenizer().encode("kyoto")))
    assert out["serve"].split("\n\n")[0] == single["serve"].split("\n\n")[0]
    assert "--- request 1 ---" in out["serve"]
