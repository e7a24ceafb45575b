"""Parity of the port's training modules (`train/loss.py`, `train/lr.py`,
`train/step.py`, `train/trainer.py`) with the JAX package's, on the CPU.

One numpy parameter tree and the same ``(accum 2, micro 2, T+1)`` batches feed the JAX
step (optax AdamW after a global-norm clip) and the port's. Tolerances: the loss
functions agree to 1e-6 relative; three f32 steps agree to 1e-5 relative in the loss
and 1e-4 absolute in every leaf (the two frameworks sum in other orders, and Adam
turns a last-bit difference in a near-zero gradient into a visible step); with bf16 compute
the losses agree to 1e-2 (both round the params and activations to bf16, at other
places). The resume through a saved train state is bitwise on the CPU.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import flat_numpy, random_tree

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.train import loss as jloss
from lit_llama_ja_tpu.train import step as jstep
from lit_llama_ja_tpu.train.lr import cosine_with_warmup as j_cosine

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.io.checkpoint import (
    flatten_tree,
    load_train_state,
    save_train_state,
)
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.train import loss as tloss
from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
from lit_llama_ja_tpu_torch.train.step import (
    clip_by_global_norm,
    init_opt_state,
    make_adamw,
    make_train_step,
    merge_trees,
    partition_trainable,
)
from lit_llama_ja_tpu_torch.train.trainer import TrainLoopConfig, train_loop

CFG = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
STEPS = 3


def ref_get_lr(it, learning_rate, warmup_iters, lr_decay_iters, min_lr):
    """Reference LR formula (`pretrain/redpajama.py:382-393`) re-stated."""
    if it < warmup_iters:
        return learning_rate * it / warmup_iters
    if it > lr_decay_iters:
        return min_lr
    decay_ratio = (it - warmup_iters) / (lr_decay_iters - warmup_iters)
    coeff = 0.5 * (1.0 + math.cos(math.pi * decay_ratio))
    return min_lr + coeff * (learning_rate - min_lr)


def test_lr_schedule_matches_reference_and_jax():
    sched = cosine_with_warmup(6e-4, 100, 1000, 6e-5)
    jsched = j_cosine(6e-4, 100, 1000, 6e-5)
    for it in [0, 1, 50, 100, 101, 500, 999, 1000, 1001, 5000]:
        want = ref_get_lr(it, 6e-4, 100, 1000, 6e-5)
        np.testing.assert_allclose(sched(it), want, rtol=1e-6)
        np.testing.assert_allclose(sched(it), float(jsched(it)), rtol=1e-6)


@pytest.mark.parametrize("ignore_index", [-1, 3])
def test_loss_functions_match_jax(rng, ignore_index):
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    targets = rng.integers(0, 11, size=(2, 5))
    targets[0, 1] = targets[1, 4] = ignore_index  # masked positions, of either sign
    t_logits, t_targets = torch.from_numpy(logits), torch.from_numpy(targets)
    j_logits, j_targets = jnp.asarray(logits), jnp.asarray(targets)
    got = tloss.cross_entropy_loss(t_logits, t_targets, ignore_index)
    want = jloss.cross_entropy_loss(j_logits, j_targets, ignore_index)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    nll, count = tloss.token_nll_sum(t_logits, t_targets, ignore_index)
    jnll, jcount = jloss.token_nll_sum(j_logits, j_targets, ignore_index)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-6)
    assert int(count) == int(jcount) == int((targets != ignore_index).sum())
    # all positions masked: the mean is 0, not NaN; bf16 logits reduce in f32
    none = torch.full_like(t_targets, ignore_index)
    assert float(tloss.cross_entropy_loss(t_logits, none, ignore_index)) == 0.0
    np.testing.assert_allclose(
        float(tloss.cross_entropy_loss(t_logits.bfloat16(), t_targets, ignore_index)),
        float(jloss.cross_entropy_loss(j_logits.astype(jnp.bfloat16), j_targets, ignore_index)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_is_optax(rng, scale):
    """Below the limit the gradients pass unchanged; above it they take optax's
    factor max_norm / norm, which differs from clip_grad_norm_'s
    max_norm / (norm + 1e-6) by 1e-4 relative at this norm."""
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32) * scale,
             "b": rng.standard_normal((5,)).astype(np.float32) * scale}
    max_norm = 0.05
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-7, atol=0)


def test_adamw_matches_optax(rng):
    """Three updates of a tree with norm scales and an embedding, gradients above and
    below the clip: optax's chain and the port's AdamW move every leaf (weight decay
    included) and both moments alike, with update n at schedule(n)."""
    params = {"wte": {"weight": rng.standard_normal((6, 4)).astype(np.float32)},
              "ln_f": {"scale": (1 + 0.1 * rng.standard_normal(4)).astype(np.float32)}}
    grads = [{k: {n: rng.standard_normal(v.shape).astype(np.float32) * s
                  for n, v in leaf.items()} for k, leaf in params.items()}
             for s in (3.0, 0.01, 2.0)]
    sched, jsched = cosine_with_warmup(0.1, 1, 3, 0.01), j_cosine(0.1, 1, 3, 0.01)

    jopt = jstep.make_adamw(jsched, weight_decay=0.1, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    opt = make_adamw(sched, weight_decay=0.1, grad_clip=1.0)
    tp = params_from_numpy(params, device="cpu")
    ts = opt.init(tp)
    for g in grads:
        updates, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, updates)
        flat_g = {k: torch.from_numpy(v) for k, v in flat_numpy(g).items()}
        opt.apply(flatten_tree(tp), flat_g, ts)
    for k, v in flat_numpy(tp).items():
        np.testing.assert_allclose(v, flat_numpy(jp)[k], rtol=1e-6, atol=1e-7, err_msg=k)
    adam = js[1][0]
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for k, v in flat_numpy(ts[name]).items():
            np.testing.assert_allclose(v, flat_numpy(tree)[k], rtol=1e-5,
                                       atol=1e-6 * np.abs(v).max(), err_msg=k)
    assert int(ts["count"]) == int(adam.count) == 3


def _trees(seed=0):
    cfg = LLaMAConfig(**CFG)
    return random_tree(np.random.default_rng(seed), cfg.n_layer, cfg.n_embd, cfg.n_hidden,
                       cfg.padded_vocab_size)


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(2, 2, CFG["block_size"] + 1))
            for _ in range(STEPS)]


def _only_c_attn(path):
    return "c_attn" in path


CASES = {
    # name: (make_adamw kwargs, make_train_step kwargs)
    "default": ({}, {}),
    "clip_triggers": ({"grad_clip": 1e-3}, {}),
    "remat": ({}, {"remat": True}),
    "trainable_pred": ({}, {"trainable_pred": _only_c_attn}),
    "bf16": ({}, {"compute_dtype": "bf16"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    opt_kw, step_kw = CASES[case]
    tree, batches = _trees(), _batches()
    bf16 = step_kw.get("compute_dtype") == "bf16"

    jcfg = JConfig(**CFG)
    jsched = j_cosine(1e-2, 1, STEPS, 1e-3)
    jopt = jstep.make_adamw(jsched, **opt_kw)
    jkw = dict(step_kw, compute_dtype=jnp.bfloat16) if bf16 else step_kw
    jtrain = jax.jit(jstep.make_train_step(jcfg, jopt, **jkw))
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt_state = jstep.init_opt_state(jopt, jparams, step_kw.get("trainable_pred"))
    jlosses = []
    for b in batches:
        jparams, jopt_state, loss = jtrain(jparams, jopt_state, jnp.asarray(b, jnp.int32))
        jlosses.append(float(loss))

    cfg = LLaMAConfig(**CFG)
    opt = make_adamw(cosine_with_warmup(1e-2, 1, STEPS, 1e-3), **opt_kw)
    tkw = dict(step_kw, compute_dtype=torch.bfloat16) if bf16 else step_kw
    train = make_train_step(cfg, opt, device="cpu", **tkw)
    params = params_from_numpy(tree, device="cpu")
    opt_state = init_opt_state(opt, params, step_kw.get("trainable_pred"))
    losses = []
    for i, b in enumerate(batches):
        params, opt_state, loss = train(params, opt_state, b)
        losses.append(float(loss))
        if i == 0:  # update 0 runs at schedule(0) = 0: nothing moves yet
            for k, v in flat_numpy(params).items():
                np.testing.assert_array_equal(v, flat_numpy(tree)[k])

    np.testing.assert_allclose(losses, jlosses, rtol=1e-2 if bf16 else 1e-5)
    want = flat_numpy(jparams)
    for path, got in flat_numpy(params).items():
        if step_kw.get("trainable_pred") and not _only_c_attn(path):
            np.testing.assert_array_equal(got, flat_numpy(tree)[path], err_msg=path)
            continue
        moved = np.abs(want[path] - flat_numpy(tree)[path]).max()
        assert moved > 0, path
        if not bf16:
            np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-4, err_msg=path)
    assert int(opt_state["count"]) == STEPS


def test_remat_equals_no_remat():
    tree, batches = _trees(2), _batches(3)
    results = []
    for remat in (False, True):
        opt = make_adamw(1e-2)
        train = make_train_step(LLaMAConfig(**CFG), opt, remat=remat, device="cpu")
        params = params_from_numpy(tree, device="cpu")
        opt_state = init_opt_state(opt, params)
        for b in batches:
            params, opt_state, loss = train(params, opt_state, b)
        results.append((float(loss), flat_numpy(params)))
    assert results[0][0] == results[1][0]
    for path, v in results[0][1].items():
        np.testing.assert_array_equal(v, results[1][1][path], err_msg=path)


def test_partition_and_merge_trees():
    params = params_from_numpy(_trees(), device="cpu")
    trainable, frozen = partition_trainable(params, _only_c_attn)
    assert trainable["blocks"]["attn"]["c_attn"]["weight"] is not None
    assert trainable["blocks"]["mlp"]["c_fc1"]["weight"] is None
    assert frozen["blocks"]["attn"]["c_attn"]["weight"] is None
    merged = merge_trees(trainable, frozen)
    for k, v in flat_numpy(merged).items():
        np.testing.assert_array_equal(v, flat_numpy(params)[k])
    opt_state = init_opt_state(make_adamw(1e-3), params, _only_c_attn)
    assert list(opt_state["mu"]) == ["blocks"]
    assert set(opt_state["mu"]["blocks"]) == {"attn"}


def test_train_loop_aborts_on_nan():
    def bad_step(params, opt_state, batch):
        return params, opt_state, torch.tensor(float("nan"))

    def batches():
        while True:
            yield np.zeros((2, 17), np.int64)

    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train_loop(bad_step, {}, {}, batches(),
                   TrainLoopConfig(max_iters=3, grad_accum_steps=1, log_interval=100))


def test_train_state_resume_exact(tmp_path):
    """6 steps straight against 3 steps, a full-state save and load, and 3 more:
    bitwise-identical parameters and optimizer moments on the CPU."""
    cfg = LLaMAConfig(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=16)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 64, (1, 2, 17)) for _ in range(6)]
    tree = random_tree(np.random.default_rng(5), 2, 16, cfg.n_hidden, 64)
    opt = make_adamw(cosine_with_warmup(1e-3, 2, 6, 1e-4), grad_clip=None)
    train = make_train_step(cfg, opt, device="cpu")

    params = params_from_numpy(tree, device="cpu")
    opt_state = init_opt_state(opt, params)
    for b in batches:
        params, opt_state, _ = train(params, opt_state, b)
    want, want_opt = flat_numpy(params), flat_numpy(opt_state)

    params = params_from_numpy(tree, device="cpu")
    opt_state = init_opt_state(opt, params)
    for b in batches[:3]:
        params, opt_state, _ = train(params, opt_state, b)
    save_train_state(tmp_path / "state", params, opt_state, cfg, meta={"iter": 2})
    params2, opt_state2, cfg2, meta = load_train_state(tmp_path / "state", device="cpu")
    assert meta == {"iter": 2} and cfg2 == cfg and int(opt_state2["count"]) == 3
    for b in batches[3:]:
        params2, opt_state2, _ = train(params2, opt_state2, b)
    for k, v in flat_numpy(params2).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for k, v in flat_numpy(opt_state2).items():
        np.testing.assert_array_equal(v, want_opt[k], err_msg=k)
