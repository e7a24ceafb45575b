"""The training steps as bodies (`train/step.TrainStep`, `train/trainer.make_val_loss`,
`infer/decode_graph.TrainGraphs`), on the CPU: each body, run in a host loop through
the same staging as the captured step on the card, against the JAX package's jitted
step and validation loss, and against the port's eager step.

Every body runs under `torch_port_helpers.guarded_bodies` (no host read, no tensor built
from host data), which counts the training bodies (``train``) and the validations
(``val``). One numpy tree feeds both packages (`io/from_jax.params_from_numpy`).
Tolerances, as `tests/test_torch_train.py` states them for three f32 steps: losses
``rtol = 1e-5``, every leaf ``atol = 1e-4``; the AdamW moments (which optax keeps in
f32 too) ``atol = 1e-4`` of their largest magnitude; a validation loss ``rtol = 1e-5``.
The body against the port's eager step (``cuda_graph=False``): equal in bits.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import flat_numpy, guarded_bodies, random_tree  # noqa: F401

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import adapter as jad
from lit_llama_ja_tpu.models import lora as jlora
from lit_llama_ja_tpu.models import moe as jmoe
from lit_llama_ja_tpu.train import step as jstep
from lit_llama_ja_tpu.train import trainer as jtrainer
from lit_llama_ja_tpu.train.lr import cosine_with_warmup as j_cosine

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer import decode_graph
from lit_llama_ja_tpu_torch.io.checkpoint import load_train_state, save_train_state
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import adapter as tad
from lit_llama_ja_tpu_torch.models import llama as tl
from lit_llama_ja_tpu_torch.models import lora as tlora
from lit_llama_ja_tpu_torch.models import moe as tmoe
from lit_llama_ja_tpu_torch.parallel.mesh import make_mesh
from lit_llama_ja_tpu_torch.parallel.specs import shard_params
from lit_llama_ja_tpu_torch.train.lr import cosine_with_warmup
from lit_llama_ja_tpu_torch.train.step import (
    init_opt_state,
    make_adamw,
    make_sft_train_step,
    make_train_step,
)
from lit_llama_ja_tpu_torch.train.trainer import make_validate_fn

CFG = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
MOE_CFG = dict(CFG, n_expert=4, n_expert_active=2, capacity_factor=0.5)
ADAPTER = dict(adapter_prompt_length=4, adapter_start_layer=1)
A, B, STEPS = 2, 2, 3  # micro-batches a step, rows a micro-batch, steps
SCHEDULE = (1e-2, 1, STEPS, 1e-3)  # cosine_with_warmup's arguments


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the steps are thousands of tiny ops, which several threads
    a worker only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0, cfg=CFG):
    c = LLaMAConfig(**cfg)
    return random_tree(np.random.default_rng(seed), c.n_layer, c.n_embd, c.n_hidden,
                       c.padded_vocab_size)


def _moe_tree(seed=0):
    cfg = tmoe.MoEConfig(**MOE_CFG)
    tree = _tree(seed)
    rng = np.random.default_rng(seed + 1)
    L, D, H, E = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.n_expert
    tree["blocks"].pop("mlp")
    tree["blocks"]["moe"] = {
        "router": {"weight": rng.standard_normal((L, D, E)).astype(np.float32)},
        "c_fc1": {"weight": (0.1 * rng.standard_normal((L, E, D, H))).astype(np.float32)},
        "c_fc2": {"weight": (0.1 * rng.standard_normal((L, E, D, H))).astype(np.float32)},
        "c_proj": {"weight": (0.1 * rng.standard_normal((L, E, H, D))).astype(np.float32)},
    }
    return tree


def _peft(tree, kind, seed=3):
    rng = np.random.default_rng(seed)
    L, D, nh = CFG["n_layer"], CFG["n_embd"], CFG["n_head"]
    if kind == "lora":
        return jlora.add_lora(tree, {
            "lora_A": (rng.standard_normal((L, D, 4)) * 0.2).astype(np.float32),
            "lora_B": (rng.standard_normal((L, 2, 2, D)) * 0.2).astype(np.float32),
            "lora_alpha": np.full((L,), 4.0, np.float32)})
    return jad.add_adapter(tree, {
        "adapter_wte": rng.standard_normal((L, ADAPTER["adapter_prompt_length"], D)
                                           ).astype(np.float32),
        "gating_factor": (0.5 * rng.standard_normal((L, nh))).astype(np.float32)})


def _batches(seed=1, n=STEPS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (A, B, CFG["block_size"] + 1)) for _ in range(n)]


def _sft_batches(seed=2, n=STEPS):
    """SFT batches: the first quarter of each row's labels masked as a prompt."""
    out = []
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ids = rng.integers(0, CFG["vocab_size"], (A, B, CFG["block_size"]))
        labels = ids.copy()
        labels[..., : CFG["block_size"] // 4] = -1
        out.append({"input_ids": ids, "labels": labels})
    return out


def _adam(jstate):
    """The JAX optimizer state's Adam moments (the chain: clip, then adamw)."""
    return jstate[1][0]


def _no_none(tree):
    """``tree`` without its None leaves (the frozen leaves of a partitioned tree)."""
    if isinstance(tree, dict):
        out = {k: _no_none(v) for k, v in tree.items() if v is not None}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return tree


def _check_state(params, opt_state, jparams, jstate, tree):
    """Every leaf within 1e-4 of JAX's, and moved; each moment within 1e-4 of its
    largest magnitude."""
    want, before = flat_numpy(jparams), flat_numpy(tree)
    got = flat_numpy(params)
    assert sorted(got) == sorted(want)
    moved = 0
    for path, v in got.items():
        np.testing.assert_allclose(v, want[path], rtol=0, atol=1e-4, err_msg=path)
        moved += not np.array_equal(v, before[path])
    assert moved > 0
    adam = _adam(jstate)
    for name, jtree in (("mu", adam.mu), ("nu", adam.nu)):
        jflat = flat_numpy(_no_none(jtree))
        for path, v in flat_numpy(opt_state[name]).items():
            scale = np.abs(jflat[path]).max()
            np.testing.assert_allclose(v, jflat[path], rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{name}/{path}")
    assert int(opt_state["count"]) == int(adam.count) == STEPS


def _dense_case(remat):
    jstep_fn = jstep.make_train_step(JConfig(**CFG), _jopt(), remat=remat)
    return _tree(), jstep_fn, lambda opt: make_train_step(
        LLaMAConfig(**CFG), opt, remat=remat, device="cpu"), None, _batches()


def _moe_case():
    jcfg, cfg = jmoe.MoEConfig(**MOE_CFG), tmoe.MoEConfig(**MOE_CFG)
    return _moe_tree(), jmoe.make_moe_train_step(jcfg, _jopt()), \
        lambda opt: tmoe.make_moe_train_step(cfg, opt, device="cpu"), None, _batches()


def _sft_case(kind):
    tree = _peft(_tree(), kind)
    if kind == "lora":
        jpred, tpred, jfwd, tfwd = jlora.lora_trainable, tlora.lora_trainable, None, None
    else:
        jcfg, tcfg = jad.AdapterConfig(**CFG, **ADAPTER), tad.AdapterConfig(**CFG, **ADAPTER)
        jpred, tpred = jad.adapter_trainable, tad.adapter_trainable
        jfwd = lambda p, x: jad.adapter_forward(p, x, jcfg)  # noqa: E731
        tfwd = lambda p, x: tad.adapter_forward(p, x, tcfg, device="cpu")  # noqa: E731
    jfn = jstep.make_sft_train_step(JConfig(**CFG), _jopt(), forward_fn=jfwd,
                                    trainable_pred=jpred)
    return tree, (jfn, jpred), lambda opt: make_sft_train_step(
        LLaMAConfig(**CFG), opt, forward_fn=tfwd, trainable_pred=tpred, device="cpu"), \
        tpred, _sft_batches()


def _jopt():
    return jstep.make_adamw(j_cosine(*SCHEDULE))


def _opt():
    return make_adamw(cosine_with_warmup(*SCHEDULE))


CASES = {"dense": lambda: _dense_case(False), "dense_remat": lambda: _dense_case(True),
         "moe": _moe_case, "sft_lora": lambda: _sft_case("lora"),
         "sft_adapter": lambda: _sft_case("adapter")}


@pytest.mark.parametrize("case", list(CASES))
def test_step_body_matches_jax(case, guarded_bodies):
    """Three steps of the body against the JAX package's jitted step: the losses, every
    leaf (a PEFT step's frozen leaves in bits) and both AdamW moments."""
    tree, jfn, make, pred, batches = CASES[case]()
    sft = isinstance(jfn, tuple)
    jfn, jpred = jfn if sft else (jfn, None)
    jtrain = jstep.jit_train_step(jfn, n_extra_args=1 if sft else 0)
    jopt = _jopt()
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jstep.init_opt_state(jopt, jparams, trainable_pred=jpred)
    opt = _opt()
    step = make(opt)
    params = params_from_numpy(tree, device="cpu")
    state = init_opt_state(opt, params, trainable_pred=pred)
    for b in batches:
        jb = jax.tree.map(jnp.asarray, b)
        jargs = (jax.random.PRNGKey(0),) if sft else ()
        jparams, jstate, jloss = jtrain(jparams, jstate, jb, *jargs)
        params, state, loss = step(params, state, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert guarded_bodies["train"] == STEPS and guarded_bodies["n"] == 0
    if pred is not None:
        before = flat_numpy(tree)
        for path, v in flat_numpy(params).items():
            if not pred(path):
                np.testing.assert_array_equal(v, before[path], err_msg=path)
    _check_state(params, state, jparams, jstate, tree)


def _run(make, tree, batches, pred=None, generator_seed=None):
    """``make(opt)``'s step over ``batches``: the losses, the learning rates, and the
    final params and optimizer state as numpy."""
    opt = _opt()
    step = make(opt)
    params = params_from_numpy(tree, device="cpu")
    state = init_opt_state(opt, params, trainable_pred=pred)
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    losses, lrs = [], []
    for b in batches:
        params, state, loss = step(params, state, b, *([gen] if gen is not None else []))
        losses.append(loss)
        lrs.append(step.last_lr)
    return torch.stack(losses), torch.stack(lrs), flat_numpy(params), flat_numpy(state)


def _dropout_step(dropout, cuda_graph=True):
    return lambda opt: make_sft_train_step(
        LLaMAConfig(**CFG), opt, trainable_pred=tlora.lora_trainable, lora_dropout=dropout,
        device="cpu", cuda_graph=cuda_graph)


BITS = {
    "dense": (lambda g: lambda opt: make_train_step(LLaMAConfig(**CFG), opt, device="cpu",
                                                    cuda_graph=g), _tree, None, _batches, None),
    "moe": (lambda g: lambda opt: tmoe.make_moe_train_step(
        tmoe.MoEConfig(**MOE_CFG), opt, remat=True, device="cpu", cuda_graph=g),
        _moe_tree, None, _batches, None),
    "sft_lora_dropout": (lambda g: _dropout_step(0.3, g), lambda: _peft(_tree(), "lora"),
                         tlora.lora_trainable, _sft_batches, 5),
}


@pytest.mark.parametrize("case", list(BITS))
def test_body_equals_eager_step_in_bits(case, guarded_bodies):
    """The body through its staging (the CPU route of the captured step) and the eager
    step (``cuda_graph=False``: the body called on the batch, no buffers, no graph)
    over three steps: losses, learning rates, every leaf, both moments and the count
    equal in bits."""
    make, tree_fn, pred, batches_fn, seed = BITS[case]
    tree, batches = tree_fn(), batches_fn()
    body = _run(make(True), tree, batches, pred, seed)
    assert guarded_bodies["train"] == STEPS
    eager = _run(make(False), tree, batches, pred, seed)
    assert guarded_bodies["train"] == STEPS  # the eager step runs no DecodeGraph
    assert torch.equal(body[0], eager[0]) and torch.equal(body[1], eager[1])
    assert body[1][0] == 0 and body[1][1] > 0  # update 0 at schedule(0), then warmed up
    for got, want in ((body[2], eager[2]), (body[3], eager[3])):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert body[3]["count"] == STEPS


def _recorded_masks(monkeypatch):
    """Every `models/lora.dropout_keep` mask drawn, in order."""
    masks, keep = [], tlora.dropout_keep

    def recording(*a, **k):
        out = keep(*a, **k)
        masks.append(out.clone())
        return out

    monkeypatch.setattr(tlora, "dropout_keep", recording)
    return masks


def test_lora_dropout_masks(monkeypatch, guarded_bodies):
    """LoRA at dropout 0.3: each step's masks (one a micro-batch and layer) differ from
    the last step's, the body's and the eager step's are the same, and a recomputed
    block (``remat``) draws its mask again bit for bit."""
    tree, batches = _peft(_tree(), "lora"), _sft_batches()
    per_step = A * CFG["n_layer"]
    masks = _recorded_masks(monkeypatch)
    _run(_dropout_step(0.3), tree, batches, tlora.lora_trainable, 5)
    body = list(masks)
    masks.clear()
    _run(_dropout_step(0.3, cuda_graph=False), tree, batches, tlora.lora_trainable, 5)
    assert len(body) == len(masks) == STEPS * per_step
    assert all(torch.equal(a, b) for a, b in zip(body, masks))
    steps = [body[i * per_step:(i + 1) * per_step] for i in range(STEPS)]
    for prev, cur in zip(steps, steps[1:]):
        assert all(not torch.equal(a, b) for a, b in zip(prev, cur))
    kept = torch.cat([m.flatten() for m in body]).float().mean().item()
    assert abs(kept - 0.7) < 0.05, kept

    # remat: the forward's masks, then the backward's recomputation draws them again
    tt = params_from_numpy(tree, device="cpu")
    c_attn = tt["blocks"]["attn"]["c_attn"]
    leaves = [c_attn["lora_A"].requires_grad_(True), c_attn["lora_B"].requires_grad_(True)]
    seeds = tlora.draw_seeds(torch.Generator().manual_seed(9), (CFG["n_layer"],))
    idx = torch.as_tensor(batches[0]["input_ids"][0])
    out = []
    for remat in (False, True):
        masks.clear()
        logits = tl.forward(tt, idx, LLaMAConfig(**CFG), device="cpu", remat=remat,
                            dropout_seeds=seeds, dropout_rate=0.3)
        grads = torch.autograd.grad(logits.square().mean(), leaves)
        out.append((logits.detach(), grads, list(masks)))
    L = CFG["n_layer"]
    assert len(out[0][2]) == L and len(out[1][2]) == 2 * L
    # the backward recomputes the blocks from the last one down
    assert all(torch.equal(a, b) for a, b in zip(out[1][2][:L], out[1][2][L:][::-1]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2][:L]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_resume_puts_the_count_back(tmp_path, guarded_bodies):
    """A state saved after 2 of 4 steps and loaded resumes on the same step (the graphs
    rebuilt around the loaded leaves), the count on the device of the loaded state:
    params, moments and count equal in bits to the uninterrupted run."""
    cfg, tree, batches = LLaMAConfig(**CFG), _tree(4), _batches(5, 4)
    opt = _opt()
    step = make_train_step(cfg, opt, device="cpu")
    params = params_from_numpy(tree, device="cpu")
    state = init_opt_state(opt, params)
    for b in batches:
        params, state, _ = step(params, state, b)
    want, want_state = flat_numpy(params), flat_numpy(state)

    params = params_from_numpy(tree, device="cpu")
    state = init_opt_state(opt, params)
    for b in batches[:2]:
        params, state, _ = step(params, state, b)
    save_train_state(tmp_path / "state", params, state, cfg, meta={"iter": 1})
    params, state, _, meta = load_train_state(tmp_path / "state", device="cpu")
    assert meta == {"iter": 1} and int(state["count"]) == 2
    assert state["count"].device == params["wte"]["weight"].device
    for b in batches[2:]:
        params, state, _ = step(params, state, b)
    assert guarded_bodies["train"] == 8
    for got, exp in ((flat_numpy(params), want), (flat_numpy(state), want_state)):
        for k, v in exp.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_validation_body_matches_jax(guarded_bodies):
    """`make_validate_fn`'s body (one a batch) against the JAX package's jitted
    ``val_loss``, and the eager route in bits."""
    tree = _tree(6)
    rng = np.random.default_rng(7)
    val = [rng.integers(0, CFG["vocab_size"], (B, CFG["block_size"] + 1)) for _ in range(3)]
    want = jtrainer.make_validate_fn(JConfig(**CFG), 3, lambda: iter(val))(
        jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, device="cpu")
    got = make_validate_fn(LLaMAConfig(**CFG), 3, lambda: iter(val), device="cpu")(params)
    assert guarded_bodies["val"] == 3 and guarded_bodies["train"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    eager = make_validate_fn(LLaMAConfig(**CFG), 3, lambda: iter(val), device="cpu",
                             cuda_graph=False)(params)
    assert eager == got and guarded_bodies["val"] == 3


def test_mesh_step_builds_no_graph(monkeypatch, guarded_bodies):
    """A step on a mesh (one rank, no process group) runs eagerly: no `DecodeGraph` is
    built, and its losses equal the one-device body's."""
    built = []
    init = decode_graph.DecodeGraph.__init__

    def counted(self, *a, **k):
        built.append(k.get("kind"))
        init(self, *a, **k)

    monkeypatch.setattr(decode_graph.DecodeGraph, "__init__", counted)
    cfg, tree, batches = LLaMAConfig(**CFG), _tree(8), _batches(9, 2)
    mesh = make_mesh(dp=1, fsdp=1, tp=1)
    opt = _opt()
    step = make_train_step(cfg, opt, device="cpu", mesh=mesh)
    assert step.graphs is None and step.pool is None
    params = shard_params(params_from_numpy(tree, device="cpu"), mesh)
    state = init_opt_state(opt, params)
    mesh_losses = [float(step(params, state, b)[2]) for b in batches]
    assert built == [] and guarded_bodies["train"] == 0
    one = _run(lambda o: make_train_step(cfg, o, device="cpu"), tree, batches)[0]
    assert built == ["train"]
    np.testing.assert_allclose(mesh_losses, one.numpy(), rtol=1e-6)


def test_step_and_graphs_go_with_their_last_reference():
    """No reference cycle holds a step: with the cyclic collector off, the step, its
    `TrainGraphs` and their `DecodeGraph` go when the last reference does; so does a
    validation's."""
    cfg, tree = LLaMAConfig(**CFG), _tree(10)
    opt = _opt()
    step = make_train_step(cfg, opt, device="cpu")
    params = params_from_numpy(tree, device="cpu")
    state = init_opt_state(opt, params)
    step(params, state, _batches(11, 1)[0])
    validate = make_validate_fn(cfg, 1, lambda: iter(_batches(12, 1)[0][0][None]),
                                device="cpu")
    validate(params)
    refs = [weakref.ref(x) for x in (step, step.graphs, *step.graphs.graphs.values(),
                                     validate, validate.val_loss.graphs,
                                     *validate.val_loss.graphs.graphs.values())]
    assert len(refs) == 6
    gc.collect()
    gc.disable()
    try:
        del step, validate
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()
