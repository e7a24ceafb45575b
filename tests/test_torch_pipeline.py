"""The port's GPipe pipeline (`lit_llama_ja_tpu_torch/parallel/pipeline.py`) on gloo
ranks on the CPU, mirroring tests/test_pipeline.py: the specs, the forward at pp 2 and
4, dp×pp, remat, the train step, and pp×tp forward and train.

Oracles: the port's one-rank `forward` and `make_train_step` on the same tree and batch,
and the JAX package's `pipeline_forward` at pp 2 once (the JAX pipeline programs are not
run case by case). Tolerances: logits 1e-6 absolute against the port's one rank (f32,
the same ops on each micro-batch's rows), 2e-5 under tp and against JAX (f32 sums in
another order; logits are O(1) at this tree's std); losses 1e-6 relative; parameters
after two AdamW steps at lr 1e-2 5e-4 absolute, as in tests/test_torch_parallel_train.py
(f32 gradients summed in another order over micro-batches, stages and tp ranks; Adam
divides by the root of the second moment, which magnifies the last bits of a small
gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from test_torch_dist_ranks import pipeline_runs, spawn
from torch_port_helpers import flat_numpy, random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.parallel import pipeline as jpipe
from lit_llama_ja_tpu.parallel.mesh import make_mesh as j_make_mesh

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
from lit_llama_ja_tpu_torch.models.llama import forward
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh
from lit_llama_ja_tpu_torch.parallel.pipeline import pp_param_specs, shard_params_pp
from lit_llama_ja_tpu_torch.parallel.specs import axes_of
from lit_llama_ja_tpu_torch.train.step import init_opt_state, make_adamw, make_train_step

CFG = dict(block_size=16, vocab_size=96, n_layer=4, n_head=2, n_embd=16)
MESHES = {2: [dict(fsdp=1, pp=2)],
          4: [dict(fsdp=1, pp=4), dict(dp=2, fsdp=1, pp=2), dict(fsdp=1, tp=2, pp=2)]}
M, MB, T = 4, 2, 12
STEPS, LR = 2, 1e-2


def _tree():
    c = JConfig(**CFG)
    return random_tree(np.random.default_rng(5), c.n_layer, c.n_embd, c.n_hidden,
                       c.padded_vocab_size, std=0.3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = _tree()
    rng = np.random.default_rng(6)
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (M, MB, T)))
    batch = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (M, MB, T + 1)))
    cfg = LLaMAConfig(**CFG)
    tmp = tmp_path_factory.mktemp("pipeline")
    ranks = {w: spawn(pipeline_runs, w, tmp, to_port(tree), cfg, idx, batch, MESHES[w],
                      STEPS, LR) for w in (2, 4)}
    return tree, cfg, idx, batch, ranks


def _jax_flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_flat_specs(v, f"{prefix}{k}/"))
        return out
    assert isinstance(tree, JP)
    return {prefix[:-1]: tuple(tree)}


def _split_axes(spec, mesh_shape):
    """The axes of more than one rank that each dim of a spec splits (trailing dims that
    split nothing dropped, as a shorter spec leaves them whole)."""
    dims = [tuple(a for a in axes_of(e) if mesh_shape.get(a, 1) > 1) for e in spec]
    while dims and not dims[-1]:
        dims.pop()
    return tuple(dims)


def test_pp_specs_shard_only_blocks():
    """On a pp-only mesh the port's rules split what JAX's PP_PARAM_RULES split: the
    blocks' leading axis over pp, nothing else; under pp×tp the blocks' tp dims are JAX's
    PP_TP_PARAM_RULES dims (c_attn's on JAX's relayouted (L, D, 3, D) and on the port's
    head-aligned (L, D, 3D), the same heads: `test_shard_params_pp_gives_the_stage_layers`)."""
    port = to_port(_tree())
    got = flatten_tree(pp_param_specs(port))
    jt = jax.tree.map(jnp.asarray, _tree())
    want = _jax_flat_specs(jpipe.pp_param_specs(jt))
    assert got.keys() == want.keys()
    for path, spec in got.items():
        assert _split_axes(spec, {"pp": 2}) == _split_axes(want[path], {"pp": 2}), path
        assert (spec[:1] == ("pp",)) == path.startswith("blocks/"), path
    want_tp = _jax_flat_specs(jpipe.pp_param_specs(jpipe.relayout_qkv(jt), tp=True))
    shape = {"pp": 2, "tp": 2}
    for path in ("blocks/attn/c_proj/weight", "blocks/mlp/c_fc1/weight",
                 "blocks/mlp/c_fc2/weight", "blocks/mlp/c_proj/weight", "blocks/rms_1/scale"):
        assert _split_axes(got[path], shape) == _split_axes(want_tp[path], shape), path
    qkv = "blocks/attn/c_attn/weight"
    assert _split_axes(got[qkv], shape) == (("pp",), (), ("tp",))
    assert _split_axes(want_tp[qkv], shape) == (("pp",), (), (), ("tp",))


def test_shard_params_pp_gives_the_stage_layers():
    """A stage's slice holds its layers whole; under tp its head-aligned c_attn columns."""
    port = to_port(_tree())
    L, D = CFG["n_layer"], CFG["n_embd"]
    for r in range(4):
        mesh = Mesh({"dp": 1, "fsdp": 1, "tp": 2, "pp": 2}, rank=r)
        s, t = mesh.coords["pp"], mesh.coords["tp"]
        local = shard_params_pp(port, mesh)
        layers = slice(s * L // 2, (s + 1) * L // 2)
        assert torch.equal(local["blocks"]["rms_1"]["scale"],
                           port["blocks"]["rms_1"]["scale"][layers])
        w = port["blocks"]["attn"]["c_attn"]["weight"][layers]
        heads = w.view(L // 2, D, 3, 2, D // 2)[:, :, :, t].reshape(L // 2, D, 3 * D // 2)
        assert torch.equal(local["blocks"]["attn"]["c_attn"]["weight"], heads)
        assert local["ln_f"]["scale"].shape == port["ln_f"]["scale"].shape


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_forward_matches_single_rank(runs, world):
    """pp 2, pp 4, dp 2 × pp 2 and pp 2 × tp 2; every rank holds the whole logits (the
    rows of its dp index under dp)."""
    tree, cfg, idx, _, ranks = runs
    want = forward(to_port(tree), idx.reshape(M * MB, T), cfg, device="cpu").reshape(
        M, MB, T, -1)
    for r, out in enumerate(ranks[world]):
        for m, dims in enumerate(MESHES[world]):
            got = out[f"{m}/logits"]
            rows = want
            if dims.get("dp", 1) > 1:
                d = Mesh({"dp": 2, "fsdp": 1, "tp": 1, "pp": 2}, rank=r).coords["dp"]
                rows = want[:, d * MB // 2:(d + 1) * MB // 2]
            atol = 2e-5 if dims.get("tp", 1) > 1 else 1e-6
            torch.testing.assert_close(got, rows, atol=atol, rtol=0, msg=str(dims))


def test_pipeline_forward_matches_jax(runs):
    """The port's pp 2 against the JAX package's `pipeline_forward` on 2 devices."""
    tree, _, idx, _, ranks = runs
    mesh = j_make_mesh(dp=1, fsdp=1, tp=1, pp=2, devices=jax.devices()[:2])
    jt = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jpipe.pipeline_forward(jpipe.shard_params_pp(jt, mesh),
                                             jnp.asarray(idx.numpy(), jnp.int32),
                                             JConfig(**CFG), mesh))
    for out in ranks[2]:
        np.testing.assert_allclose(out["0/logits"].numpy(), want, atol=2e-5, rtol=0)


def test_pipeline_remat_matches(runs):
    for out in runs[4][2]:
        torch.testing.assert_close(out["0/remat"], out["0/logits"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_train_step_matches_single_rank(runs, world):
    """Two AdamW steps through the pipeline (remat on the first mesh) against two steps of
    the one-rank gradient-accumulation step on the same batch: losses on every rank,
    every gathered parameter (the stages' copies of wte, ln_f and lm_head included)."""
    tree, cfg, _, batch, ranks = runs
    ref = to_port(tree)
    opt = make_adamw(lambda _: LR, grad_clip=0.5)
    step = make_train_step(cfg, opt, device="cpu")
    state, losses = init_opt_state(opt, ref), []
    for _ in range(STEPS):
        ref, state, loss = step(ref, state, batch)
        losses.append(float(loss))
    want = flat_numpy(ref)
    for out in ranks[world]:
        for m in range(len(MESHES[world])):
            np.testing.assert_allclose(out[f"{m}/loss"].numpy(), losses, rtol=1e-6)
            got = flat_numpy(out[f"{m}/params"])
            assert got.keys() == want.keys()
            for path in want:
                np.testing.assert_allclose(got[path], want[path], atol=5e-4, err_msg=path)
            pp = MESHES[world][m]["pp"]
            assert out[f"{m}/blocks_rows"] == CFG["n_layer"] // pp
