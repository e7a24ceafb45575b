"""The port's dp/fsdp/tp parallelism (`lit_llama_ja_tpu_torch/parallel/`) on the CPU,
over 2 and 4 gloo ranks (`test_torch_dist_ranks.spawn`), mirroring tests/test_parallel.py
(the train step and the CLIs: tests/test_torch_parallel_train.py).

Oracles: every sharded result is held to the port's single-rank result on the same
tree, and the forward also to the JAX package's. Tolerances: f32 on every side, the
sums taken in other orders across ranks, so logits agree to 2e-5 absolute (they are
O(0.1) at this init); greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from test_torch_dist_ranks import model_paths, spawn
from torch_port_helpers import to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import llama as jllama
from lit_llama_ja_tpu.parallel.specs import param_specs as j_param_specs

from lit_llama_ja_tpu_torch.cli.generate_cli import _rtn_quantize
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.generate import generate
from lit_llama_ja_tpu_torch.infer.paged import PagedEngine
from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree
from lit_llama_ja_tpu_torch.models.llama import forward
from lit_llama_ja_tpu_torch.models.moe import MoEConfig, init_moe_params
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, make_mesh
from lit_llama_ja_tpu_torch.parallel.specs import (
    KV_CACHE_SPEC,
    BATCH_SPEC,
    param_specs,
    shard_params,
)
from lit_llama_ja_tpu_torch.quant.pipeline import int8_quantize_model

CFG = dict(block_size=16, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
MOE_CFG = dict(CFG, n_expert=4, n_expert_active=2, capacity_factor=4.0)
MESHES = {2: [dict(fsdp=1, tp=2), dict(fsdp=2, tp=1)],
          4: [dict(fsdp=2, tp=2), dict(fsdp=1, tp=4), dict(dp=2, fsdp=2, tp=1)]}
LOGIT_ATOL = 2e-5


def _jax_tree():
    return jllama.init_params(jax.random.PRNGKey(1), JConfig(**CFG))


def _trees():
    """fp, int4 in 8-row groups, int4 in ragged 12-row groups (tile rule 11), llm.int8
    (the port's RTN and LLM.int8, held to the JAX package's by tests/test_torch_quant*)."""
    jp = _jax_tree()
    fp = to_port(jp)
    return jp, {"fp": fp, "int4": _rtn_quantize(fp, 4, 8), "int4r": _rtn_quantize(fp, 4, 12),
                "llm.int8": int8_quantize_model(fp, outliers=True)}


def test_make_mesh_shapes():
    mesh = make_mesh(dp=2, fsdp=2, tp=2, world=8)
    assert mesh.shape == {"dp": 2, "fsdp": 2, "tp": 2}
    assert mesh.axis_names == ("dp", "fsdp", "tp")
    assert make_mesh(dp=1, fsdp=-1, tp=2, world=8).shape == {"dp": 1, "fsdp": 4, "tp": 2}
    assert make_mesh(ep=4, world=8).shape == {"dp": 1, "fsdp": 2, "tp": 1, "ep": 4}
    # rank-major in axis order, as the JAX device array is laid out
    m = Mesh({"dp": 2, "fsdp": 2, "tp": 2}, rank=6)
    assert m.coords == {"dp": 1, "fsdp": 1, "tp": 0}
    assert m.index(("dp", "fsdp")) == 3 and m.size(BATCH_SPEC[0]) == 4
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(dp=3, world=8)
    # the pipeline axis is appended after tp, innermost but for ep, as in the JAX package
    pm = make_mesh(dp=1, fsdp=-1, tp=2, pp=2, world=8)
    assert pm.shape == {"dp": 1, "fsdp": 2, "tp": 2, "pp": 2}
    assert pm.axis_names == ("dp", "fsdp", "tp", "pp")
    assert make_mesh(pp=2, ep=2, world=8).axis_names == ("dp", "fsdp", "tp", "pp", "ep")
    assert Mesh(pm.shape, rank=5).coords == {"dp": 0, "fsdp": 1, "tp": 0, "pp": 1}


def test_one_rank_groups_are_the_identity_unless_opted_in(monkeypatch):
    """A collective over a group of one rank does nothing, under gloo and NCCL alike;
    `ONE_RANK_COLLECTIVES` turns NCCL's back on (device copies on the larger-mesh path)."""
    from lit_llama_ja_tpu_torch.parallel import mesh as mesh_mod

    mesh = Mesh({"dp": 1, "fsdp": 1, "tp": 1}, rank=0, distributed=False)
    mesh._groups = {("tp",): (object(), [0])}
    t = torch.ones(3)
    for backend in ("gloo", "nccl"):
        mesh.backend = backend
        assert not mesh.active("tp") and mesh_mod.all_reduce(t, mesh, "tp") is t
    monkeypatch.setitem(mesh_mod.ONE_RANK_COLLECTIVES, "nccl", True)
    assert mesh.active("tp")
    mesh.backend = "gloo"
    assert not mesh.active("tp") and not mesh.active("fsdp")


def test_param_specs_match_jax_leaf_for_leaf():
    """The port's rules give JAX's spec on every leaf of a dense, an int4 and an MoE
    tree (a JAX PartitionSpec is a tuple); llm.int8's outlier leaves as the rules say."""
    fp = to_port(_jax_tree())
    trees = [fp, _rtn_quantize(fp, 4, -1),
             init_moe_params(torch.Generator().manual_seed(2), MoEConfig(**MOE_CFG), device="cpu")]
    for tt in trees:  # the JAX rules read only the tree's paths
        jt = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tt)
        want = flat_specs(j_param_specs(jt))
        got = flatten_tree(param_specs(tt))
        assert got.keys() == want.keys()
        for path, spec in got.items():
            assert spec == tuple(want[path]), path
    i8 = flatten_tree(param_specs(int8_quantize_model(fp, outliers=True)))
    assert i8["blocks/attn/c_attn/outlier_w"] == (None, None, "tp")
    assert i8["blocks/attn/c_proj/outlier_idx"] == ()
    assert KV_CACHE_SPEC == (None, "dp", "tp", None, None)


def flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{prefix}{k}/"))
        return out
    assert isinstance(tree, JP)
    return {prefix[:-1]: tree}


def test_c_attn_shards_are_head_aligned():
    """A tp rank's c_attn columns are its heads of each of q, k and v; the row-parallel
    c_proj rows and every fsdp dim are contiguous slices."""
    _, trees = _trees()
    fp, q4 = trees["fp"], trees["int4"]
    D, nh = CFG["n_embd"], CFG["n_head"]
    for r in range(4):
        mesh = Mesh({"dp": 1, "fsdp": 2, "tp": 2}, rank=r)
        f, t = mesh.coords["fsdp"], mesh.coords["tp"]
        local = shard_params(fp, mesh)
        w = fp["blocks"]["attn"]["c_attn"]["weight"]  # (L, D, 3D)
        heads = w.view(2, D, 3, 2, D // 2)[:, :, :, t].reshape(2, D, 3 * D // 2)
        want = heads[:, f * D // 2:(f + 1) * D // 2]
        assert torch.equal(local["blocks"]["attn"]["c_attn"]["weight"], want)
        cp = fp["blocks"]["attn"]["c_proj"]["weight"]
        assert torch.equal(local["blocks"]["attn"]["c_proj"]["weight"],
                           cp[:, t * D // 2:(t + 1) * D // 2, f * D // 2:(f + 1) * D // 2])
        ql = shard_params(q4, mesh)["blocks"]["attn"]["c_attn"]
        s = q4["blocks"]["attn"]["c_attn"]["scales"]
        assert torch.equal(ql["scales"], s.view(2, -1, 3, 2, D // 2)[:, :, :, t].reshape(
            2, s.shape[1], 3 * D // 2))
        assert ql["qweight"].shape == (2, D // 4, 3 * D // 2)  # int4 rows over fsdp
    assert nh % 2 == 0


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    jp, trees = _trees()
    cfg = LLaMAConfig(**CFG)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (2, 8)))
    prompt = rng.integers(1, CFG["vocab_size"], 9).astype(np.int32)
    tmp = tmp_path_factory.mktemp("model")
    ranks = {w: spawn(model_paths, w, tmp, trees, cfg, idx, prompt, MESHES[w]) for w in (2, 4)}
    return jp, trees, cfg, idx, prompt, ranks


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_forward_matches_single_device_and_jax(model_runs, world):
    jp, trees, cfg, idx, _, ranks = model_runs
    want_jax = np.asarray(jllama.forward(jp, jnp.asarray(idx.numpy()), JConfig(**CFG)))
    for name, tree in trees.items():
        want = forward(tree, idx, cfg, device="cpu")
        for out in ranks[world]:
            for m in range(len(MESHES[world])):
                got = out[f"{m}/{name}/logits"]
                torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
                if name == "fp":
                    np.testing.assert_allclose(got.numpy(), want_jax, atol=LOGIT_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_cached_decode_matches_single_device(model_runs, world):
    """`generate` on a tp/fsdp mesh (a cache of the rank's heads) gives the single
    rank's greedy tokens, for the dense and every quantized tree; so does
    `speculative_generate` with a sharded draft (generate_cli's draft path)."""
    _, trees, cfg, _, prompt, ranks = model_runs
    for name, tree in trees.items():
        want = generate(tree, cfg, prompt, 6, temperature=0.0, quantize_kv="int8",
                        device="cpu")
        for out in ranks[world]:
            for m, dims in enumerate(MESHES[world]):
                if dims.get("dp", 1) == 1:
                    assert out[f"{m}/{name}/generate"].tolist() == want.tolist(), (name, dims)
    spec = speculative_generate(trees["fp"], cfg, trees["fp"], cfg, prompt, 6, K=2,
                                temperature=0.0, quantize_kv="int8", device="cpu")
    for out in ranks[world]:
        for m, dims in enumerate(MESHES[world]):
            if dims.get("dp", 1) == 1:
                assert out[f"{m}/speculative"].tolist() == spec.tolist(), dims


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_serving_engine(model_runs, world):
    """The paged engine over an int8 pool of the rank's heads serves the single rank's
    tokens."""
    _, trees, cfg, _, prompt, ranks = model_runs
    for name, tree in trees.items():
        eng = PagedEngine(tree, cfg, max_batch=2, n_pages=16, page_size=8,
                          quantize_kv="int8", device="cpu")
        res = eng.run([(prompt, 5), (prompt[:5], 4)], temperature=0.0)
        want = [res[i].tolist() for i in sorted(res)]
        for out in ranks[world]:
            for m, dims in enumerate(MESHES[world]):
                if dims.get("dp", 1) == 1:
                    assert [t.tolist() for t in out[f"{m}/{name}/paged"]] == want, (name, dims)


def test_sharded_params_actually_sharded(model_runs):
    """Each rank holds 1/fsdp of the fsdp dims and 1/tp of the tp dims; norms whole."""
    _, trees, _, _, _, ranks = model_runs
    full = {k: tuple(v.shape) for k, v in flatten_tree(trees["fp"]).items()}
    local = ranks[4][0]["0/shapes"]  # fsdp 2, tp 2
    assert local["blocks/attn/c_attn/weight"] == (2, 16, 48)
    assert local["blocks/mlp/c_proj/weight"] == (2, full["blocks/mlp/c_proj/weight"][1] // 2, 16)
    assert local["wte/weight"] == (32, 16) and local["lm_head/weight"] == (16, 32)
    assert local["ln_f/scale"] == full["ln_f/scale"]
    assert sum(np.prod(s) for s in local.values()) < sum(np.prod(s) for s in full.values()) / 3
