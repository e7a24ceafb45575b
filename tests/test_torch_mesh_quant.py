"""The sub-4-bit packs (gptq.int2, gptq.int3, the mix) and llm.int8-dyn under tensor
parallelism (`parallel/sharded.py`), on the CPU over 2 and 4 gloo ranks
(`test_torch_dist_ranks.spawn`), with gptq.int4 as the control.

The trees are the port's quantizers' (`cli/generate_cli._rtn_quantize`,
`quant/pipeline.int8_quantize_model`) of a numpy tree, on the tiny config of
`tests/test_torch_parallel.py` and on a ragged one (K = 40 in groups of 16 is 48
stored rows: a tp-2 row shard of 24 starts inside a group, as the 125M model's K = 780
in groups of 64 does). On the tiny config gptq.int2-g64 pads ``attn.c_proj``'s K = 32 to
64 stored rows, so the second tp rank's rows are all padding. The llm.int8-dyn tree
has a few large weight columns and norm scales, so that activation outliers pass the
threshold on the column and the row linears, the largest in the second tp rank's
range of a row linear's input.

Oracles: the port's one-rank forward (logits within 1e-5 of max|want|, f32, the sums
taken in other orders across ranks), the JAX package's unsharded forward on the same
tree (2e-5 absolute, as `tests/test_parallel.py::test_sharded_quantized_model`), and
one rank's greedy tokens from `generate` and from `generate_cli.main --tp 2`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import cli_runs, dyn_choices, mesh_quant_cli, mesh_quant_runs, spawn
from torch_port_helpers import random_tree, to_port

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import llama as jllama

from lit_llama_ja_tpu_torch.cli.generate_cli import _rtn_quantize
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.generate import generate
from lit_llama_ja_tpu_torch.io.checkpoint import save_checkpoint
from lit_llama_ja_tpu_torch.models.llama import forward
from lit_llama_ja_tpu_torch.quant import linear as qlinear
from lit_llama_ja_tpu_torch.quant.linear import parse_quant_mode, sub4_pad_rows
from lit_llama_ja_tpu_torch.quant.pipeline import int8_quantize_model

CFG = dict(block_size=16, vocab_size=64, n_layer=2, n_head=4, n_embd=32)
RAGGED = dict(block_size=16, vocab_size=64, n_layer=1, n_head=4, n_embd=40)
FORMATS = {"int2": (CFG, "gptq.int2-g64"), "int3": (CFG, "gptq.int3"),
           "mix": (CFG, "gptq.mix"), "dyn": (CFG, "llm.int8-dyn"), "int4": (CFG, "gptq.int4"),
           "int2r": (RAGGED, "gptq.int2-g16"), "int3r": (RAGGED, "gptq.int3-g16")}
MESHES = {2: [dict(fsdp=1, tp=2)], 4: [dict(fsdp=2, tp=2)]}
CLI_FORMATS = ("gptq.int2-g64", "gptq.int3", "gptq.mix", "llm.int8-dyn")
PROMPT = "31415926"  # the stand-in tokenizer's ids 51-60, inside the vocabulary


def fp_tree(cfg, rng, outliers=False):
    cfg = LLaMAConfig(**cfg)
    D, H = cfg.n_embd, cfg.n_hidden
    t = random_tree(rng, cfg.n_layer, D, H, cfg.padded_vocab_size, std=0.05)
    if outliers:  # columns whose activations pass llm.int8-dyn's threshold of 6
        b = t["blocks"]
        b["rms_1"]["scale"][:, [1, 7]] *= 12.0
        b["rms_2"]["scale"][:, [2, 9]] *= 12.0
        for col, f in ((3, 30.0), (D - 2, 60.0)):  # v columns: c_proj's input
            b["attn"]["c_attn"]["weight"][:, :, 2 * D + col] *= f
        for col, f in ((5, 30.0), (H - 3, 50.0)):
            b["mlp"]["c_fc1"]["weight"][:, :, col] *= f
            b["mlp"]["c_fc2"]["weight"][:, :, col] *= f
    return t


def quantized(fp, mode):
    if mode == "llm.int8-dyn":
        return int8_quantize_model(fp, outliers="dynamic")
    _, bits, groupsize = parse_quant_mode(mode)
    return _rtn_quantize(fp, bits, groupsize)


def trees():
    rng = np.random.default_rng(0)
    fps = {"tiny": fp_tree(CFG, rng), "dyn": fp_tree(CFG, rng, outliers=True),
           "ragged": fp_tree(RAGGED, rng)}
    out = {}
    for name, (cfg, mode) in FORMATS.items():
        fp = fps["dyn" if name == "dyn" else "ragged" if cfg is RAGGED else "tiny"]
        out[name] = (quantized(to_port(fp), mode), LLaMAConfig(**cfg))
    return fps, out


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_quant")
    fps, qtrees = trees()
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, CFG["vocab_size"], (2, 8)))
    prompt = rng.integers(1, CFG["vocab_size"], 9).astype(np.int32)
    tiny = dict(CFG)
    for name in ("tiny", "dyn"):
        save_checkpoint(root / name, to_port(fps[name]), LLaMAConfig(**CFG))

    def runs(tp):
        return [(f"generate-{mode}", dict(
            prompt=PROMPT, max_new_tokens=5, temperature=0.0, quantize=mode, tp=tp,
            checkpoint_path=str(root / ("dyn" if mode == "llm.int8-dyn" else "tiny")),
            tokenizer_path="unused", device="cpu")) for mode in CLI_FORMATS]

    ranks, one_cli = spawn(mesh_quant_cli, 2, root, qtrees, idx, prompt, MESHES[2], root,
                           tiny, runs(2), meanwhile=lambda: cli_runs(0, 1, root, tiny, runs(1)))
    ranks = {2: ranks, 4: spawn(mesh_quant_runs, 4, root, qtrees, idx, prompt, MESHES[4])}
    return dict(qtrees=qtrees, idx=idx, prompt=prompt, ranks=ranks, one_cli=one_cli)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(FORMATS))
def test_sharded_quantized_forward_matches_one_rank_and_jax(ws, world, name):
    tree, cfg = ws["qtrees"][name]
    idx = ws["idx"]
    want = forward(tree, idx, cfg, device="cpu")
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    want_jax = np.asarray(jllama.forward(jtree, jnp.asarray(idx.numpy()),
                                         JConfig(**{**FORMATS[name][0]})))
    tol = 1e-5 * float(want.abs().max())
    for out in ws["ranks"][world]:
        for m in range(len(MESHES[world])):
            got = out[f"{m}/{name}/logits"]
            torch.testing.assert_close(got, want, atol=tol, rtol=0)
            np.testing.assert_allclose(got.numpy(), want_jax, atol=2e-5, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(FORMATS))
def test_sharded_quantized_generate_gives_one_ranks_tokens(ws, world, name):
    tree, cfg = ws["qtrees"][name]
    want = generate(tree, cfg, ws["prompt"], 6, temperature=0.0, device="cpu")
    for out in ws["ranks"][world]:
        for m in range(len(MESHES[world])):
            assert out[f"{m}/{name}/generate"].tolist() == want.tolist()


@pytest.mark.parametrize("mode", CLI_FORMATS)
def test_generate_cli_tp2_gives_one_ranks_tokens(ws, mode):
    got = ws["ranks"][2][0][f"generate-{mode}"]
    assert got.strip() and got == ws["one_cli"][f"generate-{mode}"]


def test_the_cases_cover_padding_shards_ragged_tiles_and_live_outliers(ws, monkeypatch):
    """The shapes the module docstring promises: a row shard of padding only, a row
    shard that starts inside a group, and live dynamic outliers on both kinds of
    linear (recorded from the one-rank forward)."""
    D, H = CFG["n_embd"], LLaMAConfig(**CFG).n_hidden
    assert sub4_pad_rows(D, 64) == 2 * D  # tp rank 1 of attn.c_proj: rows [32, 64)
    q = ws["qtrees"]["int2"][0]["blocks"]["attn"]["c_proj"]
    assert q["qweight"].shape[-2] * 4 == 2 * D
    Kp = sub4_pad_rows(RAGGED["n_embd"], 16)
    assert (Kp // 2) % 16 and (Kp // 2) % 8 == 0  # a shard boundary inside a group

    seen = []
    real = qlinear.dynamic_int8_matmul

    def recording(x, params, *a, **k):
        peak = torch.amax(torch.abs(x.reshape(-1, x.shape[-1]).float()), dim=0)
        seen.append((x.shape[-1], params["qweight"].shape[-1],
                     int((peak > params["dyn_threshold"]).sum())))
        return real(x, params, *a, **k)

    monkeypatch.setattr(qlinear, "dynamic_int8_matmul", recording)
    tree, cfg = ws["qtrees"]["dyn"]
    forward(tree, ws["idx"], cfg, device="cpu")
    live = {(K, N): n for K, N, n in seen if n}
    assert (D, 3 * D) in live and (D, D) in live and (H, D) in live, seen


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_dyn_picks_one_ranks_outlier_columns(ws, world):
    """llm.int8-dyn's split changes no value beyond rounding (both parts run against
    the same dequantized weights), so the logits cannot show a wrong choice: every
    rank's candidate columns and live gates, linear by linear, are one rank's, the
    row-parallel ones picked from the gathered peaks of the whole K."""
    tree, cfg = ws["qtrees"]["dyn"]
    want = dyn_choices(tree, cfg, ws["idx"])
    assert any(int(w[1].sum()) for w in want)
    for out in ws["ranks"][world]:
        for m in range(len(MESHES[world])):
            got = out[f"{m}/dyn/choices"]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.parametrize("bits,groupsize", [(2, 64), (3, -1)])
def test_row_shards_of_a_7b_pack_sum_to_the_whole(bits, groupsize):
    """The row shards of the 7B ``mlp.c_proj`` (K = 11008 stored as 11264 rows, 5632 a
    tp-2 rank: more than 2048 and no multiple of 1024, so the shapes alone read as
    int8) through the wrappers at an explicit width: their partial products, each
    against its columns of the zero-padded x, sum to the whole pack's."""
    from lit_llama_ja_tpu_torch.parallel.sharded import k_shard_groups
    from lit_llama_ja_tpu_torch.quant.linear import quant_matmul, quantize_colblock

    K, N, tp = 11008, 16, 2
    g = torch.Generator().manual_seed(5)
    pack = quantize_colblock(torch.randn((K, N), generator=g) * 0.02, bits=bits,
                             tile_cols=groupsize)
    Kp = sub4_pad_rows(K, groupsize)
    assert pack["qweight"].shape[0] * 4 == Kp == 11264
    x = torch.randn((3, K), generator=g)
    want = quant_matmul(x, pack)
    xp = torch.nn.functional.pad(x, (0, Kp - K))
    Ks = Kp // tp
    got = 0
    for r in range(tp):
        shard = {"qweight": pack["qweight"][r * Ks // 4:(r + 1) * Ks // 4],
                 "scales": k_shard_groups(pack["scales"], Kp, r * Ks, Ks),
                 "zeros": k_shard_groups(pack["zeros"], Kp, r * Ks, Ks)}
        if bits == 3:
            shard["qweight_hi"] = pack["qweight_hi"][r * Ks // 8:(r + 1) * Ks // 8]
        got = got + quant_matmul(xp[:, r * Ks:(r + 1) * Ks], shard, bits=bits)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
