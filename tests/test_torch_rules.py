"""Rules of the PyTorch port, checked on a machine without a card:

* every entry point raises unless the caller asks for the CPU;
* neither the package nor `chip_smoke.py` and `tp_serve_gate_probe.py` import jax or
  the JAX package;
* the CUDA kernel wrappers run their plain versions on CPU tensors, refuse
  malformed inputs with a clear error, and the kernel build refuses to fall back.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.infer.generate import generate
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy
from lit_llama_ja_tpu_torch.models import llama as tl
from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    quant_matmul_int4,
    quant_matmul_int4_ref,
)

REPO = Path(__file__).resolve().parents[1]
CFG = LLaMAConfig(block_size=16, vocab_size=64, n_layer=1, n_head=2, n_embd=16)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_explicit_cpu(no_cuda):
    cpu_params = tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    cache = tl.init_kv_cache(CFG, 1, 8, device="cpu")
    ids = torch.zeros((1, 2), dtype=torch.long)
    calls = [
        lambda: tl.init_params(torch.Generator().manual_seed(0), CFG),
        lambda: tl.init_kv_cache(CFG, 1, 8),
        lambda: tl.forward(cpu_params, ids, CFG),
        lambda: tl.forward_with_cache(cpu_params, ids, torch.arange(2), cache, CFG),
        lambda: generate(cpu_params, CFG, np.array([1, 2]), 2, temperature=0.0),
        lambda: params_from_numpy({"w": np.zeros(3, np.float32)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # and each runs when asked for the CPU
    assert generate(cpu_params, CFG, np.array([1, 2]), 2, temperature=0.0,
                    device="cpu").shape == (4,)


def _imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "lit_llama_ja_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tp_serve_gate_probe.py"]
    assert len(files) > 10
    for f in files:
        names = set(_imported_top_names(f))
        # whole names: lit_llama_ja_tpu_torch itself starts with lit_llama_ja_tpu
        assert not names & {"jax", "jaxlib", "lit_llama_ja_tpu"}, (f, names)


def test_bf16_leaves_cross_by_their_bits():
    import ml_dtypes

    a = np.array([1.5, -2.25, 3e-3], dtype=ml_dtypes.bfloat16)
    got = params_from_numpy({"w": a}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))


def test_params_from_numpy_copies():
    """The train step updates its tensors in place, so a tree carried over from numpy
    must not share memory with the caller's arrays (it did on the CPU before the
    training slice, and a step wrote through to them)."""
    a = np.arange(4, dtype=np.float32)
    t = params_from_numpy({"w": a}, device="cpu")["w"]
    t.add_(1.0)
    np.testing.assert_array_equal(a, np.arange(4, dtype=np.float32))


def test_wrappers_run_plain_versions_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    qw = torch.from_numpy(rng.integers(0, 256, size=(16, 8)).astype(np.uint8))
    s, z = torch.full((2, 8), 0.1), torch.full((2, 8), 7.0)
    before = quant_matmul_int4.launches
    assert torch.equal(quant_matmul_int4(x, qw, s, z), quant_matmul_int4_ref(x, qw, s, z))
    q = torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
    o, lse = flash_attention_fwd(q, q, q)
    ro, rlse = flash_attention_fwd_ref(q, q, q)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    # plain versions are not kernel launches
    assert quant_matmul_int4.launches == before


def test_wrappers_refuse_malformed_inputs():
    qw = torch.zeros((16, 8), dtype=torch.uint8)
    s = torch.ones((2, 8))
    with pytest.raises(ValueError, match="K=30"):
        quant_matmul_int4(torch.zeros((1, 30)), qw, s, s)
    with pytest.raises(ValueError, match="uint8"):
        quant_matmul_int4(torch.zeros((1, 32)), qw.float(), s, s)
    with pytest.raises(ValueError, match="scales/zeros"):
        quant_matmul_int4(torch.zeros((1, 32)), qw, torch.ones((2, 9)), s)
    q = torch.zeros((1, 2, 5, 8))
    with pytest.raises(ValueError, match="one \\(B, nh, T, hd\\) shape"):
        flash_attention_fwd(q, q[:, :, :4], q)


def test_build_refuses_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    for name in _build.SOURCES:
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


TRAINING_SLICE = ["train/loss.py", "train/lr.py", "train/step.py", "train/trainer.py",
                  "data/packed_dataset.py", "io/checkpoint.py", "utils/cli.py",
                  "cli/pretrain_cli.py", "ops/cuda/flash_attention.py"]


@pytest.mark.parametrize("module", TRAINING_SLICE)
def test_training_slice_imports_no_jax(module):
    names = set(_imported_top_names(REPO / "lit_llama_ja_tpu_torch" / module))
    assert names and not names & {"jax", "jaxlib", "optax", "orbax", "lit_llama_ja_tpu"}, names


def test_training_entry_points_need_explicit_cpu(no_cuda, tmp_path):
    from lit_llama_ja_tpu_torch.cli import pretrain_cli
    from lit_llama_ja_tpu_torch.io import checkpoint
    from lit_llama_ja_tpu_torch.train.step import make_adamw, make_train_step
    from lit_llama_ja_tpu_torch.train.trainer import make_validate_fn

    opt = make_adamw(1e-3)
    calls = [
        lambda: pretrain_cli.main(out_dir=str(tmp_path)),
        lambda: pretrain_cli.main_shakespeare(out_dir=str(tmp_path)),
        lambda: make_train_step(CFG, opt),
        lambda: make_validate_fn(CFG, 1, lambda: iter(())),
        lambda: checkpoint.load_checkpoint(tmp_path),
        lambda: checkpoint.load_train_state(tmp_path),
        lambda: checkpoint.load_state_npz(tmp_path / "x.npz"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the CUDA path of the train step: a step built for the CPU runs there
    params = tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    step = make_train_step(CFG, opt, device="cpu")
    batch = np.zeros((1, 1, 5), np.int64)
    _, _, loss = step(params, opt.init(params), batch)
    assert loss.device.type == "cpu" and torch.isfinite(loss)


def test_flash_bwd_refuses_malformed_inputs():
    q = torch.zeros((1, 2, 5, 8))
    lse = torch.zeros((1, 2, 5))
    with pytest.raises(ValueError, match="one \\(B, nh, T, hd\\) shape"):
        flash_attention_bwd(q, q, q, q, lse, q[:, :, :4])
    with pytest.raises(ValueError, match="one \\(B, nh, T, hd\\) shape"):
        flash_attention_bwd(q[0], q[0], q[0], q[0], lse, q[0])
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, q, q, q, lse[..., :4], q)
    assert "flash_attention_bwd" in _build.SOURCES


QUANT_SLICE = ["quant/linear.py", "quant/gptq.py", "quant/pipeline.py", "io/convert.py",
               "io/tokenizer.py", "infer/evaluate.py", "cli/generate_cli.py",
               "cli/quantize_cli.py", "cli/evaluate_cli.py", "cli/convert_cli.py",
               "ops/cuda/quant_matmul.py", "ops/cuda/quant_matmul_sub4.py"]


@pytest.mark.parametrize("module", QUANT_SLICE)
def test_quantization_slice_imports_no_jax(module):
    names = set(_imported_top_names(REPO / "lit_llama_ja_tpu_torch" / module))
    assert names and not names & {"jax", "jaxlib", "lit_llama_ja_tpu"}, names


def test_quantization_entry_points_need_explicit_cpu(no_cuda, tmp_path):
    from lit_llama_ja_tpu_torch.cli import evaluate_cli, generate_cli, quantize_cli
    from lit_llama_ja_tpu_torch.infer.evaluate import decode_path_perplexity, perplexity

    cpu_params = tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    tokens = np.arange(40) % CFG.vocab_size
    calls = [
        lambda: generate_cli.load_model_any(tmp_path),
        lambda: generate_cli.main(checkpoint_path=str(tmp_path)),
        lambda: quantize_cli.main(checkpoint_path=str(tmp_path)),
        lambda: evaluate_cli.main(checkpoint_path=str(tmp_path)),
        lambda: perplexity(cpu_params, CFG, tokens),
        lambda: decode_path_perplexity(cpu_params, CFG, tokens, window=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert np.isfinite(perplexity(cpu_params, CFG, tokens, device="cpu"))
    assert np.isfinite(decode_path_perplexity(cpu_params, CFG, tokens, window=8, windows=1,
                                              device="cpu"))


def test_quantized_wrappers_run_plain_versions_on_cpu(rng):
    """The K3, K4 and K5 wrappers on CPU tensors are their plain versions and count no
    launch; their sources are built with the others."""
    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm8
    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul_sub4 as qm_sub4
    from lit_llama_ja_tpu_torch.quant.linear import quantize_colblock, quantize_int8_absmax

    w = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    before = (qm8.quant_matmul_int8.launches, qm_sub4.quant_matmul_int2.launches,
              qm_sub4.quant_matmul_int3.launches)
    p8 = quantize_int8_absmax(w)
    p2, p3 = quantize_colblock(w, 2), quantize_colblock(w, 3)
    assert torch.equal(qm8.quant_matmul_int8(x, p8["qweight"], p8["scales"], p8["zeros"]),
                       qm8.quant_matmul_int8_ref(x, p8["qweight"], p8["scales"], p8["zeros"]))
    assert torch.equal(qm_sub4.quant_matmul_int2(x, p2["qweight"], p2["scales"], p2["zeros"]),
                       qm_sub4.quant_matmul_int2_ref(x, p2["qweight"], p2["scales"],
                                                     p2["zeros"]))
    args3 = (p3["qweight"], p3["qweight_hi"], p3["scales"], p3["zeros"])
    assert torch.equal(qm_sub4.quant_matmul_int3(x, *args3),
                       qm_sub4.quant_matmul_int3_ref(x, *args3))
    assert before == (qm8.quant_matmul_int8.launches, qm_sub4.quant_matmul_int2.launches,
                      qm_sub4.quant_matmul_int3.launches)
    assert {"quant_matmul_int8", "quant_matmul_sub4"} <= set(_build.SOURCES)


def test_w4a8_wrapper_runs_its_plain_version_on_cpu(rng):
    """K1's W4A8 modes (`quant_matmul_int4(..., unpack="int8dot*")`) on CPU tensors are
    their plain version and count no launch of either K1 kernel; the exact names keep
    the exact route; an unknown name raises; the W4A8 source is built with the others."""
    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm
    from lit_llama_ja_tpu_torch.quant.linear import quantize_colblock

    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    p = quantize_colblock(w, 4, tile_cols=32)
    args = (p["qweight"], p["scales"], p["zeros"])
    before = (qm.quant_matmul_int4.launches, qm.quant_matmul_int4_w4a8.launches)
    for name in qm.W4A8_MODES:
        assert torch.equal(qm.quant_matmul_int4(x, *args, unpack=name),
                           qm.quant_matmul_int4_w4a8_ref(x, *args))
    assert torch.equal(qm.quant_matmul_int4(x, *args, unpack="bf16"),
                       qm.quant_matmul_int4_ref(x, *args))
    assert before == (qm.quant_matmul_int4.launches, qm.quant_matmul_int4_w4a8.launches)
    with pytest.raises(ValueError, match="unknown unpack"):
        qm.quant_matmul_int4(x, *args, unpack="int8dot_fast")
    assert "quant_matmul_w4a8" in _build.SOURCES


def test_a8_wrappers_run_their_plain_versions_on_cpu(rng):
    """K3's W8A8 and K4/K5's W2A8/W3A8 modes (``unpack="int8dot*"``) on CPU tensors are
    their plain versions and count no launch of any kernel; the A8 source is built with
    the others."""
    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm
    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul_sub4 as qs
    from lit_llama_ja_tpu_torch.quant.linear import quantize_colblock, quantize_int8_absmax

    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    p8, p2, p3 = quantize_int8_absmax(w), quantize_colblock(w, 2), quantize_colblock(w, 3)
    a8, a2 = (p8["qweight"], p8["scales"], p8["zeros"]), (p2["qweight"], p2["scales"], p2["zeros"])
    a3 = (p3["qweight"], p3["qweight_hi"], p3["scales"], p3["zeros"])
    fns = (qm.quant_matmul_int8, qm.quant_matmul_int8_w8a8, qs.quant_matmul_int2,
           qs.quant_matmul_int2_a8, qs.quant_matmul_int3, qs.quant_matmul_int3_a8)
    before = [f.launches for f in fns]
    assert torch.equal(qm.quant_matmul_int8(x, *a8, unpack="int8dot"),
                       qm.quant_matmul_int8_w8a8_ref(x, *a8))
    for name in qs.A8_MODES:
        assert torch.equal(qs.quant_matmul_int2(x, *a2, unpack=name),
                           qs.quant_matmul_int2_a8_ref(x, *a2))
        assert torch.equal(qs.quant_matmul_int3(x, *a3, unpack=name),
                           qs.quant_matmul_int3_a8_ref(x, *a3))
    assert before == [f.launches for f in fns]
    assert "quant_matmul_a8" in _build.SOURCES


SERVING_SLICE = ["infer/paged.py", "infer/serving.py", "cli/serve_cli.py",
                 "ops/cuda/paged_attention.py", "infer/speculative.py", "infer/spec_serving.py",
                 "infer/tree_spec.py"]


@pytest.mark.parametrize("module", SERVING_SLICE)
def test_serving_slice_imports_no_jax(module):
    names = set(_imported_top_names(REPO / "lit_llama_ja_tpu_torch" / module))
    assert names and not names & {"jax", "jaxlib", "lit_llama_ja_tpu"}, names


def test_serving_entry_points_need_explicit_cpu(no_cuda, tmp_path):
    from lit_llama_ja_tpu_torch.cli import serve_cli
    from lit_llama_ja_tpu_torch.infer import paged
    from lit_llama_ja_tpu_torch.infer.serving import Engine
    from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
    from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
    from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine

    cpu_params = tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    pool = paged.init_page_pool(CFG, 4, 4, quantized="int8", device="cpu")
    args = (cpu_params, np.array([[1]]), np.array([[2]]), np.array([[1]]), pool, CFG, "int8")
    calls = [
        lambda: paged.init_page_pool(CFG, 4, 4),
        lambda: paged.paged_forward(*args),
        lambda: paged.paged_forward_read(*args),
        lambda: paged.PagedEngine(cpu_params, CFG),
        lambda: Engine(cpu_params, CFG),
        lambda: serve_cli.main(checkpoint_path=str(tmp_path)),
        lambda: speculative_generate(cpu_params, CFG, cpu_params, CFG, np.array([1, 2]), 3),
        lambda: SpeculativePagedEngine(cpu_params, CFG, draft_params=cpu_params,
                                       draft_config=CFG),
        lambda: TreeSpeculativePagedEngine(cpu_params, CFG, draft_params=cpu_params,
                                           draft_config=CFG),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    logits, _ = paged.paged_forward(*args, device="cpu")
    assert logits.shape == (1, 1, CFG.padded_vocab_size) and torch.isfinite(logits).all()
    out = paged.PagedEngine(cpu_params, CFG, n_pages=8, page_size=4, quantize_kv="int8",
                            device="cpu").run([(np.array([1, 2]), 3)], temperature=0.0)
    assert out[0].shape == (5,)
    assert Engine(cpu_params, CFG, device="cpu").run([(np.array([1, 2]), 3)])[0].shape == (5,)
    assert speculative_generate(cpu_params, CFG, cpu_params, CFG, np.array([1, 2]), 3, K=2,
                                device="cpu").shape == (5,)
    for cls in (SpeculativePagedEngine, TreeSpeculativePagedEngine):
        eng = cls(cpu_params, CFG, draft_params=cpu_params, draft_config=CFG, n_pages=8,
                  page_size=4, device="cpu")
        assert eng.run([(np.array([1, 2]), 3)], temperature=0.0)[0].shape == (5,)


def test_paged_wrappers_run_plain_versions_and_refuse_malformed_inputs(rng):
    """K7 and K8 on CPU tensors are their plain version and count no launch; shapes
    that do not fit raise; their source is built with the others."""
    from lit_llama_ja_tpu_torch.ops.cuda import paged_attention as pa

    q = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    kp = torch.from_numpy(rng.integers(-127, 128, (5, 3, 4, 8)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(0.01, 0.02, (5, 3, 4)).astype(np.float32))
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    pos = torch.tensor([6, 2], dtype=torch.int32)
    before = (pa.paged_decode_attention.launches, pa.paged_decode_attention_db.launches)
    want = pa.paged_decode_attention_ref(q, kp, ks, kp, ks, tables, pos)
    for fn in (pa.paged_decode_attention, pa.paged_decode_attention_db):
        assert torch.equal(fn(q, kp, ks, kp, ks, tables, pos), want)
    assert before == (pa.paged_decode_attention.launches, pa.paged_decode_attention_db.launches)
    with pytest.raises(ValueError, match="v_pages must be"):
        pa.paged_decode_attention(q, kp, ks, kp[:, :2], ks, tables, pos)
    with pytest.raises(ValueError, match="k_scale must be"):
        pa.paged_decode_attention(q, kp, ks[..., :3], kp, ks, tables, pos)
    with pytest.raises(ValueError, match="tables must be"):
        pa.paged_decode_attention(q, kp, ks, kp, ks, tables[:1], pos)
    with pytest.raises(ValueError, match="pos must be"):
        pa.paged_decode_attention_db(q, kp, ks, kp, ks, tables, pos[:1])
    assert "paged_attention" in _build.SOURCES


def test_package_data_ships_every_source_built_at_first_use():
    """An installed (non-editable) port builds its kernels and its C++ reader from the
    sources `setup.py` ships: every CUDA source, every header they include and the
    reader's source."""
    import fnmatch

    tree = ast.parse((REPO / "setup.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "setup")
    data = ast.literal_eval(next(k.value for k in call.keywords if k.arg == "package_data"))
    globs = data["lit_llama_ja_tpu_torch"]
    root = REPO / "lit_llama_ja_tpu_torch"
    needed = [*(root / "csrc").iterdir(), root / "native" / "packed_reader.cpp"]
    assert len(needed) > 8
    for path in needed:
        rel = path.relative_to(root).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


PARALLEL_SLICE = ["parallel/mesh.py", "parallel/specs.py", "parallel/sharded.py",
                  "parallel/collective_matmul.py", "parallel/sp_attention.py",
                  "parallel/ring_attention.py", "parallel/sp_forward.py", "parallel/ep.py"]


@pytest.mark.parametrize("module", PARALLEL_SLICE)
def test_parallel_slice_imports_no_jax(module):
    names = set(_imported_top_names(REPO / "lit_llama_ja_tpu_torch" / module))
    assert names and not names & {"jax", "jaxlib", "optax", "lit_llama_ja_tpu"}, names


def test_parallel_entry_points_need_explicit_cpu(no_cuda):
    """The sequence- and expert-parallel entry points take ``device="cuda"`` by default
    and raise without a card, before any collective."""
    from lit_llama_ja_tpu_torch.models.moe import MoEConfig
    from lit_llama_ja_tpu_torch.parallel.ep import forward_moe_ep, make_moe_train_step_ep
    from lit_llama_ja_tpu_torch.parallel.mesh import single_device_mesh
    from lit_llama_ja_tpu_torch.parallel.sp_forward import forward_sp
    from lit_llama_ja_tpu_torch.train.step import make_adamw

    mesh = single_device_mesh()
    cfg = MoEConfig(block_size=8, vocab_size=32, n_layer=1, n_head=2, n_embd=8)
    for call in (lambda: forward_sp({}, torch.zeros((1, 4), dtype=torch.long), cfg, mesh),
                 lambda: forward_moe_ep({}, torch.zeros((2, 4), dtype=torch.long), cfg, mesh),
                 lambda: make_moe_train_step_ep(cfg, make_adamw(1e-3), mesh)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
