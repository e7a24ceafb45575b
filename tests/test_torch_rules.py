"""Rules of the PyTorch port, checked on a machine without a card:

* every entry point raises unless the caller asks for the CPU;
* neither the package nor `chip_smoke.py` imports jax or the JAX package;
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
    files = sorted((REPO / "lit_llama_ja_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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
