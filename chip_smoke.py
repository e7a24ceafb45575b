"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line and each asserting (any failure ends the run
with a non-zero exit and no result line):

  1. device    the card's name and power limit; builds the CUDA kernels from
               ``lit_llama_ja_tpu_torch/csrc`` and prints the build seconds.
  2. kernels   K1, the int4 dequant-matmul, against its plain version at the LLaMA-7B
               shapes, M in {1, 512}, whole-column and 128-row-group scales.
  3. kernels   K2, the causal flash-attention forward, against its plain version for
               (n_head, head_dim) in {(32, 128), (10, 78), (8, 64)}, T in {512, 777, 2048}.
     kernels   both kernels against their plain versions at ragged and strided shapes
               off the 7B path (one line each, correctness only).
  4. kernels   K6, the causal flash-attention backward, against its plain version for
               (n_head, head_dim) in {(10, 78), (8, 64), (32, 128)} at T 2048, and at
               the 125M training shape (batch 4, 10 x 78, T 2048), with q, k, v and dO
               in the layouts the model hands over; then ragged and strided edges.
  5. kernels   K3 (int8: symmetric whole-column, and uint8 in 128-row groups), K4 (int2:
               whole-column, and 64-row groups) and K5 (int3: whole-column) against their
               plain versions at the 7B shapes (M 1 and 512) and the 125M shapes (M 1 and
               2048), timed; then off those shapes (ragged M, N and scale groups, stored
               rows past K), correctness only.
  6. generate  LLaMA-7B at full width and depth, one run per weight format: int4 (random
               packs from a seed), llm.int8 (random bf16 weights quantized on the card by
               `int8_quantize_model`), gptq.int2, gptq.int3 and gptq.mix-a4m2h4-g64 (random
               packs by the recipe of `bench.py:73-180`). The port's `generate` on a
               500-token prompt with an int4 KV cache, greedy, 32 new tokens; launch
               counts of every kernel, repeatability, and the prefill logits against the
               plain versions of every kernel used.
  7. train     the 125M ja model at full width and depth through
               `cli/pretrain_cli.main` (T 2048, micro-batch 4, batch 128: 32 micro-
               batches per step) on a synthetic packed dataset written from the seed
               (a repeated random sequence), 8 steps with a save and a validation
               midway, then `--resume` from the saved state; finite and falling loss,
               the resumed losses against the uninterrupted run's, K2/K6 launch counts
               (and K2's doubling under remat), the gradients of one micro-batch
               against the plain versions of K2 and K6, step time, tokens/s, model
               flop share and peak memory.
  8. quant_eval the 125M model from the train phase's last checkpoint: perplexity on 4
               windows of 2048 tokens of the synthetic data, in fp; after GPTQ at
               gptq.int4, gptq.int3, gptq.int2-g64 and gptq.mix on 8 calibration windows
               (saved, then read back by `load_model_any`); and after llm.int8 and
               llm.int8-dyn quantization at load. Each perplexity through the kernels
               against the same with the plain versions swapped in (1e-2 relative), with
               its launch counts; then one decode-path perplexity (int4 KV cache, a
               256-token window) of the mix, kernels against plain versions.
  9. kernels   one line with every ported kernel, its launches on its path and by path,
               its time beside its bound, the plain version's time and the library
               call's time. Each time there is the sum over the kernel's launches in one
               forward or step of its path: K1, K3, K4 and K5 over the 161 linears of
               one 7B decode step of their format (M = 1; the prefill_* keys at
               M = 512), K2 over the 32 layers of the 7B prefill, K6 over the 384
               launches of one 125M training step.
 10. the last line: {"ok": true, "device": {...}}.

Times are CUDA-event medians of 20 launches after 3 warm-up launches, with a 256 MB
buffer written between launches so that each one finds the L2 cache cold, as the
decode loop does. Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM and
989 TFLOP/s of dense bf16. TF32 is off for matmuls and cuDNN, so the float32 parts
of the plain versions run in full float32.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from lit_llama_ja_tpu_torch.cli import pretrain_cli
from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_configs
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder
from lit_llama_ja_tpu_torch.infer.evaluate import decode_path_perplexity, perplexity
from lit_llama_ja_tpu_torch.infer.generate import bucket_length, generate
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree, save_checkpoint
from lit_llama_ja_tpu_torch.models.llama import (
    cast_params,
    forward,
    forward_with_cache,
    init_kv_cache,
    init_params,
)
from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    quant_matmul_int4,
    quant_matmul_int4_ref,
    quant_matmul_int8,
    quant_matmul_int8_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul_sub4 import (
    quant_matmul_int2,
    quant_matmul_int2_ref,
    quant_matmul_int3,
    quant_matmul_int3_ref,
)
from lit_llama_ja_tpu_torch.quant.linear import dequantize_with_k, parse_quant_mode, sub4_pad_rows
from lit_llama_ja_tpu_torch.quant.pipeline import gptq_quantize_model, int8_quantize_model
from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss
from lit_llama_ja_tpu_torch.train.step import cast_floating, make_adamw, make_train_step

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SEED = 0
K1_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
K2_SHAPES = [(32, 128), (10, 78), (8, 64)]
K2_LENGTHS = [512, 777, 2048]
# (K, N, groups, Ms) off the 7B shapes; (768, 35008) is the 125M ja lm_head
K1_EDGES = [(90, 36, 2, (3, 40)), (768, 35008, 6, (1, 17)), (4096, 1000, 32, (2, 16)),
            (1000, 264, 3, (5, 8, 130))]
K2_EDGES = [(2, 3, 1, 64, False), (2, 3, 65, 96, False), (1, 4, 200, 40, False),
            (3, 2, 130, 128, True), (1, 10, 300, 78, True)]  # (B, nh, T, hd, strided)
K6_SHAPES = [(1, 10, 78), (1, 8, 64), (1, 32, 128), (4, 10, 78)]  # (B, n_head, hd), T 2048
K6_EDGES = [(3, 2, 1, 64, True), (1, 4, 65, 78, True), (3, 2, 777, 64, False),
            (1, 3, 777, 128, True), (2, 3, 130, 96, False)]  # (B, nh, T, hd, strided)
TRAIN_MODEL = "125M"
TRAIN = dict(micro_batch_size=4, batch_size=128, max_iters=8, warmup_iters=2, save_interval=4,
             eval_interval=4, eval_iters=2, log_interval=1, train_prefixes="synth",
             val_prefixes="synth", device="cuda")
RESUME_REL_TOL = 2e-3  # resumed vs uninterrupted losses: the CUDA embedding backward
                       # adds with atomics, so the sums' order changes from run to run
GRAD_LOSS_TOL = 1e-2  # one micro-batch, kernel vs plain attention: |Δloss|
GRAD_REL_TOL = 5e-2  # and every gradient leaf: ||Δg|| <= 5e-2 ||g_plain|| (bf16 compute)
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
REL_TOL = 2e-2  # kernel vs plain: |got - want| <= 2e-2 * max|want| (bf16 inputs)
LSE_ATOL = 1e-3  # f32 statistics on both sides
LOGIT_REL_TOL = 5e-2  # 32 bf16 layers: ||Δ|| <= 5e-2 ||plain|| over the prefill logits
ARGMAX_AGREE = 0.9  # share of prefill rows whose argmax agrees
# the quantized dequant-matmuls: name -> (wrapper, plain version, leaves it takes)
QUANT_KERNELS = {
    "quant_matmul_int4": (quant_matmul_int4, quant_matmul_int4_ref,
                          ("qweight", "scales", "zeros")),
    "quant_matmul_int8": (quant_matmul_int8, quant_matmul_int8_ref,
                          ("qweight", "scales", "zeros")),
    "quant_matmul_int2": (quant_matmul_int2, quant_matmul_int2_ref,
                          ("qweight", "scales", "zeros")),
    "quant_matmul_int3": (quant_matmul_int3, quant_matmul_int3_ref,
                          ("qweight", "qweight_hi", "scales", "zeros")),
}
KERNELS = {**{n: k[0] for n, k in QUANT_KERNELS.items()},
           "flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd}
# K3-K5 cases (kernel, bits, groupsize, signed); signed: int8 levels, zeros 0
QUANT_CASES = [("quant_matmul_int8", 8, -1, True), ("quant_matmul_int8", 8, 128, False),
               ("quant_matmul_int2", 2, -1, False), ("quant_matmul_int2", 2, 64, False),
               ("quant_matmul_int3", 3, -1, False)]
Q125_SHAPES = [(780, 2340), (780, 780), (780, 2304), (2304, 780), (780, 35008)]
# (K, N, groupsize, Ms) off the model shapes; K3 at (780, 13 groups) reads its scale
# rows by the _expand_tiles rule, K4 and K5 store padded rows past K
QUANT_EDGES = {
    "quant_matmul_int8": [(90, 36, -1, (3, 40)), (780, 2340, 64, (1, 17, 130)),
                          (1000, 264, 334, (5, 8)), (4096, 1000, 128, (2, 16))],
    "quant_matmul_int2": [(780, 36, 64, (1, 3, 17, 130)), (100, 264, -1, (1, 5, 40)),
                          (2304, 780, 64, (1, 130)), (11008, 1000, -1, (1, 16, 17))],
    "quant_matmul_int3": [(780, 36, 64, (1, 3, 17, 130)), (100, 264, -1, (1, 5, 40)),
                          (2304, 780, 64, (1, 130)), (11008, 1000, -1, (1, 16, 17))],
}
GEN_FORMATS = ("llm.int8", "gptq.int2", "gptq.int3", "gptq.mix-a4m2h4-g64")
EVAL_WINDOWS = 4  # 2048-token windows of the 125M perplexity
CALIB_WINDOWS = 8  # 2048-token GPTQ calibration windows
GPTQ_MODES = ("gptq.int4", "gptq.int3", "gptq.int2-g64", "gptq.mix")
PPL_REL_TOL = 1e-2  # kernel vs plain perplexity (bf16 activations, f32 sums)
DECODE_WINDOW = 256  # tokens of the one decode-path perplexity window


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """CUDA-event median over launches, each after an L2-evicting write."""

    def __init__(self, device):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "built": built, "build_s": build_s})
    return name


def synth_int4(g, K, N, groups, device, lead=()):
    """Random packed int4 linear: qweight bytes, scales around 0.01, zeros 0..15."""
    qweight = torch.randint(0, 256, (*lead, K // 2, N), generator=g, device=device,
                            dtype=torch.uint8)
    scales = torch.rand((*lead, groups, N), generator=g, device=device) * 0.01 + 0.005
    zeros = torch.randint(0, 16, (*lead, groups, N), generator=g, device=device).float()
    return qweight, scales, zeros


def check_k1(x, qweight, scales, zeros, case):
    """K1 against its plain version on the same inputs: (max_abs_err, tol)."""
    got = quant_matmul_int4(x, qweight, scales, zeros).float()
    want = quant_matmul_int4_ref(x, qweight, scales, zeros).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = REL_TOL * want.abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (case, err, tol)
    return err, tol


def check_k2(q, k, v, case):
    """K2 against its plain version on the same inputs: (max_abs_err, tol, lse error)."""
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    tol = REL_TOL * ro.float().abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    assert torch.isfinite(o).all() and err <= tol, (case, err, tol)
    assert lse_err <= LSE_ATOL, (case, lse_err)
    return err, tol, lse_err


def phase_k1(timer, g, device):
    rows = []
    for K, N in K1_SHAPES:
        for groups in (1, K // 128):
            qweight, scales, zeros = synth_int4(g, K, N, groups, device)
            w = dequantize_with_k({"qweight": qweight, "scales": scales, "zeros": zeros},
                                  K, dtype=torch.bfloat16)
            for M in (1, 512):
                x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
                err, tol = check_k1(x, qweight, scales, zeros, (K, N, groups, M))
                n_bytes = qweight.numel() + 8 * groups * N + 2 * M * K + 2 * M * N
                b, by = bound_ms(n_bytes, 2.0 * M * K * N)
                row = {"K": K, "N": N, "groups": groups, "M": M, "max_abs_err": err, "tol": tol,
                       "ms": timer.ms(lambda: quant_matmul_int4(x, qweight, scales, zeros)),
                       "plain_ms": timer.ms(lambda: quant_matmul_int4_ref(x, qweight, scales, zeros)),
                       "library_ms": timer.ms(lambda: torch.matmul(x, w)),
                       "bound_ms": b, "bound_by": by}
                emit({"phase": "kernels", "kernel": "quant_matmul_int4", **row})
                rows.append(row)
            del w
    return rows


def phase_k2(timer, g, device):
    rows = []
    for nh, hd in K2_SHAPES:
        for T in K2_LENGTHS:
            q, k, v = (torch.randn((1, nh, T, hd), generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
            err, tol, lse_err = check_k2(q, k, v, (nh, hd, T))
            flops = 4.0 * hd * nh * T * (T + 1) / 2  # q k^T and p v over the causal pairs
            b, by = bound_ms(2 * 4 * nh * T * hd + 4 * nh * T, flops)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row = {"n_head": nh, "head_dim": hd, "T": T, "max_abs_err": err, "tol": tol,
                   "lse_max_abs_err": lse_err,
                   "ms": timer.ms(lambda: flash_attention_fwd(q, k, v)),
                   "plain_ms": timer.ms(lambda: flash_attention_fwd_ref(q, k, v)),
                   "library_ms": timer.ms(lambda: sdpa(q, k, v, is_causal=True)),
                   "bound_ms": b, "bound_by": by}
            emit({"phase": "kernels", "kernel": "flash_attention_fwd", **row})
            rows.append(row)
    return rows


def phase_edges(g, device):
    """Both kernels against their plain versions off the 7B shapes: ragged M, N and K
    edges, the unvectorized loads (K or N not a multiple of 8), scale groups that end
    inside a k-tile or split a packed byte, every GEMV row count, batch > 1, T = 1,
    head dims padded inside the tile and a strided q, k, v. Correctness only."""
    k1 = []
    for K, N, G, Ms in K1_EDGES:
        qweight, scales, zeros = synth_int4(g, K, N, G, device)
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
            err, tol = check_k1(x, qweight, scales, zeros, (K, N, G, M))
            k1.append({"K": K, "N": N, "groups": G, "M": M, "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "kernel": "quant_matmul_int4", "edges": k1})
    k2 = []
    for B, nh, T, hd, strided in K2_EDGES:
        if strided:  # q, k, v as views of one (B, T, 3, nh, hd) projection
            qkv = torch.randn((B, T, 3, nh, hd), generator=g, device=device).to(torch.bfloat16)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.randn((B, nh, T, hd), generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
        err, tol, lse_err = check_k2(q, k, v, (B, nh, T, hd, strided))
        k2.append({"B": B, "n_head": nh, "T": T, "head_dim": hd, "strided": strided,
                   "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err})
    emit({"phase": "kernels", "kernel": "flash_attention_fwd", "edges": k2})


def attention_inputs(g, device, B, nh, T, hd, strided):
    """bf16 q, k, v, dO. strided: q, k, v as views of one (B, T, 3, nh, hd) projection
    and dO as the transpose of a (B, T, nh, hd) gradient, the layouts the model's
    forward and autograd hand over; otherwise contiguous (B, nh, T, hd)."""
    if strided:
        qkv = torch.randn((B, T, 3, nh, hd), generator=g, device=device).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn((B, T, nh, hd), generator=g, device=device).to(torch.bfloat16)
        return q, k, v, do.transpose(1, 2)
    return [torch.randn((B, nh, T, hd), generator=g, device=device).to(torch.bfloat16)
            for _ in range(4)]


def check_k6(q, k, v, do, case):
    """K6 against its plain version on the same inputs (K2's o and lse):
    (max_abs_err, tol). dq, dk and dv are each held to 2e-2 of the largest |want| of
    the three: a gradient that is zero in exact arithmetic (dq and dk at T = 1) is
    rounding noise on both sides, with no scale of its own."""
    o, lse = flash_attention_fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    tol = REL_TOL * max(b.float().abs().max().item() for b in want)
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e = (a.float() - b.float()).abs().max().item()
        assert torch.isfinite(a).all() and e <= tol, (case, name, e, tol)
        err = max(err, e)
    return err, tol, (o, lse)


def phase_k6(timer, g, device):
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    T = 2048
    for B, nh, hd in K6_SHAPES:
        q, k, v, do = attention_inputs(g, device, B, nh, T, hd, strided=True)
        err, tol, (o, lse) = check_k6(q, k, v, do, (B, nh, hd, T))
        # five products (s, dp, dv, dk, dq) of 2 * hd flops per causal pair
        flops = 5 * 2.0 * hd * B * nh * T * (T + 1) / 2
        b, by = bound_ms(8 * B * nh * T * hd * 2 + 4 * B * nh * T, flops)  # + lse
        # K2 at the same shape, as the training step runs it: q k^T and p v
        fb, fby = bound_ms(2 * 4 * B * nh * T * hd + 4 * B * nh * T, flops * 2 / 5)
        qkv = q.detach().clone(), k.detach().clone(), v.detach().clone()
        leaves = [t.requires_grad_(True) for t in qkv]
        out = sdpa(*leaves, is_causal=True)
        row = {"B": B, "n_head": nh, "head_dim": hd, "T": T, "max_abs_err": err, "tol": tol,
               "ms": timer.ms(lambda: flash_attention_bwd(q, k, v, o, lse, do)),
               "plain_ms": timer.ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do)),
               "library_ms": timer.ms(
                   lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)),
               "fwd_ms": timer.ms(lambda: flash_attention_fwd(q, k, v)),
               "fwd_plain_ms": timer.ms(lambda: flash_attention_fwd_ref(q, k, v)),
               "fwd_library_ms": timer.ms(lambda: sdpa(q, k, v, is_causal=True)),
               "fwd_bound_ms": fb, "fwd_bound_by": fby,
               "bound_ms": b, "bound_by": by}
        del out, leaves
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", **row})
        rows.append(row)
    edges = []
    for B, nh, T, hd, strided in K6_EDGES:
        q, k, v, do = attention_inputs(g, device, B, nh, T, hd, strided)
        err, tol, _ = check_k6(q, k, v, do, (B, nh, T, hd, strided))
        edges.append({"B": B, "n_head": nh, "T": T, "head_dim": hd, "strided": strided,
                      "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "edges": edges})
    return rows


def synth_quant(g, bits, K, N, groupsize, device, signed=False, lead=()):
    """Random pack of one linear: random bytes over every stored row (pad rows of a
    sub-4-bit pack too: the kernels must never multiply them), scales around 0.01 and
    random zero levels (0 for signed int8)."""
    def rand_bytes(rows, dtype=torch.uint8, lo=0, hi=256):
        return torch.randint(lo, hi, (*lead, rows, N), generator=g, device=device).to(dtype)

    Kp = sub4_pad_rows(K, groupsize) if bits in (2, 3) else K
    G = 1 if groupsize < 0 else (Kp // groupsize if bits in (2, 3) else -(-K // groupsize))
    leaves = {"scales": torch.rand((*lead, G, N), generator=g, device=device) * 0.01 + 0.005,
              "zeros": torch.randint(0, 2**bits, (*lead, G, N), generator=g,
                                     device=device).float()}
    if bits == 8 and signed:
        leaves["qweight"] = rand_bytes(K, torch.int8, -127, 128)
        leaves["zeros"].zero_()
    elif bits == 8:
        leaves["qweight"] = rand_bytes(K)
    else:
        leaves["qweight"] = rand_bytes(Kp // 4)
        if bits == 3:
            leaves["qweight_hi"] = rand_bytes(Kp // 8)
    return leaves


def quant_args(name, leaves):
    return [leaves[k] for k in QUANT_KERNELS[name][2]]


def check_quant(name, x, leaves, case):
    """A quantized kernel against its plain version on the same inputs:
    (max_abs_err, tol)."""
    fn, ref, _ = QUANT_KERNELS[name]
    args = quant_args(name, leaves)
    got = fn(x, *args).float()
    want = ref(x, *args).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = REL_TOL * want.abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (name, case, err, tol)
    return err, tol


def phase_quant_kernels(timer, g, device):
    """K3 (int8 symmetric whole-column; uint8 in 128-row groups), K4 (whole-column;
    64-row groups) and K5 (whole-column) against their plain versions at the 7B
    shapes (M 1 and 512) and the 125M shapes (M 1 and 2048), timed beside their
    bounds, plain versions and the library's bf16 matmul on the dequantized weight."""
    rows = []
    shapes = [(K, N, "7B", (1, 512)) for K, N in K1_SHAPES]
    shapes += [(K, N, "125M", (1, 2048)) for K, N in Q125_SHAPES]
    for name, bits, gs, signed in QUANT_CASES:
        fn = QUANT_KERNELS[name][0]
        for K, N, model, Ms in shapes:
            leaves = synth_quant(g, bits, K, N, gs, device, signed)
            args = quant_args(name, leaves)
            w = dequantize_with_k(leaves, K, dtype=torch.bfloat16)
            weight_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
            for M in Ms:
                x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
                err, tol = check_quant(name, x, leaves, (K, N, gs, M))
                b, by = bound_ms(weight_bytes + 2 * M * K + 2 * M * N, 2.0 * M * K * N)
                ref = QUANT_KERNELS[name][1]
                row = {"kernel": name, "bits": bits, "groupsize": gs, "signed": signed,
                       "model": model, "K": K, "N": N, "groups": leaves["scales"].shape[0],
                       "M": M, "max_abs_err": err, "tol": tol,
                       "ms": timer.ms(lambda: fn(x, *args)),
                       "plain_ms": timer.ms(lambda: ref(x, *args)),
                       "library_ms": timer.ms(lambda: torch.matmul(x, w)),
                       "bound_ms": b, "bound_by": by}
                emit({"phase": "kernels", **row})
                rows.append(row)
            del w, leaves, args
    return rows


def phase_quant_edges(g, device):
    """K3-K5 off the model shapes: ragged M and N, unvectorized loads, every GEMV row
    count, ragged scale groups (K3), stored rows past K (K4, K5). Correctness only."""
    for name, cases in QUANT_EDGES.items():
        bits = {"quant_matmul_int8": 8, "quant_matmul_int2": 2, "quant_matmul_int3": 3}[name]
        out = []
        for K, N, gs, Ms in cases:
            leaves = synth_quant(g, bits, K, N, gs, device, signed=gs < 0)
            for M in Ms:
                x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
                err, tol = check_quant(name, x, leaves, (K, N, gs, M))
                out.append({"K": K, "N": N, "stored_rows": leaves["qweight"].shape[0]
                            * {8: 1, 2: 4, 3: 4}[bits], "groups": leaves["scales"].shape[0],
                            "M": M, "max_abs_err": err, "tol": tol})
        emit({"phase": "kernels", "kernel": name, "edges": out})


def synth_7b_params(config: LLaMAConfig, g, device, fmt="int4"):
    """LLaMA params of a format, bf16 embedding and norms, one pack per layer:
    * int4: random packed-int4 bytes, whole-column scales 0.01 and zeros 7 (the int4
      tree layout of the quantized JAX checkpoints);
    * gptq.int2 / gptq.int3 / the mix (int4 attention and head, int2 MLP in 64-row
      groups): random bytes over the padded rows, as `bench.py:73-180` makes them,
      but with the zero point at the mean level, (2**bits - 1) / 2, and the scale
      that gives each linear unit gain, 1 / (sqrt(K) * std of the levels). With
      bench.py's integer zeros the weights have a mean of +-scale / 2, the residual
      stream grows along one direction, the attention scores reach thousands and the
      softmax becomes a hard argmax in which bf16 rounding flips whole rows: one
      draw of the mix (and one of int4) gave a prefill-logit error of 0.088;
    * llm.int8: N(0, 0.02/8) bf16 weights drawn from ``g`` and quantized on the card
      by `int8_quantize_model(outliers=True)`, the load-time path of `load_model_any`.
    """
    L, D, H, V = config.n_layer, config.n_embd, config.n_hidden, config.padded_vocab_size
    bf16 = torch.bfloat16
    if fmt == "llm.int8":
        fp = init_params(g, config, dtype=bf16, device=device)
        return int8_quantize_model(fp, outliers=True)
    _, bits, groupsize = parse_quant_mode("gptq.int4" if fmt == "int4" else fmt)

    def qlin(K, N, name, lead=()):
        nb = bits if isinstance(bits, int) else bits["head" if name == "lm_head" else name]
        gs = groupsize if nb < 4 else -1
        Kp = sub4_pad_rows(K, gs) if nb < 4 else K
        G = 1 if gs < 0 else Kp // gs
        rows = {4: K // 2, 2: Kp // 4, 3: Kp // 4}[nb]
        if fmt == "int4":
            scale, zero = 0.01, 7.0
        else:
            n_levels = 2**nb
            scale = 1.0 / math.sqrt(K * (n_levels**2 - 1) / 12)
            zero = (n_levels - 1) / 2
        out = {"qweight": torch.randint(0, 256, (*lead, rows, N), generator=g, device=device,
                                        dtype=torch.uint8),
               "scales": torch.full((*lead, G, N), scale, device=device),
               "zeros": torch.full((*lead, G, N), zero, device=device)}
        if nb == 3:
            out["qweight_hi"] = torch.randint(0, 256, (*lead, Kp // 8, N), generator=g,
                                              device=device, dtype=torch.uint8)
        return out

    return {
        "wte": {"weight": (torch.randn((V, D), generator=g, device=device) * 0.02).to(bf16)},
        "lm_head": qlin(D, V, "lm_head"),
        "ln_f": {"scale": torch.ones((D,), dtype=bf16, device=device)},
        "blocks": {
            "rms_1": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "attn": {"c_attn": qlin(D, 3 * D, "attn", (L,)), "c_proj": qlin(D, D, "attn", (L,))},
            "rms_2": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "mlp": {"c_fc1": qlin(D, H, "mlp", (L,)), "c_fc2": qlin(D, H, "mlp", (L,)),
                    "c_proj": qlin(H, D, "mlp", (L,))},
        },
    }


def launches_per_forward(fmt: str, L: int):
    """Quantized-kernel launches of one forward of a 7B format: 5 linears per layer and
    the lm_head."""
    one = {"int4": "quant_matmul_int4", "llm.int8": "quant_matmul_int8",
           "gptq.int2": "quant_matmul_int2", "gptq.int3": "quant_matmul_int3"}
    if fmt in one:
        return {one[fmt]: 5 * L + 1}
    return {"quant_matmul_int4": 2 * L + 1, "quant_matmul_int2": 3 * L}  # the mix


def expect_launches(launches, want):
    """Every count as ``want`` says, and every kernel it does not name at 0."""
    assert all(launches[k] == want.get(k, 0) for k in launches), (launches, want)


def phase_generate(g, device, fmt="int4"):
    config = LLaMAConfig.from_name("7B")
    assert llama_configs["7B"] == dict(n_layer=32, n_head=32, n_embd=4096)
    L = config.n_layer
    t_build = time.perf_counter()
    params = synth_7b_params(config, g, device, fmt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    T, new = 500, 32
    prompt = torch.randint(0, config.vocab_size, (T,), generator=g, device=device).cpu().numpy()
    kw = dict(temperature=0.0, cache_dtype=torch.bfloat16, quantize_kv="int4", device=device)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, config, prompt, n, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    run(1)  # warm-up: allocator, rope table
    _counts_zero()
    out_a, _ = run(new)
    launches = _counts()
    per_forward = launches_per_forward(fmt, L)
    expect_launches(launches, {**{k: v * new for k, v in per_forward.items()},
                               "flash_attention_fwd": L})
    assert out_a.shape == (T + new,) and (out_a[:T] == prompt).all()
    assert ((out_a >= 0) & (out_a < config.padded_vocab_size)).all()

    torch.cuda.reset_peak_memory_stats()
    out_b, total_ms = run(new)
    peak = torch.cuda.max_memory_allocated()
    assert (out_a == out_b).all(), "greedy generation is not repeatable"
    _, prefill_ms = run(1)

    # prefill logits, kernel path vs the plain versions of every kernel on the card
    P = bucket_length(T)
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :T] = torch.as_tensor(prompt, device=device)

    def prefill():
        cache = init_kv_cache(config, 1, T + new, torch.bfloat16, "int4", device=device)
        return forward_with_cache(params, idx, torch.arange(P), cache, config,
                                  prefill_attn=True, device=device)[0].float()

    got = prefill()
    with plain_versions():
        want = prefill()
    assert got.shape == (1, P, config.padded_vocab_size) and torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (fmt, rel, agree)
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    weights = {"int4": "int4, G=1", "llm.int8": "llm.int8 (static bf16 outlier rows)",
               "gptq.int2": "int2, G=1", "gptq.int3": "int3, G=1",
               "gptq.mix-a4m2h4-g64": "int4 attention and head G=1, int2 MLP in 64-row groups"}
    emit({"phase": "generate", "config": "7B", "format": fmt, "n_layer": L,
          "weights": weights[fmt], "kv_cache": "int4", "prompt": T, "bucket": P,
          "new_tokens": new, "weight_bytes": weight_bytes, "build_s": build_s,
          "launches": {k: v for k, v in launches.items() if v},
          "launches_per_forward": {**per_forward, "flash_attention_fwd": L},
          "prefill_ms": prefill_ms, "total_ms": total_ms,
          "decode_ms_per_token": decode_ms, "decode_tok_s": 1e3 / decode_ms,
          "peak_mem_bytes": peak, "logits_rel_err": rel, "argmax_agree": agree,
          "tokens": out_a[T:].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches


def synth_sequence(config: LLaMAConfig) -> np.ndarray:
    """The synthetic corpus: one random 1024-token sequence from the seed, repeated."""
    return np.random.default_rng(SEED).integers(1, config.vocab_size, 1024).astype(np.uint16)


def write_synth_data(root: Path, config: LLaMAConfig):
    """Packed train and val chunk files of `synth_sequence`, a structure the model can
    learn within a few steps."""
    seq = synth_sequence(config)
    T1 = config.block_size + 1
    for split, n_files, blocks in (("train", 2, 64), ("val", 1, 8)):
        (root / split).mkdir(parents=True)
        builder = PackedDatasetBuilder(str(root / split), "synth", T1 * blocks, 0,
                                       vocab_size=config.vocab_size)
        builder.add_array(np.resize(seq, n_files * T1 * blocks))
        builder.write_reminder()


def model_flops_per_token(config: LLaMAConfig, T: int) -> float:
    """Training flops per token without recompute: 6 per weight of every linear (the
    blocks' and the lm_head; the embedding is a gather) plus 6 * L * T * D for the
    attention products q k^T and p v over the causal half, forward and backward."""
    D, H, L = config.n_embd, config.n_hidden, config.n_layer
    linear = L * (D * 3 * D + D * D + 3 * D * H) + D * config.padded_vocab_size
    return 6.0 * linear + 6.0 * L * T * D


def _counts_zero():
    for fn in KERNELS.values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def plain_versions():
    """Every kernel wrapper that the model reaches replaced by its plain version."""
    stack = contextlib.ExitStack()
    for name, (_, ref, _) in QUANT_KERNELS.items():
        stack.enter_context(mock.patch(f"lit_llama_ja_tpu_torch.quant.linear.{name}", ref))
    stack.enter_context(mock.patch(
        "lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_fwd",
        flash_attention_fwd_ref))
    return stack


def _losses(out_dir: Path, key="train_loss"):
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    return {r["iter"]: r[key] for r in records if key in r}


def run_cli(log, **kw):
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        pretrain_cli.main(**{**TRAIN, "model_size": TRAIN_MODEL, **kw})


def profile_step(step, params, opt_state, batch, top=20):
    """One train step under `torch.profiler`: the device time of every kernel by
    name (the top ``top`` of them), their sum, the step's wall time and the share of
    it in which no kernel ran (one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(params, opt_state, batch)[2])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "n_kernel_names": len(kernels),
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in kernels[:top]]}


def loss_and_grads(params, micro, config, device):
    """Loss and gradients of one micro-batch with bf16 compute, as the train step
    computes them."""
    leaves = flatten_tree(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        logits = forward(cast_floating(params, torch.bfloat16), micro[:, :-1], config,
                         device=device)
        loss = cross_entropy_loss(logits, micro[:, 1:])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, grads))


def phase_train(device):
    config = LLaMAConfig.from_name(TRAIN_MODEL)
    assert llama_configs[TRAIN_MODEL] == dict(n_layer=12, n_head=10, n_embd=780,
                                              vocab_size=35000)
    L, T = config.n_layer, config.block_size
    accum = TRAIN["batch_size"] // TRAIN["micro_batch_size"]
    per_step = L * accum  # K2 and K6 launches in one optimizer step
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    write_synth_data(WORK_DIR / "data", config)
    data = dict(train_data_dir=str(WORK_DIR / "data" / "train"),
                val_data_dir=str(WORK_DIR / "data" / "val"))
    log = WORK_DIR / "cli.log"
    run_dir, resumed_dir = WORK_DIR / "run", WORK_DIR / "resumed"
    mid = TRAIN["save_interval"] - 1  # the iteration of the first save
    save_state = pretrain_cli.save_train_state

    def save_and_keep_mid(path, params, opt_state, config, meta):
        save_state(path, params, opt_state, config, meta)
        if meta["iter"] == mid:  # the resumed run starts from this one
            shutil.copytree(path, resumed_dir / "state-latest")

    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    with mock.patch.object(pretrain_cli, "save_train_state", save_and_keep_mid):
        run_cli(log, out_dir=str(run_dir), **data)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    n_steps, n_val = TRAIN["max_iters"], TRAIN["max_iters"] // TRAIN["eval_interval"]
    assert launches["flash_attention_bwd"] == n_steps * per_step, launches
    assert launches["flash_attention_fwd"] == (n_steps * per_step
                                               + n_val * TRAIN["eval_iters"] * L), launches
    losses = _losses(run_dir)
    val = _losses(run_dir, "val_loss")
    assert sorted(losses) == list(range(n_steps)) and len(val) == n_val, (losses, val)
    assert all(np.isfinite(x) for x in [*losses.values(), *val.values()])
    assert losses[n_steps - 1] < losses[0], losses

    run_cli(log, out_dir=str(resumed_dir), resume=str(resumed_dir / "state-latest"), **data)
    resumed = _losses(resumed_dir)
    assert sorted(resumed) == list(range(mid + 1, n_steps)), resumed
    resume_rel = max(abs(resumed[i] - losses[i]) / abs(losses[i]) for i in resumed)
    assert resume_rel <= RESUME_REL_TOL, (resumed, losses)

    # one optimizer step each without and with remat, timed, on fresh params
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, config, device=device)
    opt = make_adamw(1e-4)
    opt_state = opt.init(params)
    ds = pretrain_cli.create_dataset(data["train_data_dir"], [("synth", 1.0)], T + 1)
    it = iter(ds)
    batch = np.stack([np.stack([next(it) for _ in range(TRAIN["micro_batch_size"])])
                      for _ in range(accum)])
    steps = {}
    for remat in (False, True):
        step = make_train_step(config, opt, remat=remat, compute_dtype=torch.bfloat16,
                               device=device)
        step(params, opt_state, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _counts_zero()
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            _, _, loss = step(params, opt_state, batch)
            float(loss)
            times.append((time.perf_counter() - t1) * 1e3)
        counts = {k: v // 2 for k, v in _counts().items()}
        assert counts["flash_attention_bwd"] == per_step, counts
        assert counts["flash_attention_fwd"] == (2 if remat else 1) * per_step, counts
        steps[remat] = {"step_ms": min(times), "launches_per_step": counts,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if not remat:
            emit({"phase": "train_profile", "remat": False,
                  **profile_step(step, params, opt_state, batch)})

    # one micro-batch: the kernel path's loss and gradients against the plain versions
    micro = torch.as_tensor(batch[0], device=device)
    got_loss, got = loss_and_grads(params, micro, config, device)
    with mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_fwd",
                    flash_attention_fwd_ref), \
         mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_bwd",
                    flash_attention_bwd_ref):
        want_loss, want = loss_and_grads(params, micro, config, device)
    grad_rel = {k: ((got[k].float() - want[k].float()).norm() / want[k].float().norm()).item()
                for k in want}
    assert abs(got_loss - want_loss) <= GRAD_LOSS_TOL, (got_loss, want_loss)
    assert all(np.isfinite(r) and r <= GRAD_REL_TOL for r in grad_rel.values()), grad_rel

    tokens = accum * TRAIN["micro_batch_size"] * T
    flops = model_flops_per_token(config, T) * tokens
    step_s = steps[False]["step_ms"] / 1e3
    emit({"phase": "train", "config": TRAIN_MODEL, "n_layer": L, "n_embd": config.n_embd,
          "n_head": config.n_head, "T": T, "micro_batch": TRAIN["micro_batch_size"],
          "grad_accum": accum, "tokens_per_step": tokens, "compute_dtype": "bfloat16",
          "losses": [losses[i] for i in range(n_steps)], "val_losses": val,
          "resumed_losses": resumed, "resume_max_rel_diff": resume_rel,
          "cli_run_s": run_s, "launches": launches,
          "step_ms": steps[False]["step_ms"], "tokens_per_s": tokens / step_s,
          "model_tflops_per_s": flops / step_s / 1e12,
          "model_flop_share_of_989": flops / step_s / BF16_FLOPS_PER_S,
          "flop_formula": "6 * linear weights (blocks + lm_head) + 6 * L * T * D per token",
          "peak_mem_bytes": steps[False]["peak_mem_bytes"],
          "remat_step_ms": steps[True]["step_ms"],
          "remat_peak_mem_bytes": steps[True]["peak_mem_bytes"],
          "launches_per_step": steps[False]["launches_per_step"],
          "remat_launches_per_step": steps[True]["launches_per_step"],
          "grad_check": {"loss": got_loss, "plain_loss": want_loss,
                         "max_leaf_rel_err": max(grad_rel.values()), "leaf_rel_err": grad_rel}})
    return launches, run_dir / f"iter-{n_steps:06d}-ckpt"


def eval_tree(params, config, tokens, want, device):
    """Perplexity of a (quantized) 125M tree in bf16 activations through the kernels,
    with the launches of that run against ``want`` (per window), then the same with
    the plain versions of every kernel swapped in."""
    tree = cast_params(params, torch.bfloat16)
    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    ppl = perplexity(tree, config, tokens, device=device)
    eval_s = time.perf_counter() - t0
    launches = _counts()
    expect_launches(launches, {k: v * EVAL_WINDOWS for k, v in
                               {**want, "flash_attention_fwd": config.n_layer}.items()})
    with plain_versions():
        plain = perplexity(tree, config, tokens, device=device)
    assert np.isfinite(ppl) and abs(ppl - plain) <= PPL_REL_TOL * plain, (ppl, plain)
    return {"ppl": ppl, "plain_ppl": plain, "rel_diff": abs(ppl - plain) / plain,
            "eval_s": eval_s, "launches": {k: v for k, v in launches.items() if v}}


def phase_quant_eval(device, ckpt):
    """The 125M ja model from the train phase's last checkpoint: fp perplexity, GPTQ at
    four modes on calibration windows of the same data (save, then `load_model_any`),
    llm.int8 and llm.int8-dyn quantized at load, each perplexity through the kernels
    against the plain versions; then one decode-path perplexity with an int4 KV cache.
    Returns the kernel launches of the perplexity runs, summed."""
    config = LLaMAConfig.from_name(TRAIN_MODEL)
    L, T = config.n_layer, config.block_size
    seq = synth_sequence(config)
    tokens = np.resize(seq, EVAL_WINDOWS * T + 1).astype(np.int64)
    calib = np.resize(seq, CALIB_WINDOWS * T).reshape(CALIB_WINDOWS, T).astype(np.int64)
    fp, cfg = load_model_any(ckpt, device=device)
    assert cfg == config
    per_window = {"gptq.int4": {"quant_matmul_int4": 5 * L + 1},
                  "gptq.int3": {"quant_matmul_int3": 5 * L + 1},
                  "gptq.int2-g64": {"quant_matmul_int2": 5 * L + 1},
                  "gptq.mix": {"quant_matmul_int4": 2 * L + 1, "quant_matmul_int2": 3 * L},
                  "llm.int8": {"quant_matmul_int8": 5 * L + 1},
                  "llm.int8-dyn": {"quant_matmul_int8": 5 * L + 1}}
    results = {"fp": eval_tree(fp, config, tokens, {}, device)}
    total = {k: 0 for k in KERNELS}
    for mode in (*GPTQ_MODES, "llm.int8", "llm.int8-dyn"):
        t0 = time.perf_counter()
        if mode.startswith("gptq"):
            _, bits, gs = parse_quant_mode(mode)
            solves = []
            q = gptq_quantize_model(fp, config, calib, bits=bits, groupsize=gs, progress=False,
                                    solve_times=solves)
            save_checkpoint(WORK_DIR / mode, q, config)
            del q
            q, _ = load_model_any(WORK_DIR / mode, device=device)
        else:
            solves = None
            q, _ = load_model_any(ckpt, mode, device=device)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        res = eval_tree(q, config, tokens, per_window[mode], device)
        for k, v in res["launches"].items():
            total[k] += v
        res.update(quantize_s=quantize_s,
                   weight_bytes=sum(t.numel() * t.element_size() for t in _leaves(q)))
        if solves is not None:
            res["solve_s"] = sum(t for _, t in solves)
            res["solve_s_by_name"] = {n: sum(t for m, t in solves if m == n)
                                      for n in dict.fromkeys(m for m, _ in solves)}
        results[mode] = res
        if mode != "gptq.mix":
            del q
        else:
            mix = q
        torch.cuda.empty_cache()

    # teacher-forced through the cached decode path (M = 1: the GEMV kernels)
    tree = cast_params(mix, torch.bfloat16)
    kw = dict(quantize_kv="int4", windows=1, window=DECODE_WINDOW, device=device)
    _counts_zero()
    t0 = time.perf_counter()
    dppl = decode_path_perplexity(tree, config, tokens, **kw)
    decode_s = time.perf_counter() - t0
    dlaunches = _counts()
    expect_launches(dlaunches, {k: v * DECODE_WINDOW for k, v in
                                per_window["gptq.mix"].items()})
    for k, v in dlaunches.items():
        total[k] += v
    with plain_versions():
        dplain = decode_path_perplexity(tree, config, tokens, **kw)
    assert np.isfinite(dppl) and abs(dppl - dplain) <= PPL_REL_TOL * dplain, (dppl, dplain)
    emit({"phase": "quant_eval", "config": TRAIN_MODEL, "checkpoint": ckpt.name,
          "eval_tokens": EVAL_WINDOWS * T, "calib": [CALIB_WINDOWS, T], "results": results,
          "decode_path": {"format": "gptq.mix", "kv_cache": "int4", "window": DECODE_WINDOW,
                          "ppl": dppl, "plain_ppl": dplain, "seconds": decode_s,
                          "launches": {k: v for k, v in dlaunches.items() if v}}})
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def summary(k1_rows, k2_rows, k6_rows, q_rows, paths):
    """Per-forward or per-step sums: K1, K3, K4 and K5 over one 7B decode step of their
    format (161 launches at M = 1, whole-column scales; and over the prefill at
    M = 512), K2 over one 7B prefill, K6 over one 125M training step. ``paths`` holds
    the launch counts of each main-path run; a row's ``launches`` is its kernel's
    count on its own path (K1 and K2: the int4 generation, K3: llm.int8, K4:
    gptq.int2, K5: gptq.int3, K6: training)."""
    L = llama_configs["7B"]["n_layer"]
    per_layer = {(4096, 12288): 1, (4096, 4096): 1, (4096, 11008): 2, (11008, 4096): 1}
    weight = {(k, n): L * c for (k, n), c in per_layer.items()}
    weight[(4096, 32000)] = 1
    pre = [r for r in k2_rows if (r["n_head"], r["head_dim"], r["T"]) == (32, 128, 512)][0]
    step = [r for r in k6_rows if (r["B"], r["n_head"], r["head_dim"]) == (4, 10, 78)][0]
    n6 = llama_configs[TRAIN_MODEL]["n_layer"] * TRAIN["batch_size"] // TRAIN["micro_batch_size"]

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items() if c.get(kernel)}

    def step_sums(rows):
        """decode (M = 1) and prefill (M = 512) sums over the 161 linears of one step"""
        out = {}
        for M, prefix in ((1, ""), (512, "prefill_")):
            at = {(r["K"], r["N"]): r for r in rows if r["M"] == M}
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                out[prefix + key] = sum(c * at[s][key] for s, c in weight.items())
        return out

    def quant_row(name, rows, path, source, replaces, fmt):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": paths[path][name], "launches_by_path": by_path(name),
                "max_abs_err": max(r["max_abs_err"] for r in rows), **step_sums(rows),
                "bound_by": "bytes", "prefill_bound_by": "operations",
                "per": f"one 7B decode step of {fmt}: 161 launches at M=1 "
                       "(prefill_*: the 512-token prefill)"}

    k1 = [r for r in k1_rows if r["groups"] == 1]

    def q7b(name, gs, signed=False):
        return [r for r in q_rows if r["kernel"] == name and r["model"] == "7B"
                and r["groupsize"] == gs and r["signed"] == signed]

    return [
        quant_row("quant_matmul_int4", k1, "generate_int4",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_int4.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325", "int4, G=1"),
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "lit_llama_ja_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "lit_llama_ja_tpu/ops/pallas/flash_attention.py:78",
         "launches": paths["generate_int4"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"),
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": L * pre["ms"], "plain_ms": L * pre["plain_ms"], "bound_ms": L * pre["bound_ms"],
         "bound_by": pre["bound_by"], "library_ms": L * pre["library_ms"],
         "per": "one 7B prefill: 32 launches at n_head=32, T=512, head_dim=128"},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "lit_llama_ja_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "lit_llama_ja_tpu/ops/pallas/flash_attention.py:207",
         "launches": paths["train"]["flash_attention_bwd"],
         "launches_by_path": by_path("flash_attention_bwd"),
         "max_abs_err": max(r["max_abs_err"] for r in k6_rows),
         "ms": n6 * step["ms"], "plain_ms": n6 * step["plain_ms"],
         "bound_ms": n6 * step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": n6 * step["library_ms"],
         "per": f"one 125M training step: {n6} launches at B=4, n_head=10, T=2048, "
                "head_dim=78"},
        quant_row("quant_matmul_int8", q7b("quant_matmul_int8", -1, True), "generate_llm.int8",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_int8.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul.py:451",
                  "int8 (symmetric, whole-column)"),
        quant_row("quant_matmul_int2", q7b("quant_matmul_int2", -1), "generate_gptq.int2",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_sub4.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447", "int2, G=1"),
        quant_row("quant_matmul_int3", q7b("quant_matmul_int3", -1), "generate_gptq.int3",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_sub4.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:323", "int3, G=1"),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = phase_device()
    g = torch.Generator(device=device).manual_seed(SEED)
    timer = Timer(device)
    k1_rows = phase_k1(timer, g, device)
    k2_rows = phase_k2(timer, g, device)
    phase_edges(g, device)
    k6_rows = phase_k6(timer, g, device)
    # the int4 generation draws its weights where it always has, after K6's phase
    paths = {"generate_int4": phase_generate(g, device)}
    q_rows = phase_quant_kernels(timer, g, device)
    phase_quant_edges(g, device)
    del timer
    for fmt in GEN_FORMATS:
        paths[f"generate_{fmt}"] = phase_generate(g, device, fmt)
    paths["train"], ckpt = phase_train(device)
    paths["evaluate"] = phase_quant_eval(device, ckpt)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    emit({"kernels": summary(k1_rows, k2_rows, k6_rows, q_rows, paths)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
