"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --gemms-of TREE
    python3 chip_smoke.py --attention-of TREE

The second form runs only the device phase, the K1 and K3-K5 rows of phases 2 and 5
and the 7B int4 generation, with the package and kernels of the checkout TREE in
place of this one's, so that two checkouts (a parent and its change) can be timed in
turns by one measuring script. The third does the same for the attention kernels: the
device phase, the K2 rows of phase 3, the K6 rows of phase 4 with its repeat check, and
the 125M micro-batch and optimizer step of phase 7's `micro_step` line.

Phases, each printing one JSON line and each asserting (any failure ends the run
with a non-zero exit and no result line):

  1. device    the card's name and power limit; builds the CUDA kernels from
               ``lit_llama_ja_tpu_torch/csrc`` and prints the build seconds.
  2. kernels   K1, the int4 dequant-matmul, against its plain version at the LLaMA-7B
               shapes, M in {1, 512}, whole-column and 128-row-group scales, and at the
               125M shapes, M 2048; with the sums over one prefill's linears.
  3. kernels   K2, the causal flash-attention forward, against its plain version for
               (n_head, head_dim) in {(32, 128), (10, 78), (8, 64)}, T in {512, 777, 2048}.
     kernels   both kernels against their plain versions at ragged and strided shapes
               off the 7B path (one line each, correctness only); then the prefill
               GEMM's structured single-tile check through the int4 decoder.
  4. kernels   K6, the causal flash-attention backward, against its plain version for
               (n_head, head_dim) in {(10, 78), (8, 64), (32, 128)} at T 2048, and at
               the 125M training shape (batch 4, 10 x 78, T 2048), with q, k, v and dO
               in the layouts the model hands over, and two launches there that must
               give the same bits; then ragged and strided edges; then the structured
               check of K2 and K6 (`structured_attention`) at both block sizes.
  5. kernels   K3 (int8: symmetric whole-column, and uint8 in 128-row groups), K4 (int2:
               whole-column, and 64-row groups) and K5 (int3: whole-column) against their
               plain versions at the 7B shapes (M 1 and 512) and the 125M shapes (M 1 and
               2048), timed, with the prefill sums; then off those shapes (ragged M, N
               and scale groups, stored rows past K) and the structured single-tile
               check through each of their decoders, correctness only.
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
               flop share and peak memory; then `micro_step`: one micro-batch's forward
               and backward and one optimizer step on random tokens, timed.
  8. quant_eval the 125M model from the train phase's last checkpoint: perplexity on 4
               windows of 2048 tokens of the synthetic data, in fp; after GPTQ at
               gptq.int4, gptq.int3, gptq.int2-g64 and gptq.mix on 8 calibration windows
               (saved, then read back by `load_model_any`); and after llm.int8 and
               llm.int8-dyn quantization at load. Each perplexity through the kernels
               against the same with the plain versions swapped in (1e-2 relative), with
               its launch counts; then one decode-path perplexity (int4 KV cache, a
               256-token window) of the mix, kernels against plain versions.
  9. kernels   K7 and K8, the paged int8 decode attention and its pipelined form,
               against their plain version at the 7B heads (32 x 128) with B in
               {1, 8, 32}, page in {16, 128}, every slot at position 2047 or mixed
               positions, and at the 125M (10 x 78) and 19M (8 x 64) heads, timed beside
               their bound and SDPA on pre-gathered bf16 k/v; then edges (position 0,
               wide tables of trash entries, unaligned page runs, layer views).
 10. serve     LLaMA-7B int4 weights through `PagedEngine` over an int8 page pool
               (page 16, 8 slots, 1025 pages, prefill chunk 512): 16 greedy requests of
               64-1000 tokens, 4 over a registered 256-token prefix, 32 new tokens
               each; launch counts (K1 161 per forward, K2 32 per span from position 0,
               K7 32 per decode step), the prefix's pages alone held afterwards, the
               same tokens in a second run, and one decode step's logits through K7
               against its plain version; time to first token, decode step ms,
               tokens/s, K7 per step beside its bound, peak memory. Then 8 requests over
               the int4 pool (no K7) and 4 through the stripe `Engine` (int8 cache).
     spec      speculative serving: a 125M ja target (bf16 weights from the seed, int8
               pool, K7 at 10 x 78 in its decode) with a 19M ja draft; the target alone
               through `PagedEngine`, then `SpeculativePagedEngine` (K 4) and
               `TreeSpeculativePagedEngine` (tree 4,2,2) on 8 greedy requests:
               launch counts, acceptance, tokens/s, and the share of requests whose
               tokens equal the target-only engine's (printed, not gated).
 11. kernels   one line with every ported kernel, its launches on its path and by path,
               its time beside its bound, the plain version's time and the library
               call's time. Each time there is the sum over the kernel's launches in one
               forward or step of its path: K1, K3, K4 and K5 over the 161 linears of
               one 7B decode step of their format (M = 1; the prefill_* keys at
               M = 512), K2 over the 32 layers of the 7B prefill, K6 over the 384
               launches of one 125M training step, K7 and K8 over the 32 layers of one
               7B decode step at B = 8 with every slot at position 2047.
 12. the last line: {"ok": true, "device": {...}}.

Every phase line ends with the card's SM clock and temperature, read at its end.
Times are CUDA-event medians of 20 launches after 3 warm-up launches, with a 256 MB
buffer written between launches so that each one finds the L2 cache cold, as the
decode loop does. K2 and K6 rows also carry ``graph_ms``: the same median over
replays of the call captured in a CUDA graph, which leaves out the host time of the
wrapper where the 256 MB write does not hide it. Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM and
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

OTHER_TREE_MODES = ("--gemms-of", "--attention-of")
if sys.argv[1:2] and sys.argv[1] in OTHER_TREE_MODES:  # another checkout's package and kernels
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))

import numpy as np
import torch

from lit_llama_ja_tpu_torch.cli import pretrain_cli
from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_configs
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDatasetBuilder
from lit_llama_ja_tpu_torch.infer.evaluate import decode_path_perplexity, perplexity
from lit_llama_ja_tpu_torch.infer.generate import bucket_length, generate
from lit_llama_ja_tpu_torch.infer.paged import PagedEngine, paged_forward
from lit_llama_ja_tpu_torch.infer.serving import Engine
from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine
from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree, save_checkpoint
from lit_llama_ja_tpu_torch.models.llama import (
    cast_params,
    forward,
    forward_with_cache,
    init_kv_cache,
    init_params,
)
from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import flash_attention as flash_wrappers
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qmm_wrappers
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.paged_attention import (
    gather_pages,
    paged_decode_attention,
    paged_decode_attention_db,
    paged_decode_attention_ref,
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
from lit_llama_ja_tpu_torch.quant.linear import (
    dequantize_with_k,
    parse_quant_mode,
    sub4_pad_rows,
    unpack_levels,
)
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
# the shared GEMM's copy paths and group cases for int4 (K is always even): K < 64, an
# odd N (byte loads of the packed rows), groups of 32 (two in a 64-deep tile), the 125M
# shape with groups of 60 that split tiles, and N = 4096 at M = 512 (128-wide tiles,
# 128 blocks)
K1_GEMM_EDGES = [(40, 264, 1, (17, 130)), (200, 37, 1, (17, 33)), (1024, 264, 32, (17, 130)),
                 (780, 2340, 13, (17, 130)), (4096, 4096, 32, (512,))]
K2_EDGES = [(2, 3, 1, 64, False), (2, 3, 65, 96, False), (1, 4, 200, 40, False),
            (3, 2, 130, 128, True), (1, 10, 300, 78, True)]  # (B, nh, T, hd, strided)
K6_SHAPES = [(1, 10, 78), (1, 8, 64), (1, 32, 128), (4, 10, 78)]  # (B, n_head, hd), T 2048
K6_EDGES = [(3, 2, 1, 64, True), (1, 4, 65, 78, True), (3, 2, 777, 64, False),
            (1, 3, 777, 128, True), (2, 3, 130, 96, False)]  # (B, nh, T, hd, strided)
# the structured check of K2 and K6: (n_head, T, head_dim, strided, realigned); T 200
# keeps every expected value exact in bf16 and ends inside a 64-key tile; hd 78 views
# both as they are (4-byte copies) and realigned (16-byte copies, the short last chunk)
STRUCTURED_ATTENTION = [(2, 200, 64, False, False), (2, 200, 78, True, False),
                        (2, 200, 78, True, True), (2, 200, 128, False, False)]
MICRO_REPS = 5  # timed micro-batch forward + backward passes of the micro_step line
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
PAGED_KERNELS = {"paged_decode_attention": paged_decode_attention,
                 "paged_decode_attention_db": paged_decode_attention_db}
KERNELS = {**{n: k[0] for n, k in QUANT_KERNELS.items()},
           "flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
           **PAGED_KERNELS}
# K3-K5 cases (kernel, bits, groupsize, signed); signed: int8 levels, zeros 0
QUANT_CASES = [("quant_matmul_int8", 8, -1, True), ("quant_matmul_int8", 8, 128, False),
               ("quant_matmul_int2", 2, -1, False), ("quant_matmul_int2", 2, 64, False),
               ("quant_matmul_int3", 3, -1, False)]
Q125_SHAPES = [(780, 2340), (780, 780), (780, 2304), (2304, 780), (780, 35008)]
# launches of each (K, N) in one forward: 7B (161 linears) and 125M (61)
LINEARS_PER_FORWARD = {
    "7B": {(4096, 12288): 32, (4096, 4096): 32, (4096, 11008): 64, (11008, 4096): 32,
           (4096, 32000): 1},
    "125M": {(780, 2340): 12, (780, 780): 12, (780, 2304): 24, (2304, 780): 12, (780, 35008): 1},
}
PREFILL_M = {"7B": 512, "125M": 2048}
# the structured single-tile check: (kernel, bits, signed) of every GEMM decoder
STRUCTURED = [("quant_matmul_int4", 4, False), ("quant_matmul_int8", 8, True),
              ("quant_matmul_int8", 8, False), ("quant_matmul_int2", 2, False),
              ("quant_matmul_int3", 3, False)]
# (K, N, groupsize, Ms) off the model shapes; K3 at (780, 13 groups) reads its scale
# rows by the _expand_tiles rule, K4 and K5 store padded rows past K. The GEMM's copy
# paths: an odd K (2-byte x rows: plain loads), K < 64 (one partial k-tile), an odd N
# (byte loads of the packed rows), groupsize 32 (two groups a 64-deep tile), M = 17, and
# N = 4096 at M = 512 (128-wide tiles: 128 blocks)
QUANT_GEMM_EDGES = [(91, 264, -1, (17, 40)), (40, 264, -1, (17, 130)), (200, 37, -1, (17, 33))]
QUANT_EDGES = {
    "quant_matmul_int8": [(90, 36, -1, (3, 40)), (780, 2340, 64, (1, 17, 130)),
                          (1000, 264, 334, (5, 8)), (4096, 1000, 128, (2, 16)),
                          *QUANT_GEMM_EDGES, (4096, 4096, 128, (512,))],
    "quant_matmul_int2": [(780, 36, 64, (1, 3, 17, 130)), (100, 264, -1, (1, 5, 40)),
                          (2304, 780, 64, (1, 130)), (11008, 1000, -1, (1, 16, 17)),
                          *QUANT_GEMM_EDGES, (1024, 264, 32, (17, 130)),
                          (4096, 4096, 64, (512,))],
    "quant_matmul_int3": [(780, 36, 64, (1, 3, 17, 130)), (100, 264, -1, (1, 5, 40)),
                          (2304, 780, 64, (1, 130)), (11008, 1000, -1, (1, 16, 17)),
                          *QUANT_GEMM_EDGES, (1024, 264, 32, (17, 130)),
                          (4096, 4096, 64, (512,))],
}
GEN_FORMATS = ("llm.int8", "gptq.int2", "gptq.int3", "gptq.mix-a4m2h4-g64")
EVAL_WINDOWS = 4  # 2048-token windows of the 125M perplexity
CALIB_WINDOWS = 8  # 2048-token GPTQ calibration windows
GPTQ_MODES = ("gptq.int4", "gptq.int3", "gptq.int2-g64", "gptq.mix")
PPL_REL_TOL = 1e-2  # kernel vs plain perplexity (bf16 activations, f32 sums)
DECODE_WINDOW = 256  # tokens of the one decode-path perplexity window
# K7 / K8 at the 7B shape: (n_head, head_dim, B, page, fill); fill "full" puts every
# slot at position 2047, "mixed" draws positions from the seed with 0 and page edges
PAGED_SHAPES = [(32, 128, B, page, fill) for B in (1, 8, 32) for page in (16, 128)
                for fill in ("full", "mixed")]
PAGED_MODELS = [(10, 78, 8, 16, "mixed"), (8, 64, 8, 16, "mixed")]  # the 125M and 19M heads
# (B, n_head, head_dim, page, positions or None for mixed, extra table width, layer view)
PAGED_EDGES = [(4, 32, 128, 16, [0, 0, 0, 0], 0, False), (4, 32, 128, 16, None, 48, False),
               (3, 10, 78, 4, None, 5, False), (3, 10, 78, 3, None, 2, True),
               (5, 8, 64, 8, [0, 7, 8, 63, 300], 0, True), (2, 32, 128, 128, [127, 128], 3, True)]
MAX_POS = 2047
# the serve phase: serve_cli's paged defaults at max_batch 8 and 2048 tokens a slot
SERVE = dict(max_batch=8, n_pages=8 * 2048 // 16 + 1, page_size=16, max_pages_per_slot=2048 // 16,
             prefill_chunk=512)
SERVE_REQUESTS, SERVE_NEW, SERVE_PREFIX, SERVE_PREFIXED = 16, 32, 256, 4
SERVE_INT4_REQUESTS, STRIPE_REQUESTS = 8, 4
SPEC_TARGET, SPEC_DRAFT, SPEC_REQUESTS, SPEC_PROMPTS = "125M", "19M", 8, (64, 512)


def gpu_state():
    """The card's SM clock (MHz) and temperature (C) now, as `nvidia-smi` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    try:
        sm, temp = (float(x) for x in out[0].split(","))
    except (IndexError, ValueError):
        return {"sm_clock_mhz": None, "temp_c": None}
    return {"sm_clock_mhz": sm, "temp_c": temp}


def emit(obj) -> None:
    """One JSON line; a phase line carries the SM clock and temperature at its end."""
    if "phase" in obj:
        obj = {**obj, **gpu_state()}
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


def graph_ms(timer, fn) -> float:
    """``timer.ms`` of the replay of one call of ``fn`` captured in a CUDA graph: the
    device time of the call's kernels (the wrapper's copies included) without the host
    time of launching them, which the L2-evicting write does not always hide."""
    fn()  # builds, loads and allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timer.ms(graph.replay)


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


def forward_sums(rows):
    """Sums over one forward's linears at the prefill M (7B: 161 at M = 512; 125M: 61 at
    M = 2048) of the rows of `phase_k1` or `phase_quant_kernels`, one entry per kernel,
    scale case and model."""
    cases = {}
    for r in rows:
        model = r["model"]
        if r["M"] == PREFILL_M[model]:
            case = (r["kernel"], r["groupsize"], r["signed"], model)
            cases.setdefault(case, {})[(r["K"], r["N"])] = r
    out = []
    for (kernel, gs, signed, model), at in cases.items():
        counts = LINEARS_PER_FORWARD[model]
        if set(at) == set(counts):
            out.append({"kernel": kernel, "groupsize": gs, "signed": signed, "model": model,
                        "M": PREFILL_M[model], "linears": sum(counts.values()),
                        **{key: sum(c * at[sh][key] for sh, c in counts.items())
                           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}})
    return out


def structured_check(name, bits, signed, device):
    """One 64-deep k-tile of the GEMM (M 128, K 64, N = BN) at both tile widths, with
    data that makes a wrong operand layout readable: row m of x is one-hot at K-row
    k(m) (m for the first 64 rows, 127 - m for the second warpgroup's), and the weight,
    one scale group a K-row with scale 1 and zero = level - e, is exactly e = n + 1 in
    one run and k + 1 in the other. So y[m, n] names the weight column and K-row that
    the kernel read; any difference from the plain version fails, with up to eight
    (m, n) -> (K-row, column) read. Correctness only."""
    K, M = 64, 128
    fn, ref, _ = QUANT_KERNELS[name]
    g = torch.Generator(device=device).manual_seed(SEED)
    k_of = torch.cat([torch.arange(64), 127 - torch.arange(64, 128)]).to(device)
    x = torch.zeros((M, K), dtype=torch.bfloat16, device=device)
    x[torch.arange(M, device=device), k_of] = 1
    plan = qmm_wrappers.gemm_plan
    out = []
    for bn in (64, 128):
        N = bn
        if bits == 4:
            leaves = dict(zip(("qweight", "scales", "zeros"), synth_int4(g, K, N, 1, device)))
        else:
            leaves = synth_quant(g, bits, K, N, -1, device, signed)
        levels = unpack_levels(leaves, K)
        Kp = levels.shape[-2]
        rows = torch.arange(Kp, device=device, dtype=torch.float32)[:, None].expand(Kp, N)
        cols = torch.arange(N, device=device, dtype=torch.float32)[None, :].expand(Kp, N)
        got, want = [], []
        for enc in (cols + 1, rows + 1):
            args = quant_args(name, {**leaves, "scales": torch.ones((Kp, N), device=device),
                                     "zeros": levels - enc})
            with mock.patch.object(qmm_wrappers, "gemm_plan",
                                   lambda *a, bn=bn: (bn, *plan(*a)[1:])):
                got.append(fn(x, *args).float())
            want.append(ref(x, *args).float())
        torch.cuda.synchronize()
        bad = ((got[0] != want[0]) | (got[1] != want[1])).nonzero().tolist()
        examples = [{"m": m, "n": n, "want": [int(k_of[m]), n],
                     "read": [got[1][m, n].item() - 1, got[0][m, n].item() - 1]}
                    for m, n in bad[:8]]
        out.append({"bn": bn, "mismatches": len(bad), "examples": examples})
    emit({"phase": "kernels", "kernel": name, "bits": bits, "signed": signed, "structured": out})
    assert all(r["mismatches"] == 0 for r in out), (name, bits, signed, out)


def phase_k1(timer, g, device):
    """K1 at the 7B shapes (M 1 and 512, whole-column and 128-row groups), then at the
    125M shapes (M 2048, whole-column) from a generator of its own, so that the phases
    after this one draw what they drew before these rows were added."""
    rows = []
    g125 = torch.Generator(device=device).manual_seed(SEED + 1)
    cases = [("7B", K, N, groups, (1, 512), g) for K, N in K1_SHAPES for groups in (1, K // 128)]
    cases += [("125M", K, N, 1, (2048,), g125) for K, N in Q125_SHAPES]
    for model, K, N, groups, Ms, gen in cases:
        qweight, scales, zeros = synth_int4(gen, K, N, groups, device)
        w = dequantize_with_k({"qweight": qweight, "scales": scales, "zeros": zeros},
                              K, dtype=torch.bfloat16)
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
            err, tol = check_k1(x, qweight, scales, zeros, (K, N, groups, M))
            n_bytes = qweight.numel() + 8 * groups * N + 2 * M * K + 2 * M * N
            b, by = bound_ms(n_bytes, 2.0 * M * K * N)
            row = {"kernel": "quant_matmul_int4", "groupsize": -1 if groups == 1 else 128,
                   "signed": False, "model": model, "K": K, "N": N, "groups": groups, "M": M,
                   "max_abs_err": err, "tol": tol,
                   "ms": timer.ms(lambda: quant_matmul_int4(x, qweight, scales, zeros)),
                   "plain_ms": timer.ms(lambda: quant_matmul_int4_ref(x, qweight, scales, zeros)),
                   "library_ms": timer.ms(lambda: torch.matmul(x, w)),
                   "bound_ms": b, "bound_by": by}
            emit({"phase": "kernels", **row})
            rows.append(row)
        del w
    emit({"phase": "kernels", "kernel": "quant_matmul_int4", "prefill_sums": forward_sums(rows)})
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
                   "graph_ms": graph_ms(timer, lambda: flash_attention_fwd(q, k, v)),
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
    g_gemm = torch.Generator(device=device).manual_seed(SEED + 2)  # leaves g's draws as they were
    for K, N, G, Ms in K1_GEMM_EDGES:
        qweight, scales, zeros = synth_int4(g_gemm, K, N, G, device)
        for M in Ms:
            x = torch.randn((M, K), generator=g_gemm, device=device).to(torch.bfloat16)
            err, tol = check_k1(x, qweight, scales, zeros, (K, N, G, M))
            k1.append({"K": K, "N": N, "groups": G, "M": M, "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "kernel": "quant_matmul_int4", "edges": k1})
    structured_check(*STRUCTURED[0], device)
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
               "graph_ms": graph_ms(timer, lambda: flash_attention_bwd(q, k, v, o, lse, do)),
               "plain_ms": timer.ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do)),
               "library_ms": timer.ms(
                   lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)),
               "fwd_ms": timer.ms(lambda: flash_attention_fwd(q, k, v)),
               "fwd_graph_ms": graph_ms(timer, lambda: flash_attention_fwd(q, k, v)),
               "fwd_plain_ms": timer.ms(lambda: flash_attention_fwd_ref(q, k, v)),
               "fwd_library_ms": timer.ms(lambda: sdpa(q, k, v, is_causal=True)),
               "fwd_bound_ms": fb, "fwd_bound_by": fby,
               "bound_ms": b, "bound_by": by}
        del out, leaves
        if (B, nh, hd) == (4, 10, 78):  # the training shape: two launches, the same bits
            again = flash_attention_bwd(q, k, v, o, lse, do)
            first = flash_attention_bwd(q, k, v, o, lse, do)
            row["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(first, again))
            assert row["repeat_bitwise"], "K6 gave different bits on the same inputs"
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


def _mismatches(got, want, names):
    """Count and up to eight examples of the elements where got != want exactly;
    ``names`` turns a (head, row, column) index into what the element encodes."""
    bad = (got.float() != want.float()).nonzero().tolist()
    return {"mismatches": len(bad),
            "examples": [{**names(*ix), "want": want[tuple(ix)].item(),
                          "got": got[tuple(ix)].item()} for ix in bad[:8]]}


def structured_attention(device):
    """K2 and K6 on data that makes a wrong operand layout readable, at both block sizes
    (64 and 128 rows), head dims 64, 78 (the model's strided views, copied as they are
    and realigned) and 128, T 200.
    q = 0 makes every visible score 0, so each row's probabilities are exactly 1 over
    its visible keys:

    * K2: with v[key, c] = c + 1, o[row, c] = c + 1 (a wrong column of v's .trans load
      reads as another number); with v[key, c] = key + 1, o[row, c] = (row + 2) / 2,
      the mean of 1 .. row + 1 (a wrong key reads as another mean).
    * K6, given lse = 0 (so p = 1 on the visible keys): with dO[r, c] = [r % hd == c],
      dv[key, c] counts the rows r >= key with r % hd == c (dO's .trans load in dv); with
      dO[r, 0] = v[key, 0] = 1, o = 0 (so ds = scale) and k[key, c] = [key % hd == c],
      dq[row, c] = bf16(scale) times the keys <= row with key % hd == c (k's .trans load
      in dq); dk = ds^T q = 0 in both.

    Every expected value is exact in bf16, so any difference fails. Correctness only."""
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    plan = flash_wrappers.flash_plan
    results = []
    for nh, T, hd, strided, realigned in STRUCTURED_ATTENTION:
        B = 1
        rows = torch.arange(T, device=device)
        cols = torch.arange(hd, device=device)
        ind = (rows[:, None] % hd == cols[None, :]).float()  # (T, hd): [r % hd == c]
        for block in (64, 128):
            q, k, v, do = attention_inputs(g, device, B, nh, T, hd, strided)
            q.zero_()
            o = torch.zeros((B, nh, T, hd), dtype=torch.bfloat16, device=device)
            zero_lse = torch.zeros((B, nh, T), device=device)
            res = {"n_head": nh, "T": T, "head_dim": hd, "strided": strided,
                   "realigned": realigned, "rows": block}
            with mock.patch.object(flash_wrappers, "flash_plan",
                                   lambda *a, r=block, **kw: plan(*a, **kw)._replace(rows=r)), \
                 mock.patch.object(flash_wrappers, "REALIGN_MIN_ROWS",
                                   0 if realigned else flash_wrappers.REALIGN_MIN_ROWS):
                v.copy_((cols + 1).float().expand(B, nh, T, hd))
                got_c = flash_attention_fwd(q, k, v)[0][0]
                v.copy_((rows + 1).float()[:, None].expand(B, nh, T, hd))
                got_k = flash_attention_fwd(q, k, v)[0][0]
                v.zero_()
                do.copy_(ind.expand(B, nh, T, hd))
                _, dk1, dv1 = flash_attention_bwd(q, k, v, o, zero_lse, do)
                do.zero_()
                do[..., 0] = 1
                v.zero_()
                v[..., 0] = 1
                k.copy_(ind.expand(B, nh, T, hd))
                dq2, dk2, _ = flash_attention_bwd(q, k, v, o, zero_lse, do)
            torch.cuda.synchronize()
            want_c = (cols + 1).float().expand(nh, T, hd)
            want_k = ((rows + 2) / 2).float()[:, None].expand(nh, T, hd)
            want_dv = ind.flip(0).cumsum(0).flip(0).expand(nh, T, hd)
            scale = torch.tensor(1 / math.sqrt(hd)).to(torch.bfloat16).float()
            want_dq = (ind.cumsum(0) * scale).to(torch.bfloat16).expand(nh, T, hd)

            def at_row(h, r, c):
                return {"head": h, "row": r, "col": c}

            res["fwd_columns"] = _mismatches(got_c, want_c, at_row)
            res["fwd_keys"] = _mismatches(got_k, want_k, at_row)
            res["dv"] = _mismatches(dv1[0], want_dv,
                                    lambda h, r, c: {"head": h, "key": r, "col": c})
            res["dq"] = _mismatches(dq2[0], want_dq, at_row)
            res["dk_zero"] = bool((dk1 == 0).all() and (dk2 == 0).all())
            results.append(res)
    emit({"phase": "kernels", "kernel": "flash_attention", "structured": results})
    for res in results:
        assert res["dk_zero"] and all(res[key]["mismatches"] == 0 for key in
                                      ("fwd_columns", "fwd_keys", "dv", "dq")), res


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
    emit({"phase": "kernels", "prefill_sums": forward_sums(rows)})
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
    for name, bits, signed in STRUCTURED[1:]:
        structured_check(name, bits, signed, device)


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


def mixed_positions(B: int, page: int):
    """Positions from the seed in [0, 2047], with 0 and the page edges page - 1, page
    and 2047 where the batch has room for them."""
    pos = np.random.default_rng(SEED + 31 * B + page).integers(0, MAX_POS + 1, B)
    if B > 1:
        n = min(B, 4)
        pos[:n] = [0, page - 1, page, MAX_POS][:n]
    return [int(p) for p in pos]


def paged_inputs(g, device, B, nh, hd, page, pos, extra=0, layered=False):
    """K7/K8 arguments: random int8 pages and scales around 0.01, a bf16 q, and per-slot
    tables of shuffled pages that hold each slot's visible tokens (``pos[b] // page + 1``
    pages), padded with ``extra`` trash entries past the widest slot. The trash page
    holds finite junk (scales of 1e4) that a kernel must never weigh. ``layered``: the
    pages are layer 1 of a stacked 3-layer pool, a view at an offset."""
    need = [p // page + 1 for p in pos]
    AP, P = max(need) + extra, 1 + sum(need)
    lead = (3,) if layered else ()

    def levels():
        return torch.randint(-127, 128, (*lead, P, nh, page, hd), generator=g,
                             device=device).to(torch.int8)

    def scales():
        t = torch.rand((*lead, P, nh, page), generator=g, device=device) * 0.01 + 0.005
        t[..., 0, :, :] = 1e4  # the trash page
        return t

    k, ks, v, vs = levels(), scales(), levels(), scales()
    if layered:
        k, ks, v, vs = k[1], ks[1], v[1], vs[1]
    perm = (torch.randperm(P - 1, generator=g, device=device) + 1).cpu()
    tables = torch.zeros((B, AP), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at: at + n]
        at += n
    q = torch.randn((B, nh, hd), generator=g, device=device).to(torch.bfloat16)
    return (q, k, ks, v, vs, tables.to(device), torch.tensor(pos, dtype=torch.int32, device=device))


def paged_bound(args):
    """(bound_ms, bound_by) of one K7/K8 call: each visible token's k, v and scales
    read once (2 * hd + 8 bytes per head), q, tables and pos read, o written."""
    q, tables, pos = args[0], args[5], args[6]
    B, nh, hd = q.shape
    page = args[1].shape[2]
    n_tok = (pos.long() + 1).clamp(max=tables.shape[1] * page).sum().item()
    n_bytes = n_tok * nh * (2 * hd + 8) + 2 * 2 * B * nh * hd + 4 * tables.numel() + 4 * B
    return bound_ms(n_bytes, 4.0 * hd * nh * n_tok)


def check_paged(fn, args, want, case):
    """K7 or K8 against the plain version's ``want`` on the same inputs: (err, tol)."""
    got = fn(*args).float()
    torch.cuda.synchronize()
    err = (got - want.float()).abs().max().item()
    tol = REL_TOL * want.float().abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (fn.__name__, case, err, tol)
    return err, tol


def paged_library(args):
    """The yardstick's inputs: the slots' keys and values gathered and dequantized to
    bf16 beforehand, with the visibility mask, for `scaled_dot_product_attention`."""
    q, k, ks, v, vs, tables, pos = args
    kd = (gather_pages(k, tables).float() * gather_pages(ks, tables)[..., None]).bfloat16()
    vd = (gather_pages(v, tables).float() * gather_pages(vs, tables)[..., None]).bfloat16()
    S = kd.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] <= pos[:, None].long())[:, None, None]
    return q[:, :, None], kd, vd, mask


def phase_paged_kernels(timer, g, device):
    """K7 and K8 against their plain version at the 7B shape (B 1, 8 and 32; page 16 and
    128; every slot at 2047, or mixed positions) and at the 125M and 19M heads, timed
    beside their bound, the plain version and SDPA on pre-gathered bf16 k/v."""
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for nh, hd, B, page, fill in PAGED_SHAPES + PAGED_MODELS:
        pos = [MAX_POS] * B if fill == "full" else mixed_positions(B, page)
        args = paged_inputs(g, device, B, nh, hd, page, pos)
        want = paged_decode_attention_ref(*args)
        b, by = paged_bound(args)
        lib = paged_library(args)
        common = {"n_head": nh, "head_dim": hd, "B": B, "page": page, "fill": fill,
                  "AP": args[5].shape[1], "positions": pos if B <= 8 else "mixed",
                  "plain_ms": timer.ms(lambda: paged_decode_attention_ref(*args)),
                  "library_ms": timer.ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
                  "bound_ms": b, "bound_by": by}
        for name, fn in PAGED_KERNELS.items():
            err, tol = check_paged(fn, args, want, (nh, hd, B, page, fill))
            row = {"kernel": name, **common, "max_abs_err": err, "tol": tol,
                   "ms": timer.ms(lambda: fn(*args))}
            emit({"phase": "kernels", **row})
            rows.append(row)
        del args, want, lib
    torch.cuda.empty_cache()
    return rows


def phase_paged_edges(g, device):
    """K7 and K8 off the timed shapes: every slot at position 0, tables far wider than
    the visible pages with trash entries, pages whose runs are not 16-byte aligned
    (page 4 and page 3 at hd 78), layer views at an offset, page 128. Correctness."""
    out = []
    for B, nh, hd, page, pos, extra, layered in PAGED_EDGES:
        pos = pos or mixed_positions(B, page)
        args = paged_inputs(g, device, B, nh, hd, page, pos, extra, layered)
        want = paged_decode_attention_ref(*args)
        for name, fn in PAGED_KERNELS.items():
            err, tol = check_paged(fn, args, want, (B, nh, hd, page, pos, extra, layered))
            out.append({"kernel": name, "B": B, "n_head": nh, "head_dim": hd, "page": page,
                        "positions": pos, "AP": args[5].shape[1], "layer_view": layered,
                        "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "kernel": "paged_decode_attention(_db)", "edges": out})


def serve_mix(config):
    """The serve phase's requests from the seed: prompt lengths in 64-1000, and a
    256-token prefix that the last SERVE_PREFIXED requests continue."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(64, 1001, SERVE_REQUESTS)
    prompts = [rng.integers(1, config.vocab_size, n).astype(np.int32) for n in lengths]
    return rng.integers(1, config.vocab_size, SERVE_PREFIX).astype(np.int32), prompts


def drive(engine, prompts, prefix=None, n_prefixed=0, on_step=None):
    """Register the prefix, submit every request at once, step the engine until all are
    done. Returns (tokens by request, start positions of the prefill spans, per-step
    (ms, ran a prefill span), first-token seconds by request, wall seconds)."""
    spans = []
    if isinstance(engine, PagedEngine):
        orig = engine._prefill_span

        def counted(toks, start_pos, table_pages, want_logits=True):
            spans.append(int(start_pos))
            return orig(toks, start_pos, table_pages, want_logits)

        engine._prefill_span = counted
    pid = engine.register_prefix(prefix) if prefix is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = []
    for i, p in enumerate(prompts):
        kw = {"prefix_id": pid} if pid is not None and i >= len(prompts) - n_prefixed else {}
        engine.add_request(p, SERVE_NEW, **kw)
        reqs.append(engine.queue[-1])
    first, steps = {}, []
    while not all(r.done for r in reqs):
        n_spans, n_queued, ts = len(spans), len(engine.queue), time.perf_counter()
        engine.step()
        now = time.perf_counter()
        steps.append(((now - ts) * 1e3, len(spans) > n_spans or len(engine.queue) < n_queued))
        for r in reqs:
            if r.tokens and r.req_id not in first:
                first[r.req_id] = now - t0
        if on_step is not None:
            on_step(engine)
    wall = time.perf_counter() - t0
    if isinstance(engine, PagedEngine):
        del engine._prefill_span  # the bound method again
    return {r.req_id: list(r.tokens) for r in reqs}, spans, steps, first, wall


def counted_drive(engine, prompts, **kw):
    """`drive` with every kernel's launch count set to 0 just before it; returns its
    result and the counts read just after."""
    torch.cuda.synchronize()
    _counts_zero()
    res = drive(engine, prompts, **kw)
    torch.cuda.synchronize()
    return res, _counts()


def serve_stats(tokens, steps, first, wall):
    ttft = sorted(first.values())
    decode = [ms for ms, prefilled in steps if not prefilled]
    n_tok = sum(len(t) for t in tokens.values())
    return {"ttft_s_median": float(np.median(ttft)), "ttft_s_p90": float(np.percentile(ttft, 90)),
            "decode_step_ms_median": float(np.median(decode)) if decode else None,
            "decode_steps_timed": len(decode), "steps": len(steps), "wall_s": wall,
            "tokens_out": n_tok, "tokens_per_s": n_tok / wall}


def check_tokens(tokens, config):
    for t in tokens.values():
        assert len(t) == SERVE_NEW, len(t)
        assert all(0 <= x < config.padded_vocab_size for x in t)


def decode_step_gate(engine, timer, device, out):
    """At the first step where every slot decodes: the next decode step's logits
    through K7 against the same step with K7's plain version swapped in (each on its
    own copy of the pool), and K7's time in that step (one launch on layer 0 at this
    step's tables and positions, times the layers) beside its bound."""
    if out or len(engine._decoding()) < engine.B or engine.prefilling:
        return
    engine._ensure_capacity()  # the pages the next step would allocate first
    pos = engine.pos.copy()
    ap = min(bucket_length(int(pos.max()) // engine.page + 1, minimum=1), engine.maxP)
    tables = np.ascontiguousarray(engine.tables[:, :ap])

    def step_logits():
        pool = {k: v.clone() for k, v in engine.pool.items()}
        logits = paged_forward(engine.params, engine.cur[:, None], pos[:, None], tables, pool,
                               engine.config, engine.quantized, device=device)[0].float()
        return logits, pool

    got, pool = step_logits()
    with mock.patch("lit_llama_ja_tpu_torch.infer.paged.paged_decode_attention",
                    paged_decode_attention_ref):
        want, _ = step_logits()
    assert torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    cfg = engine.config
    q = torch.randn((engine.B, cfg.n_head, cfg.head_dim), device=device).to(torch.bfloat16)
    args = (q, pool["k"][0], pool["k_scale"][0], pool["v"][0], pool["v_scale"][0],
            torch.as_tensor(tables, device=device), torch.as_tensor(pos, device=device))
    b, _ = paged_bound(args)
    out.update(logits_rel_err=rel, argmax_agree=agree, positions=pos.tolist(), AP=ap,
               k7_ms_per_step=cfg.n_layer * timer.ms(lambda: paged_decode_attention(*args)),
               k7_bound_ms_per_step=cfg.n_layer * b)
    del pool


def phase_serve(g, device):
    """LLaMA-7B int4 weights through `PagedEngine` over an int8 page pool at serve_cli's
    defaults (page 16, max_batch 8, 1025 pages, prefill chunk 512): 16 greedy
    requests of 64-1000 tokens, 4 of them over a registered 256-token prefix, 32 new
    tokens each, twice. Then 8 of them over the CLI's default int4 pool (plain decode
    attention) and 4 through the stripe `Engine` with an int8 cache."""
    config = LLaMAConfig.from_name("7B")
    L, per_forward = config.n_layer, launches_per_forward("int4", config.n_layer)
    params = synth_7b_params(config, g, device, "int4")
    prefix, prompts = serve_mix(config)
    timer = Timer(device)
    paths = {}
    # warm-up: allocator, rope tables, the sampling path
    drive(PagedEngine(params, config, quantize_kv="int8", device=device, **SERVE), prompts[:1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **SERVE)
    (tokens, spans, steps, first, wall), launches = counted_drive(
        engine, prompts, prefix=prefix, n_prefixed=SERVE_PREFIXED)
    peak = torch.cuda.max_memory_allocated()
    stats = engine.stats()
    n_decode, n_from0 = stats["steps"], sum(s == 0 for s in spans)
    expect_launches(launches, {**{k: v * (n_decode + len(spans)) for k, v in per_forward.items()},
                               "flash_attention_fwd": L * n_from0,
                               "paged_decode_attention": L * n_decode})
    check_tokens(tokens, config)
    assert stats["completed_requests"] == SERVE_REQUESTS and stats["queued"] == 0, stats
    assert stats["pages_used"] == SERVE_PREFIX // SERVE["page_size"], stats
    paths["serve_int8"] = launches
    del engine
    torch.cuda.empty_cache()

    gate = {}
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **SERVE)
    tokens_b = drive(engine, prompts, prefix=prefix, n_prefixed=SERVE_PREFIXED,
                     on_step=lambda e: decode_step_gate(e, timer, device, gate))[0]
    assert tokens_b == tokens, "greedy serving is not repeatable"
    assert gate, "no step with every slot decoding"
    del engine
    torch.cuda.empty_cache()
    emit({"phase": "serve", "config": "7B", "weights": "int4, G=1", "kv_pool": "int8",
          **SERVE, "requests": SERVE_REQUESTS, "prompt_lengths": [len(p) for p in prompts],
          "prefix": SERVE_PREFIX, "prefixed_requests": SERVE_PREFIXED, "new_tokens": SERVE_NEW,
          **serve_stats(tokens, steps, first, wall), "decode_steps": n_decode,
          "prefill_spans": len(spans), "prefill_spans_from_0": int(n_from0),
          "preempts": stats["preempts"], "pages_used_after": stats["pages_used"],
          "peak_mem_bytes": peak, "launches": {k: v for k, v in launches.items() if v},
          "repeatable": True, "decode_step_gate": gate,
          "tokens_head": {rid: t[:8] for rid, t in tokens.items()}})

    engine = PagedEngine(params, config, quantize_kv="int4", device=device, **SERVE)
    (tokens, spans, steps, first, wall), launches = counted_drive(
        engine, prompts[:SERVE_INT4_REQUESTS])
    n_decode, n_from0 = engine.stats()["steps"], sum(s == 0 for s in spans)
    expect_launches(launches, {**{k: v * (n_decode + len(spans)) for k, v in per_forward.items()},
                               "flash_attention_fwd": L * n_from0})
    check_tokens(tokens, config)
    paths["serve_int4"] = launches
    emit({"phase": "serve_int4_pool", "config": "7B", "kv_pool": "int4",
          "requests": SERVE_INT4_REQUESTS, **serve_stats(tokens, steps, first, wall),
          "decode_steps": n_decode, "prefill_spans": len(spans),
          "launches": {k: v for k, v in launches.items() if v}})
    del engine
    torch.cuda.empty_cache()

    engine = Engine(params, config, max_batch=SERVE["max_batch"], max_seq_length=2048,
                    quantize_kv="int8", device=device)
    (tokens, _, steps, first, wall), launches = counted_drive(engine, prompts[:STRIPE_REQUESTS])
    n_decode = engine.stats()["steps"]
    expect_launches(launches, {**{k: v * (n_decode + STRIPE_REQUESTS)
                                  for k, v in per_forward.items()},
                               "flash_attention_fwd": L * STRIPE_REQUESTS})
    check_tokens(tokens, config)
    paths["serve_stripe"] = launches
    emit({"phase": "serve_stripe", "config": "7B", "kv_cache": "int8 stripes (8 x 2048)",
          "requests": STRIPE_REQUESTS, **serve_stats(tokens, steps, first, wall),
          "decode_steps": n_decode, "launches": {k: v for k, v in launches.items() if v}})
    del engine, params, timer
    torch.cuda.empty_cache()
    return paths, gate


def phase_spec(g, device):
    """Speculative serving: the 125M ja model as the target and the 19M ja model as
    the draft (both vocab 35,000), bf16 weights drawn from ``g``, an int8 target pool
    at the serve phase's page settings. First the target alone through `PagedEngine`
    (its decode runs K7 at 10 heads of 78), then `SpeculativePagedEngine` (K = 4) and
    `TreeSpeculativePagedEngine` (tree 4,2,2) on the same 8 greedy requests of
    64-512 tokens, 32 new tokens each: launch counts, acceptance, tokens/s, and the
    share of requests whose tokens equal the target-only engine's. That share has no
    gate: with random bf16 weights the logits hold near-ties that the verify forward
    (K + 1 or 29 tokens wide) and the one-token decode may break differently."""
    tcfg, dcfg = LLaMAConfig.from_name(SPEC_TARGET), LLaMAConfig.from_name(SPEC_DRAFT)
    assert tcfg.vocab_size == dcfg.vocab_size == 35000
    tparams = init_params(g, tcfg, dtype=torch.bfloat16, device=device)
    dparams = init_params(g, dcfg, dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(SPEC_PROMPTS[0], SPEC_PROMPTS[1] + 1, SPEC_REQUESTS)]
    kw = dict(SERVE, quantize_kv="int8", device=device)
    paths = {}

    engine = PagedEngine(tparams, tcfg, **kw)
    drive(engine, prompts[:1])  # warm-up
    engine = PagedEngine(tparams, tcfg, **kw)
    (plain, spans, steps, first, wall), launches = counted_drive(engine, prompts)
    n_decode, n_from0 = engine.stats()["steps"], sum(s == 0 for s in spans)
    L = tcfg.n_layer
    expect_launches(launches, {"flash_attention_fwd": L * n_from0,
                               "paged_decode_attention": L * n_decode})
    check_tokens(plain, tcfg)
    paths["spec_target_only"] = launches
    emit({"phase": "spec", "engine": "PagedEngine", "target": SPEC_TARGET,
          "kv_pool": "int8", "requests": SPEC_REQUESTS, **serve_stats(plain, steps, first, wall),
          "decode_steps": n_decode, "launches": {k: v for k, v in launches.items() if v}})

    for name, cls, extra in (("SpeculativePagedEngine", SpeculativePagedEngine, {"draft_k": 4}),
                             ("TreeSpeculativePagedEngine", TreeSpeculativePagedEngine,
                              {"tree": (4, 2, 2)})):
        engine = cls(tparams, tcfg, draft_params=dparams, draft_config=dcfg, **kw, **extra)
        drive(engine, prompts[:1])  # warm-up
        engine = cls(tparams, tcfg, draft_params=dparams, draft_config=dcfg, **kw, **extra)
        (tokens, spans, steps, first, wall), launches = counted_drive(engine, prompts)
        n_from0 = sum(s == 0 for s in spans)
        # the verify forward is K + 1 (or 29) tokens wide and the draft's pool is bf16,
        # so neither reaches K7; K2 runs in the target's prefill spans from position 0
        expect_launches(launches, {"flash_attention_fwd": L * n_from0})
        check_tokens(tokens, tcfg)
        stats = engine.stats()
        same = sum(tokens[r] == plain[r] for r in plain) / len(plain)
        paths[f"spec_{name}"] = launches
        emit({"phase": "spec", "engine": name, "target": SPEC_TARGET, "draft": SPEC_DRAFT,
              **{k: list(v) if isinstance(v, tuple) else v for k, v in extra.items()},
              "kv_pool": "int8", "requests": SPEC_REQUESTS,
              **serve_stats(tokens, steps, first, wall), "rounds": stats["spec_rounds"],
              "acceptance_rate": stats["acceptance_rate"],
              "tokens_per_round": stats["tokens_per_round"],
              "share_equal_to_target_only": same,
              "launches": {k: v for k, v in launches.items() if v}})
        del engine
    del tparams, dparams
    torch.cuda.empty_cache()
    return paths


def phase_micro_step(device):
    """The 125M model at full width and depth on random tokens from the seed: one
    micro-batch's loss and gradients (forward and backward through K2 and K6, bf16
    compute, as the train step runs them), median of MICRO_REPS after a warm-up, and one
    optimizer step over the CLI's 32 micro-batches (best of two after a warm-up). Host
    clock around work that ends in a synchronize; the K2 and K6 launches are counted."""
    config = LLaMAConfig.from_name(TRAIN_MODEL)
    T, mb = config.block_size, TRAIN["micro_batch_size"]
    accum = TRAIN["batch_size"] // mb
    rng = np.random.default_rng(SEED)
    batch = rng.integers(0, config.vocab_size, (accum, mb, T + 1), dtype=np.int64)
    params = init_params(torch.Generator().manual_seed(SEED), config, device=device)
    micro = torch.as_tensor(batch[0], device=device)
    loss_and_grads(params, micro, config, device)  # warm-up
    _counts_zero()
    times = []
    for _ in range(MICRO_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_and_grads(params, micro, config, device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    micro_counts = {k: v // MICRO_REPS for k, v in _counts().items() if v}
    opt = make_adamw(1e-4)
    opt_state = opt.init(params)
    step = make_train_step(config, opt, compute_dtype=torch.bfloat16, device=device)
    step(params, opt_state, batch)  # warm-up
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(params, opt_state, batch)[2])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    assert np.isfinite(loss), loss
    emit({"phase": "micro_step", "config": TRAIN_MODEL, "micro_batch": mb, "T": T,
          "loss": loss, "micro_fwd_bwd_ms": statistics.median(times),
          "micro_fwd_bwd_ms_all": times, "launches_per_micro": micro_counts,
          "grad_accum": accum, "step_ms": min(step_ms), "step_ms_all": step_ms})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def summary(k1_rows, k2_rows, k6_rows, q_rows, paged_rows, gate, paths):
    """Per-forward or per-step sums: K1, K3, K4 and K5 over one 7B decode step of their
    format (161 launches at M = 1, whole-column scales; and over the prefill at
    M = 512), K2 over one 7B prefill, K6 over one 125M training step. ``paths`` holds
    the launch counts of each main-path run; a row's ``launches`` is its kernel's
    count on its own path (K1 and K2: the int4 generation, K3: llm.int8, K4:
    gptq.int2, K5: gptq.int3, K6: training, K7 and K8: the int8-pool serve run, which
    runs K7 and, as in the JAX package, never K8). K7 and K8 are summed over the 32
    layers of one 7B decode step at B = 8 with every slot at position 2047, page 16;
    K7 also carries its time in one step of the serve run (``serve_*``)."""
    L = llama_configs["7B"]["n_layer"]
    weight = LINEARS_PER_FORWARD["7B"]
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

    k1 = [r for r in k1_rows if r["groups"] == 1 and r["model"] == "7B"]

    def q7b(name, gs, signed=False):
        return [r for r in q_rows if r["kernel"] == name and r["model"] == "7B"
                and r["groupsize"] == gs and r["signed"] == signed]

    def paged_row(name, replaces):
        rows = [r for r in paged_rows if r["kernel"] == name]
        at = [r for r in rows if (r["n_head"], r["B"], r["page"], r["fill"]) == (32, 8, 16, "full")][0]
        row = {"name": name, "route": "cuda",
               "source": "lit_llama_ja_tpu_torch/csrc/paged_attention.cu", "replaces": replaces,
               "launches": paths["serve_int8"][name], "launches_by_path": by_path(name),
               "max_abs_err": max(r["max_abs_err"] for r in rows),
               **{key: L * at[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
               "bound_by": at["bound_by"],
               "per": "one 7B decode step at B=8, every slot at position 2047, page 16: "
                      "32 launches"}
        if name == "paged_decode_attention":
            row.update(serve_ms_per_step=gate["k7_ms_per_step"],
                       serve_bound_ms_per_step=gate["k7_bound_ms_per_step"])
        return row

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
        paged_row("paged_decode_attention", "lit_llama_ja_tpu/ops/pallas/paged_attention.py:99"),
        paged_row("paged_decode_attention_db",
                  "lit_llama_ja_tpu/ops/pallas/paged_attention.py:228"),
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
    if sys.argv[1:2] == ["--gemms-of"]:
        print(json.dumps({"package": qmm_wrappers.__file__}), flush=True)
        phase_k1(timer, g, device)
        phase_quant_kernels(timer, g, device)
        phase_generate(g, device)
        return 0
    if sys.argv[1:2] == ["--attention-of"]:
        print(json.dumps({"package": flash_wrappers.__file__}), flush=True)
        phase_k2(timer, g, device)
        phase_k6(timer, g, device)
        phase_micro_step(device)
        return 0
    k1_rows = phase_k1(timer, g, device)
    k2_rows = phase_k2(timer, g, device)
    phase_edges(g, device)
    k6_rows = phase_k6(timer, g, device)
    structured_attention(device)
    # the int4 generation draws its weights where it always has, after K6's phase
    paths = {"generate_int4": phase_generate(g, device)}
    q_rows = phase_quant_kernels(timer, g, device)
    phase_quant_edges(g, device)
    del timer
    for fmt in GEN_FORMATS:
        paths[f"generate_{fmt}"] = phase_generate(g, device, fmt)
    paths["train"], ckpt = phase_train(device)
    phase_micro_step(device)
    paths["evaluate"] = phase_quant_eval(device, ckpt)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    paged_rows = phase_paged_kernels(Timer(device), g, device)
    phase_paged_edges(g, device)
    serve_paths, gate = phase_serve(g, device)
    paths.update(serve_paths)
    paths.update(phase_spec(g, device))
    emit({"kernels": summary(k1_rows, k2_rows, k6_rows, q_rows, paged_rows, gate, paths)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
