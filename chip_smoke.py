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
  4. generate  LLaMA-7B at full width (random int4 weights from a seed): the port's
               `generate` on a 500-token prompt with an int4 KV cache, greedy, 32 new
               tokens; launch counts, repeatability, and the prefill logits against
               the plain versions of both kernels.
  5. kernels   one line with every ported kernel, its launches on the main path
               (phase 4's first run), its time beside its bound, the plain version's
               time and the library call's time. Each time there is the sum over the
               kernel's launches in one forward of the main path: K1 over the 161
               linears of one decode step (M = 1), K2 over the 32 layers of the prefill.
  6. the last line: {"ok": true, "device": {...}}.

Times are CUDA-event medians of 20 launches after 3 warm-up launches, with a 256 MB
buffer written between launches so that each one finds the L2 cache cold, as the
decode loop does. Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM and
989 TFLOP/s of dense bf16. TF32 is off for matmuls and cuDNN, so the float32 parts
of the plain versions run in full float32.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_configs
from lit_llama_ja_tpu_torch.infer.generate import bucket_length, generate
from lit_llama_ja_tpu_torch.models.llama import forward_with_cache, init_kv_cache
from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    quant_matmul_int4,
    quant_matmul_int4_ref,
)
from lit_llama_ja_tpu_torch.quant.linear import dequantize_with_k

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
REL_TOL = 2e-2  # kernel vs plain: |got - want| <= 2e-2 * max|want| (bf16 inputs)
LSE_ATOL = 1e-3  # f32 statistics on both sides
LOGIT_REL_TOL = 5e-2  # 32 bf16 layers: ||Δ|| <= 5e-2 ||plain|| over the prefill logits
ARGMAX_AGREE = 0.9  # share of prefill rows whose argmax agrees


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


def synth_7b_params(config: LLaMAConfig, g, device):
    """Random packed-int4 LLaMA params with whole-column scales 0.01 and zeros 7, bf16
    embedding and norms: the int4 tree layout of the quantized JAX checkpoints."""
    L, D, H, V = config.n_layer, config.n_embd, config.n_hidden, config.padded_vocab_size

    def qlin(K, N, lead=()):
        qweight = torch.randint(0, 256, (*lead, K // 2, N), generator=g, device=device,
                                dtype=torch.uint8)
        return {"qweight": qweight,
                "scales": torch.full((*lead, 1, N), 0.01, device=device),
                "zeros": torch.full((*lead, 1, N), 7.0, device=device)}

    bf16 = torch.bfloat16
    return {
        "wte": {"weight": (torch.randn((V, D), generator=g, device=device) * 0.02).to(bf16)},
        "lm_head": qlin(D, V),
        "ln_f": {"scale": torch.ones((D,), dtype=bf16, device=device)},
        "blocks": {
            "rms_1": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "attn": {"c_attn": qlin(D, 3 * D, (L,)), "c_proj": qlin(D, D, (L,))},
            "rms_2": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "mlp": {"c_fc1": qlin(D, H, (L,)), "c_fc2": qlin(D, H, (L,)),
                    "c_proj": qlin(H, D, (L,))},
        },
    }


def phase_generate(g, device):
    config = LLaMAConfig.from_name("7B")
    assert llama_configs["7B"] == dict(n_layer=32, n_head=32, n_embd=4096)
    L = config.n_layer
    params = synth_7b_params(config, g, device)
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
    quant_matmul_int4.launches = 0
    flash_attention_fwd.launches = 0
    out_a, _ = run(new)
    launches = {"quant_matmul_int4": quant_matmul_int4.launches,
                "flash_attention_fwd": flash_attention_fwd.launches}
    per_forward = 5 * L + 1
    assert launches["quant_matmul_int4"] == per_forward * new, launches
    assert launches["flash_attention_fwd"] == L, launches
    assert out_a.shape == (T + new,) and (out_a[:T] == prompt).all()
    assert ((out_a >= 0) & (out_a < config.padded_vocab_size)).all()

    torch.cuda.reset_peak_memory_stats()
    out_b, total_ms = run(new)
    peak = torch.cuda.max_memory_allocated()
    assert (out_a == out_b).all(), "greedy generation is not repeatable"
    _, prefill_ms = run(1)

    # prefill logits, kernel path vs the plain versions of both kernels on the card
    P = bucket_length(T)
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :T] = torch.as_tensor(prompt, device=device)

    def prefill():
        cache = init_kv_cache(config, 1, T + new, torch.bfloat16, "int4", device=device)
        return forward_with_cache(params, idx, torch.arange(P), cache, config,
                                  prefill_attn=True, device=device)[0].float()

    got = prefill()
    with mock.patch("lit_llama_ja_tpu_torch.quant.linear.quant_matmul_int4",
                    quant_matmul_int4_ref), \
         mock.patch("lit_llama_ja_tpu_torch.ops.attention.flash_attention_fwd",
                    flash_attention_fwd_ref):
        want = prefill()
    assert got.shape == (1, P, config.padded_vocab_size) and torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    emit({"phase": "generate", "config": "7B", "n_layer": L, "weights": "int4, G=1",
          "kv_cache": "int4", "prompt": T, "bucket": P, "new_tokens": new,
          "weight_bytes": weight_bytes, "launches": launches,
          "launches_per_forward": {"quant_matmul_int4": per_forward,
                                   "flash_attention_fwd": L},
          "prefill_ms": prefill_ms, "total_ms": total_ms,
          "decode_ms_per_token": decode_ms, "decode_tok_s": 1e3 / decode_ms,
          "peak_mem_bytes": peak, "logits_rel_err": rel, "argmax_agree": agree,
          "tokens": out_a[T:].tolist()})
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def summary(k1_rows, k2_rows, launches):
    """Per-forward sums: K1 over one decode step, K2 over one prefill."""
    L = llama_configs["7B"]["n_layer"]
    per_layer = {(4096, 12288): 1, (4096, 4096): 1, (4096, 11008): 2, (11008, 4096): 1}
    weight = {(k, n): L * c for (k, n), c in per_layer.items()}
    weight[(4096, 32000)] = 1
    dec = {(r["K"], r["N"]): r for r in k1_rows if r["M"] == 1 and r["groups"] == 1}
    pre = [r for r in k2_rows if (r["n_head"], r["head_dim"], r["T"]) == (32, 128, 512)][0]

    def k1_sum(key):
        return sum(c * dec[s][key] for s, c in weight.items())

    return [
        {"name": "quant_matmul_int4", "route": "cuda",
         "source": "lit_llama_ja_tpu_torch/csrc/quant_matmul_int4.cu",
         "replaces": "lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325",
         "launches": launches["quant_matmul_int4"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         "ms": k1_sum("ms"), "plain_ms": k1_sum("plain_ms"), "bound_ms": k1_sum("bound_ms"),
         "bound_by": "bytes", "library_ms": k1_sum("library_ms"),
         "per": "one 7B decode step: 161 launches at M=1"},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "lit_llama_ja_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "lit_llama_ja_tpu/ops/pallas/flash_attention.py:78",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": L * pre["ms"], "plain_ms": L * pre["plain_ms"], "bound_ms": L * pre["bound_ms"],
         "bound_by": pre["bound_by"], "library_ms": L * pre["library_ms"],
         "per": "one 7B prefill: 32 launches at n_head=32, T=512, head_dim=128"},
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
    del timer
    phase_edges(g, device)
    launches = phase_generate(g, device)
    emit({"kernels": summary(k1_rows, k2_rows, launches)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
