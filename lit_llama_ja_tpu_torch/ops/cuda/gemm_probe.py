"""Where the time of the K1 and K3-K5 prefill GEMM (``csrc/qmm_generic.cuh``) goes, on
the card.

    python -m lit_llama_ja_tpu_torch.ops.cuda.gemm_probe

Builds variants of the kernel sources from text edits of a copy under
``build/gemm_probe/``: the kernel as it is; without the decode of the next tile; without
the copies of the tile after; with neither (the wgmma loop alone); without the proxy
fence before the tile's barrier; with 6 or 3 stages at BN = 128; with two blocks an
SM at BN = 128 (3 stages, 128 registers); and with 256-row blocks of four warpgroups.
It prints the registers and spills that ``-Xptxas -v`` reports for each instantiation
of the kernel as it is, and any line of that log that names wgmma (ptxas says there
when it serializes the asynchronous products). Each variant runs the int4, int8
(symmetric), int2 and int3 GEMMs at the five LLaMA-7B linear shapes at
M = 512; the kernel and the 256-row variant also with the tile width forced to 64 and
to 128, there also at the 125M shapes at M = 2048 and the 7B shapes at M = 128. It
prints one JSON line per run: CUDA-event median of 20 launches with the L2 cache
flushed before each, TFLOP/s, and the error against the plain version relative to its
largest magnitude (the variants that skip work compute garbage; only the timing is
theirs); then one line per variant, format and shape set with the sum over one
forward's linears. The variants show which parts of a tile add to its time; they are
never used by the port.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as q8
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul_sub4 as qs
from lit_llama_ja_tpu_torch.quant.linear import sub4_pad_rows

LINEARS_7B = {(4096, 12288): 32, (4096, 4096): 32, (4096, 11008): 64, (11008, 4096): 32,
              (4096, 32000): 1}
LINEARS_125M = {(780, 2340): 12, (780, 780): 12, (780, 2304): 24, (2304, 780): 12,
                (780, 35008): 1}
# name -> (M, {(K, N): launches in one forward}): the 7B prefill (161 linears), the 125M
# perplexity window (61), and a 128-token chunk of a 7B prefill
SETS = {"7B": (512, LINEARS_7B), "125M": (2048, LINEARS_125M), "7B_M128": (128, LINEARS_7B)}
DECODE = "if (kt + 1 < n_tiles) decode_tile(kt + 1);"
FETCH = "if (tf < n_tiles) fetch(tf);"
STAGES = "static constexpr int STAGES = 4;"
VARIANTS = {
    "kernel": [],
    "no_decode": [(DECODE, "")],
    "no_copy": [(FETCH, "")],
    "wgmma_only": [(DECODE, ""), (FETCH, "")],
    "no_proxy_fence": [("fence_proxy_async();\n    __syncthreads();", "__syncthreads();")],
    "six_stages": [(STAGES, "static constexpr int STAGES = BN == 128 ? 6 : 4;")],
    "three_stages": [(STAGES, "static constexpr int STAGES = BN == 128 ? 3 : 4;")],
    # BN = 128 at two blocks an SM: 3 stages to fit, registers capped at 128
    "two_blocks": [(STAGES, "static constexpr int STAGES = BN == 128 ? 3 : 4;"),
                   ("BLOCKS_PER_SM = BN == 64 ? 2 : 1;", "BLOCKS_PER_SM = 2;")],
    # 256 rows a block: four warpgroups, each weight tile decoded once per 256 rows
    "bm256": [("constexpr int BM = 128;", "constexpr int BM = 256;"),
              ("constexpr int THREADS = 256;", "constexpr int THREADS = 512;"),
              ("BLOCKS_PER_SM = BN == 64 ? 2 : 1;", "BLOCKS_PER_SM = 1;")],
}
ALL_SETS = tuple(SETS)
WRAPPERS = {4: q8.quant_matmul_int4, 8: q8.quant_matmul_int8, 2: qs.quant_matmul_int2,
            3: qs.quant_matmul_int3}
REFS = {4: q8.quant_matmul_int4_ref, 8: q8.quant_matmul_int8_ref, 2: qs.quant_matmul_int2_ref,
        3: qs.quant_matmul_int3_ref}
# (variant, forced tile width or None for the plan's, shape sets)
RUNS = ([(v, None, ("7B",)) for v in VARIANTS if v != "bm256"]
        + [(v, bn, ALL_SETS) for v in ("kernel", "bm256") for bn in (64, 128)])
WORK = Path(__file__).resolve().parents[3] / "build" / "gemm_probe"
LIBS = {"quant_matmul_int4": q8._bind4, "quant_matmul_int8": q8._bind8,
        "quant_matmul_sub4": qs._bind}


def ptxas_report(log: str):
    """(instantiation, registers, spill store bytes) of each GEMM in a -Xptxas -v log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*qmm_gemm_kernel\S*)'", line)
        if m:
            fmt = re.search(r"(Int4Fmt|Int8FmtILb[01]E|Int2Fmt|Int3Fmt)E*Li(\d+)", m.group(1))
            name = f"{fmt.group(1)} BN={fmt.group(2)}" if fmt else m.group(1)
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            name = None
    return out


def build_variants() -> None:
    shutil.rmtree(WORK, ignore_errors=True)
    nvcc = _build.find_nvcc()
    procs = []
    for name, edits in VARIANTS.items():
        d = WORK / name
        shutil.copytree(_build.CSRC, d)
        src = (d / "qmm_generic.cuh").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in qmm_generic.cuh")
            src = src.replace(old, new)
        (d / "qmm_generic.cuh").write_text(src)
        for lib in LIBS:
            procs.append((name, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / f"{lib}.so"),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
        if name == "kernel":
            for inst, regs, spill in ptxas_report(log):
                print(json.dumps({"instantiation": inst, "registers": regs,
                                  "spill_store_bytes": spill}), flush=True)
            for line in log.splitlines():
                if "wgmma" in line:
                    print(json.dumps({"ptxas": line.strip()}), flush=True)


def use_variant(name: str) -> None:
    """Make the wrappers launch the kernels of variant ``name``."""
    for lib, bind in LIBS.items():
        handle = ctypes.CDLL(str(WORK / name / f"{lib}.so"))
        handle.lljt_error_string.argtypes = [ctypes.c_int]
        handle.lljt_error_string.restype = ctypes.c_char_p
        bind(handle)
        _build._libs[lib] = handle


def one_case(g, device, bits, M, K, N):
    """(args, plain output) of one format: a random whole-column pack, scales about 0.01."""
    def rand(rows, lo=0, hi=256):
        return torch.randint(lo, hi, (rows, N), generator=g, device=device)
    s = torch.rand((1, N), generator=g, device=device) * 0.01 + 0.005
    z = torch.zeros((1, N), device=device) if bits == 8 else \
        torch.randint(0, 2**bits, (1, N), generator=g, device=device).float()
    if bits == 8:
        packed = (rand(K, -127, 128).to(torch.int8),)
    elif bits == 4:
        packed = (rand(K // 2).to(torch.uint8),)
    else:
        Kp = sub4_pad_rows(K)
        packed = (rand(Kp // 4).to(torch.uint8),) + ((rand(Kp // 8).to(torch.uint8),)
                                                     if bits == 3 else ())
    x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
    args = (x, *packed, s, z)
    return args, REFS[bits](*args).float()


def cases(g, device):
    """(set, wrapper, args, plain output, M, K, N) over every format and shape set."""
    out = []
    for bits, fn in WRAPPERS.items():
        for set_name, (M, linears) in SETS.items():
            for K, N in linears:
                args, want = one_case(g, device, bits, M, K, N)
                out.append((set_name, fn, args, want, M, K, N))
    return out


def time_ms(fn, flush, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_probe: no CUDA device")
    device = torch.device("cuda")
    build_variants()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    runs = cases(torch.Generator(device=device).manual_seed(0), device)
    plan = q8.gemm_plan
    try:
        for variant, bn, sets in RUNS:
            use_variant(variant)
            q8.gemm_plan = plan if bn is None else (lambda *a, bn=bn: (bn, *plan(*a)[1:]))
            sums = {}
            for set_name, fn, args, want, M, K, N in runs:
                if set_name not in sets:
                    continue
                got = fn(*args).float()
                ms = time_ms(lambda: fn(*args), flush)
                err = ((got - want).abs().max() / want.abs().max()).item()
                key = (fn.__name__, set_name)
                sums[key] = sums.get(key, 0.0) + SETS[set_name][1][(K, N)] * ms
                print(json.dumps({"variant": variant, "bn": bn, "kernel": fn.__name__,
                                  "set": set_name, "K": K, "N": N, "M": M, "ms": ms,
                                  "tflops": 2 * M * K * N / ms / 1e9, "rel_err": err}),
                      flush=True)
            for (name, set_name), total in sums.items():
                print(json.dumps({"variant": variant, "bn": bn, "kernel": name, "set": set_name,
                                  "forward_sum_ms": total}), flush=True)
    finally:
        q8.gemm_plan = plan
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
