"""Where the time of the K3-K5 prefill GEMM (``csrc/qmm_generic.cuh``) goes, on the card.

    python -m lit_llama_ja_tpu_torch.ops.cuda.gemm_probe

Builds variants of the kernel sources from text edits of a copy under
``build/gemm_probe/``: the kernel as it is; without the decode of the next tile; without
the copies of the tile after; with neither; with 6 stages where a block has an SM to
itself; with 16 warps a block; and the kernel as it is with the tile width forced to 64
or 128. It prints the registers and spills that ``-Xptxas -v`` reports for each
instantiation of the kernel as it is. Each variant runs the int8 (symmetric), int2 and
int3 GEMMs at the five LLaMA-7B linear shapes at M = 512 and prints one JSON line per
run: CUDA-event median of 20 launches with the L2 cache flushed before each, TFLOP/s,
and the error against the plain version relative to its largest magnitude (the
variants that skip work compute garbage; only the timing is theirs). The variants show
which parts of a tile add to its time; they are never used by the port.
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

M = 512
SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
DECODE = "if (decoding && ks % P::DECODE_EVERY == 0)"
FETCH = "if (fetching) fetch(tf, ks);"
STAGES = "static constexpr int STAGES = 4;"
WARPS = "static constexpr int WARPS_M = BN == 64 ? 4 : 2, WARPS_N = BN == 64 ? 2 : 4;"
VARIANTS = {
    "kernel": [],
    "no_decode": [(DECODE, "if (false)")],
    "no_copy": [(FETCH, "")],
    "mma_only": [(DECODE, "if (false)"), (FETCH, "")],
    "six_stages": [(STAGES, "static constexpr int STAGES = BLOCKS_PER_SM == 2 ? 4 : 6;")],
    "sixteen_warps": [(WARPS, "static constexpr int WARPS_M = 4, WARPS_N = 4;")],
}
RUNS = [(v, None) for v in VARIANTS] + [("kernel", 64), ("kernel", 128)]
WORK = Path(__file__).resolve().parents[3] / "build" / "gemm_probe"
LIBS = {"quant_matmul_int8": q8._bind8, "quant_matmul_sub4": qs._bind}


def ptxas_report(log: str):
    """(instantiation, registers, spill store bytes) of each GEMM in a -Xptxas -v log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*qmm_gemm_kernel\S*)'", line)
        if m:
            fmt = re.search(r"(Int8FmtILb[01]E|Int2Fmt|Int3Fmt)E*Li(\d+)", m.group(1))
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


def use_variant(name: str) -> None:
    """Make the wrappers launch the kernels of variant ``name``."""
    for lib, bind in LIBS.items():
        handle = ctypes.CDLL(str(WORK / name / f"{lib}.so"))
        handle.lljt_error_string.argtypes = [ctypes.c_int]
        handle.lljt_error_string.restype = ctypes.c_char_p
        bind(handle)
        _build._libs[lib] = handle


def cases(g, device):
    """(wrapper, args, plain output, K, N): random whole-column packs, scales about 0.01."""
    out = []
    for fn, bits in ((q8.quant_matmul_int8, 8), (qs.quant_matmul_int2, 2),
                     (qs.quant_matmul_int3, 3)):
        for K, N in SHAPES:
            def rand(rows, lo=0, hi=256):
                return torch.randint(lo, hi, (rows, N), generator=g, device=device)
            s = torch.rand((1, N), generator=g, device=device) * 0.01 + 0.005
            z = torch.zeros((1, N), device=device) if bits == 8 else \
                torch.randint(0, 2**bits, (1, N), generator=g, device=device).float()
            if bits == 8:
                args = (rand(K, -127, 128).to(torch.int8), s, z)
            else:
                Kp = -(-K // 1024) * 1024  # sub4_pad_rows for K >= 2048
                args = (rand(Kp // 4).to(torch.uint8),) + (
                    (rand(Kp // 8).to(torch.uint8),) if bits == 3 else ()) + (s, z)
            x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
            want = {8: q8.quant_matmul_int8_ref, 2: qs.quant_matmul_int2_ref,
                    3: qs.quant_matmul_int3_ref}[bits](x, *args).float()
            out.append((fn, (x, *args), want, K, N))
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
        for variant, bn in RUNS:
            use_variant(variant)
            q8.gemm_plan = plan if bn is None else (lambda *a, bn=bn: (bn, *plan(*a)[1:]))
            for fn, args, want, K, N in runs:
                got = fn(*args).float()
                ms = time_ms(lambda: fn(*args), flush)
                err = ((got - want).abs().max() / want.abs().max()).item()
                print(json.dumps({"variant": variant, "bn": bn, "kernel": fn.__name__,
                                  "K": K, "N": N, "M": M, "ms": ms,
                                  "tflops": 2 * M * K * N / ms / 1e9, "rel_err": err}),
                      flush=True)
    finally:
        q8.gemm_plan = plan
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
