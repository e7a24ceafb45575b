"""Where the time of the decode GEMV of K1, K3, K4 and K5 (``csrc/qmm_gemv.cuh``) goes,
on the card.

    python -m lit_llama_ja_tpu_torch.ops.cuda.gemv_probe [ptxas] [splits] [variants]
        [trace] [micro] [bits=4,8,2,3] [only=VARIANT,...] [flush=write|read]

* ``ptxas``: compiles ``quant_matmul_int4.cu``, ``quant_matmul_int8.cu`` and
  ``quant_matmul_sub4.cu`` with ``-Xptxas -v`` under ``build/gemv_probe/`` and prints,
  for every instantiation of ``qmmv::gemv_fast`` and ``qmmv::gemv_general``, its
  registers, spill and stack bytes (one JSON line each) and its length in SASS
  instructions (``cuobjdump``).
* ``splits``: a one-element fill (the floor of a graph-replay time), then K1, K3 (int8,
  symmetric), K4 (int2) and K5 (int3; both whole-column over the padded K) at the five
  LLaMA-7B linear shapes at M = 1 and 8 with the plan of `gemv_plan`, and at M = 1 with
  the K split (the blocks of a cluster) forced to 2, 4 and 8; then the sum over one 7B
  decode step's 161 linears for each split rule.
* ``variants``: the same shapes at M = 1 through kernels built from text edits of the
  sources (VARIANTS: no decode and no mma, no cluster reduction, twice the k16 steps a
  batch of loads, int3 without its high plane's decode, ...); they compute garbage,
  only their times are theirs.
* ``trace``: globaltimer stamps of every block of the fast route (STAMPS) after an L2
  flush, one call a shape: the median and largest time of each phase after the first
  block's start.
* ``micro``: reference kernels (MICRO_SRC) in the fast route's load pattern: loads alone;
  loads, decode, mma and the cluster reduction; and the same with code that never runs;
  at int4's bytes and at int2's (half the packed rows).

``bits=`` keeps the named formats (default all four), ``only=`` the named variants.
Times are medians of 20 replays of the call captured in a CUDA graph, each after a 256
MB write that flushes the L2 cache, as ``chip_smoke.py`` times them (``flush=read``: a
256 MB read instead, which leaves no dirty line to write back). With no argument it
runs ptxas, splits and variants. Nothing here is used by the port.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qmm
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul_sub4 as qsub4
from lit_llama_ja_tpu_torch.quant.linear import sub4_pad_rows

MMA = "for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][j], a, b[mt][0], b[mt][1]);"
ONES_MMA = "for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(xsum[mt], ones, b[mt][0], b[mt][1]);"
FRAG = "Dec::frag(w, j, part, a);"
DSMEM = "for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(part, q)[e];"
RAW = ("a[0] = word(w[0], j >> 1); a[1] = word(w[0], (j >> 1) ^ 1); "
       "a[2] = word(w[Dec::LOADS - 1], j >> 1); a[3] = word(w[Dec::LOADS - 1], (j >> 1) ^ 1);")
SINK = ("for (int mt = 0; mt < MT; ++mt) acc[mt][j][0] += "
        "__uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[mt][0]) & 0x3FFFFFFFu);")
INT3_HI = "const uint32_t h = qmmv::word(w[1], j >> 1) >> ((threadIdx.x & 1) << 2);"
# text edits of qmm_gemv.cuh, or (file, old, new) of another source: what a part of a
# k16 step costs (the variants compute garbage)
VARIANTS = {
    "kernel": [],
    "loads_only": [(MMA, SINK), (ONES_MMA, ""), (FRAG, RAW)],
    "no_epilogue": [(DSMEM, "v = part[e];"), ("  cluster_wait();", "  __syncthreads();"),
                    ("  cluster_arrive_release();", ""), ("  cluster_arrive_relaxed();", "")],
    "u_double": [("  constexpr int U = Dec::U;\n  constexpr int XR",
                  "  constexpr int U = 2 * Dec::U;\n  constexpr int XR")],
    "no_final_flush": [("  if (grp >= 0) flush();\n  __syncthreads();\n  reduce_and_store",
                        "  __syncthreads();\n  reduce_and_store")],
    # the next batch's loads issued before this batch's products (two batches in flight)
    "prefetch": [("    for (int s0 = wb; s0 < we; s0 += U) {\n"
                  "      if (s0 > wb) load_batch(w, s0, we);",
                  "    uint4 wn[U][Dec::LOADS];\n    for (int s0 = wb; s0 < we; s0 += U) {\n"
                  "      if (s0 + U < we) load_batch(wn, s0 + U, we);"),
                 ("          step_product<Dec, MT>(acc, xsum, w[u], b);\n        }\n    }\n  }\n",
                  "          step_product<Dec, MT>(acc, xsum, w[u], b);\n        }\n"
                  "#pragma unroll\n      for (int u = 0; u < U; ++u)\n#pragma unroll\n"
                  "        for (int i = 0; i < Dec::LOADS; ++i) w[u][i] = wn[u][i];\n    }\n  }\n")],
    "int3_no_hi_decode": [("quant_matmul_sub4.cu", INT3_HI,
                           "const uint32_t h = (w[1].x & 0u) | (j & 0u);")],
}
LINEARS_7B = {(4096, 12288): 32, (4096, 4096): 32, (4096, 11008): 64, (11008, 4096): 32,
              (4096, 32000): 1}
# K splits forced on the plan; None: as planned
SPLITS = [None, 2, 4, 8]
LIBS = {"quant_matmul_int4": qmm._bind4, "quant_matmul_int8": qmm._bind8,
        "quant_matmul_sub4": qsub4._bind}
# bits -> (wrapper, source)
FORMATS = {4: (qmm.quant_matmul_int4, "quant_matmul_int4"),
           8: (qmm.quant_matmul_int8, "quant_matmul_int8"),
           2: (qsub4.quant_matmul_int2, "quant_matmul_sub4"),
           3: (qsub4.quant_matmul_int3, "quant_matmul_sub4")}
OUT_DIR = _build.BUILD_DIR.parent / "gemv_probe"


def weights(bits, K, N, g, dev):
    """Random whole-column leaves of one linear, as the wrapper takes them after x, and
    the extra arguments of its `gemv_plan` (int2/int3: the padded K and the high plane)."""
    s = torch.rand((1, N), generator=g, device=dev) * 0.01
    z = torch.zeros((1, N), device=dev)
    if bits in (2, 3):
        Kp = sub4_pad_rows(K)
        qw = torch.randint(0, 256, (Kp // 4, N), generator=g, device=dev, dtype=torch.uint8)
        if bits == 2:
            return (qw, s, z), (Kp, None)
        hi = torch.randint(0, 256, (Kp // 8, N), generator=g, device=dev, dtype=torch.uint8)
        return (qw, hi, s, z), (Kp, hi.data_ptr())
    qw = torch.randint(0, 256, (K // 2 if bits == 4 else K, N), generator=g, device=dev,
                       dtype=torch.uint8)
    return (qw if bits == 4 else qw.view(torch.int8), s, z), ()


def plan_of(bits, x, args, extra):
    M, K = x.shape
    N = args[-1].shape[-1]
    return qmm.gemv_plan(M, K, N, 1, _build.sm_count(x.device.index), x.data_ptr(),
                         args[0].data_ptr(), [args[-2].data_ptr(), args[-1].data_ptr()], bits,
                         *extra)


def ptxas_report(log: str):
    """(instantiation, registers, spill store bytes, stack frame bytes, smem bytes) of
    each GEMV in a -Xptxas -v log."""
    out, name, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*gemv_(?:fast|general)\S*)'", line)
        if m:
            kind = "fast" if "gemv_fast" in m.group(1) else "general"
            dec = re.search(r"(Int[234]Gemv|Int8GemvILb[01]E)E*Li(\d)E(Lb([01]))?", m.group(1))
            name = (f"{kind} {dec.group(1)} MT={dec.group(2)}"
                    + (f" vec16={dec.group(4)}" if dec.group(4) else "") if dec else m.group(1))
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            stack = int(re.search(r"(\d+) bytes stack frame", line).group(1))
        elif name and "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spill,
                        stack, int(smem.group(1)) if smem else 0))
            name = None
    return out


def ptxas() -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {src: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(OUT_DIR / f"{src}.so"),
         str(_build.CSRC / f"{src}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for src in LIBS}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {src}.cu failed:\n{log}")
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                               str(OUT_DIR / f"{src}.so")], capture_output=True, text=True).stdout
        for fn, body in re.findall(r"Function : (\S*gemv_(?:fast|general)\S*)(.*?)\.{10,}",
                                   sass, re.S):
            print(json.dumps({"sass": src, "function": fn[-60:],
                              "instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", body))}),
                  flush=True)
        for inst, regs, spill, stack, smem in ptxas_report(log):
            print(json.dumps({"ptxas": src, "instantiation": inst, "registers": regs,
                              "spill_store_bytes": spill, "stack_frame_bytes": stack,
                              "static_smem_bytes": smem}), flush=True)


def flush_buffer(dev, mode):
    """256 MB that evict the L2 cache before each timed call: written (``mode``
    "write", as chip_smoke.py does: the cache is left full of dirty lines, which the
    next kernel's loads must write back) or read ("read": the cache is left clean)."""
    if mode == "read":
        return torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    return torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)


def evict(flush) -> None:
    if flush.dtype == torch.uint8:
        flush.zero_()
    else:
        flush.sum()


def graph_ms(fn, flush, reps=20, warmup=3) -> float:
    """Median replay time of one call of ``fn`` captured in a CUDA graph, the L2 cache
    evicted before each replay by ``flush`` (`flush_buffer`)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(warmup):
        graph.replay()
    pairs = []
    for _ in range(reps):
        evict(flush)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def forced(split):
    """`gemv_plan` with its K split replaced by ``split`` (None: as planned)."""
    plan = qmm.gemv_plan

    def fn(M, K, N, *a):
        p = plan(M, K, N, *a)
        if split is None:
            return p
        n_steps = -(-K // 16)
        steps = -(-n_steps // split)
        if p.fast:
            steps = -(-steps // 4) * 4
        return p._replace(ksplit=-(-n_steps // steps), steps=steps)
    return fn


def splits(formats, flush_mode) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = flush_buffer(dev, flush_mode)
    one = torch.empty(1, device=dev)
    print(json.dumps({"floor": "one-element fill", "graph_ms": graph_ms(one.zero_, flush)}),
          flush=True)
    sums = {}
    for bits in formats:
        fn = FORMATS[bits][0]
        for (K, N), count in LINEARS_7B.items():
            args, extra = weights(bits, K, N, g, dev)
            for M in (1, 8):
                x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
                want = fn(x, *args).float()
                for split in SPLITS if M == 1 else SPLITS[:1]:
                    with mock.patch.object(qmm, "gemv_plan", forced(split)):
                        got = fn(x, *args).float()
                        ms = graph_ms(lambda: fn(x, *args), flush)
                        p = plan_of(bits, x, args, extra)
                    assert torch.equal(got, want) or split is not None
                    print(json.dumps({"bits": bits, "K": K, "N": N, "M": M,
                                      "split": split or "plan", "ksplit": p.ksplit,
                                      "fast": p.fast, "graph_ms": ms,
                                      "max_abs_diff_vs_plan": (got - want).abs().max().item()}),
                          flush=True)
                    key = (bits, M, split)
                    sums[key] = sums.get(key, 0.0) + count * ms
    for (bits, M, split), ms in sums.items():
        print(json.dumps({"bits": bits, "M": M, "split": split or "plan",
                          "decode_step_graph_ms": ms}), flush=True)


STAMP_DEF = """
__device__ unsigned long long stamps[8192 * 8];
__device__ __forceinline__ void stamp(int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + i] = t;
}
"""
# globaltimer stamps of thread 0 of every block of the fast route: start, first loads
# issued, x staged (these two are rewritten by each chunk of CHUNK_STEPS / 2 k16 steps,
# so they are the block's last chunk's), loop and flush done, block barrier passed,
# first cluster barrier passed, sums read, end
STAMPS = [
    ("namespace qmmv {\n", "namespace qmmv {\n" + STAMP_DEF),
    ("  for (int e = lane; e < SLOT; e += 32) yw[e] = 0.f;\n",
     "  stamp(0);\n  for (int e = lane; e < SLOT; e += 32) yw[e] = 0.f;\n"),
    ("    uint4 w[U][Dec::LOADS];\n    load_batch(w, wb, we);\n",
     "    uint4 w[U][Dec::LOADS];\n    load_batch(w, wb, we);\n    stamp(1);\n"),
    ("    __syncthreads();\n    for (int s0 = wb; s0 < we; s0 += U) {",
     "    __syncthreads();\n    stamp(2);\n    for (int s0 = wb; s0 < we; s0 += U) {"),
    ("  if (grp >= 0) flush();\n  __syncthreads();\n  reduce_and_store",
     "  if (grp >= 0) flush();\n  stamp(3);\n  __syncthreads();\n  stamp(4);\n  reduce_and_store"),
    ("  cluster_wait();\n  const int C", "  cluster_wait();\n  stamp(5);\n  const int C"),
    ("  cluster_arrive_relaxed();", "  stamp(6);\n  cluster_arrive_relaxed();"),
    ("  cluster_wait();\n}\n", "  cluster_wait();\n  stamp(7);\n}\n"),
    ("}  // namespace qmmv\n",
     "}  // namespace qmmv\nextern \"C\" int lljt_stamps(void* host, int n) "
     "{ return (int)cudaMemcpyFromSymbol(host, qmmv::stamps, 8ull * n); }\n"),
]


def trace(formats, flush_mode) -> None:
    """Per-block phase times at the 7B decode shapes, M = 1, from the stamps variant
    (after an L2 flush, one call): the median and largest time of each stamp after the
    first block's start, over the blocks."""
    build_variant_libs({"stamps": STAMPS}, formats)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = flush_buffer(dev, flush_mode)
    saved = dict(_build._libs)
    try:
        use_variant("stamps", formats)
        for bits in formats:
            fn, src = FORMATS[bits]
            lib = _build._libs[src]
            for K, N in LINEARS_7B:
                args, extra = weights(bits, K, N, g, dev)
                x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
                fn(x, *args)
                evict(flush)
                torch.cuda.synchronize()
                fn(x, *args)
                torch.cuda.synchronize()
                p = plan_of(bits, x, args, extra)
                n_blocks = p.ksplit * -(-N // 128)
                host = (ctypes.c_ulonglong * (8 * n_blocks))()
                _build.check(lib, lib.lljt_stamps(host, 8 * n_blocks), "stamps")
                st = torch.tensor(list(host), dtype=torch.float64).view(n_blocks, 8)
                st = (st - st[:, 0].min()) / 1e3  # us after the first block started
                print(json.dumps({"bits": bits, "K": K, "N": N, "blocks": n_blocks,
                                  "median_us": [round(v, 2) for v in st.median(0).values.tolist()],
                                  "max_us": [round(v, 2) for v in st.max(0).values.tolist()]}),
                      flush=True)
    finally:
        _build._libs.clear()
        _build._libs.update(saved)


def sources(formats):
    return sorted({FORMATS[b][1] for b in formats})


def build_variant_libs(variants, formats) -> None:
    nvcc = _build.find_nvcc()
    procs = []
    for name, edits in variants.items():
        d = OUT_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for edit in edits:
            fname, old, new = edit if len(edit) == 3 else ("qmm_gemv.cuh", *edit)
            src = (d / fname).read_text()
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in {fname}")
            (d / fname).write_text(src.replace(old, new))
        for lib in sources(formats):
            procs.append(subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")


def use_variant(name: str, formats) -> None:
    for lib in sources(formats):
        bind = LIBS[lib]
        handle = ctypes.CDLL(str(OUT_DIR / name / f"{lib}.so"))
        handle.lljt_error_string.argtypes = [ctypes.c_int]
        handle.lljt_error_string.restype = ctypes.c_char_p
        bind(handle)
        if name == "stamps":
            handle.lljt_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _build._libs[lib] = handle


MICRO_SRC = r"""
#include "common.cuh"
#include <cooperative_groups.h>
// Reference kernels for the GEMV's loads: lane (g, t) of warp w of block (split, tile)
// reads packed rows 8s + 2t + i (i < 2) of k16 steps s, columns 128 tile + 16g, 16 bytes
// a load, 4 steps a batch, as the fast route does. pat only loads; full also stages x
// (one row) in shared memory, decodes int4 and runs the 9 mma of a step, and ends with
// the cluster reduction; BLOAT adds about 1800 instructions that never run.
__device__ __forceinline__ uint4 ldnc(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t wd(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t pr(uint32_t w, int p) {
  return (__byte_perm(w, w >> 4, ((4 + p) << 8) | p) & 0x000F000Fu) ^ 0x43084300u;
}
template <bool FULL, bool BLOAT>
__global__ void micro(const uint8_t* w, const uint16_t* x, int rows, int N, int steps_per_split,
                      float* out) {
  __shared__ __align__(16) uint16_t xs[8 * 1040];
  __shared__ float red[4 * 128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int col = blockIdx.y * 128 + 16 * g, S = rows / 8;
  const int sb = blockIdx.x * steps_per_split, se = min(S, sb + steps_per_split);
  const int per = (se - sb + 3) / 4, wb = min(se, sb + warp * per), we = min(se, wb + per);
  float acc[8][4] = {}, xsum[4] = {};
  uint32_t bits = 0;
  uint4 v[4][2];
  for (int s0 = wb; s0 < we; s0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[u][i] = s0 + u < we ? ldnc(w + (size_t)(8 * (s0 + u) + 2 * t + i) * N + col)
                              : make_uint4(0, 0, 0, 0);
    if (FULL && s0 == wb) {
      for (int idx = threadIdx.x; idx < 8 * 64; idx += 128) {
        const int m = idx / 64, c = 8 * (idx % 64);
        *reinterpret_cast<uint4*>(xs + m * 1040 + c) =
            m == 0 ? __ldg(reinterpret_cast<const uint4*>(x + 16 * sb + c))
                   : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!FULL) { bits ^= v[u][0].x ^ v[u][0].w ^ v[u][1].y ^ v[u][1].z; continue; }
      if (s0 + u >= we) continue;
      const uint2 b = *reinterpret_cast<const uint2*>(xs + g * 1040 + 16 * (s0 + u - sb) + 4 * t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w0 = wd(v[u][0], j >> 1), w1 = wd(v[u][1], j >> 1);
        const int p = 2 * (j & 1);
        const uint32_t a[4] = {pr(w0, p), pr(w0, p + 1), pr(w1, p), pr(w1, p + 1)};
        mma_bf16_16816(acc[j], a, b.x, b.y);
      }
      const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
      mma_bf16_16816(xsum, ones, b.x, b.y);
    }
  }
  if (BLOAT && N == 12345) {
#pragma unroll
    for (int rep = 0; rep < 24; ++rep) {
      const uint2 b = *reinterpret_cast<const uint2*>(xs + g * 1040 + rep * 8 + 4 * t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w0 = wd(v[rep & 3][0], j >> 1) ^ rep, w1 = wd(v[rep & 3][1], j >> 1);
        const int p = 2 * (j & 1);
        const uint32_t a[4] = {pr(w0, p), pr(w0, p + 1), pr(w1, p), pr(w1, p + 1)};
        mma_bf16_16816(acc[j], a, b.x, b.y);
      }
    }
  }
  float y = xsum[0] + __uint_as_float(bits & 0x3FFFFFFFu);
  for (int j = 0; j < 8; ++j) y += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (!FULL) {
    if (y == 1234.5f) out[0] = y;
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  red[threadIdx.x] = y;
  __syncthreads();
  if (warp == 0)
    for (int q = 1; q < 4; ++q) red[lane] += red[q * 128 + lane];
  cl.sync();
  float z = 0.f;
  for (int q = 0; q < (int)cl.num_blocks(); ++q) z += cl.map_shared_rank(red, q)[threadIdx.x];
  out[blockIdx.y * 128 + threadIdx.x] = z;
  cl.sync();
}
extern "C" int lljt_micro(const void* w, const void* x, int rows, int N, int ksplit, void* out,
                          int kind, void* stream) {
  const int S = rows / 8, steps = (S + ksplit - 1) / ksplit;
  auto k = kind == 0 ? micro<false, false> : kind == 1 ? micro<true, false> : micro<true, true>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ksplit, (N + 127) / 128, 1);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = ksplit;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, k, static_cast<const uint8_t*>(w),
                                             static_cast<const uint16_t*>(x), rows, N, steps,
                                             static_cast<float*>(out)));
}
"""


def micro(flush_mode) -> None:
    """Reference kernels (MICRO_SRC) at the 7B shapes with K = 4096 and N = 4096, 11008
    and 32000, K split 8, over int4's bytes (2048 packed rows) and int2's (1024): pure
    loads in the fast route's pattern; loads with the decode, the mma and the cluster
    reduction; and the same with 1800 instructions that never run. Graph-replay
    medians, L2 flushed as ``flush_mode`` says."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "micro.cu"
    src.write_text(MICRO_SRC)
    so = OUT_DIR / "micro.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.lljt_micro.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = flush_buffer(dev, flush_mode)
    out = torch.zeros(40000, device=dev)
    for rows, fmt in ((2048, "int4"), (1024, "int2")):
        for N in (4096, 11008, 32000):
            w = torch.randint(0, 256, (rows, N), generator=g, device=dev, dtype=torch.uint8)
            x = torch.randn(4096, generator=g, device=dev).to(torch.bfloat16)
            row = {"bytes_of": fmt, "K": 4096, "N": N, "bytes": w.numel()}
            for kind, name in enumerate(("loads", "full", "full_bloat")):
                row[name + "_ms"] = graph_ms(lambda: lib.lljt_micro(
                    w.data_ptr(), x.data_ptr(), rows, N, 8, out.data_ptr(), kind,
                    torch.cuda.current_stream().cuda_stream), flush)
            print(json.dumps(row), flush=True)


def variants(formats, names, flush_mode) -> None:
    """Build the variants ``names`` of VARIANTS and time each format through each at the
    7B decode shapes, M = 1, as `gemv_plan` splits them."""
    build_variant_libs({n: VARIANTS[n] for n in names}, formats)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = flush_buffer(dev, flush_mode)
    cases = []
    for bits in formats:
        for (K, N), count in LINEARS_7B.items():
            args, _ = weights(bits, K, N, g, dev)
            x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
            cases.append((bits, FORMATS[bits][0], K, N, count, (x, *args)))
    saved = dict(_build._libs)
    try:
        for name in names:
            use_variant(name, formats)
            sums = {}
            for bits, fn, K, N, count, args in cases:
                ms = graph_ms(lambda: fn(*args), flush)
                sums[bits] = sums.get(bits, 0.0) + count * ms
                print(json.dumps({"variant": name, "bits": bits, "K": K, "N": N, "M": 1,
                                  "graph_ms": ms}), flush=True)
            for bits, ms in sums.items():
                print(json.dumps({"variant": name, "bits": bits, "decode_step_graph_ms": ms}),
                      flush=True)
    finally:
        _build._libs.clear()
        _build._libs.update(saved)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gemv_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    flush_mode = opts.get("flush", "write")
    formats = [int(b) for b in opts.get("bits", "4,8,2,3").split(",")]
    names = opts["only"].split(",") if "only" in opts else list(VARIANTS)
    todo = [a for a in argv if "=" not in a] or ["ptxas", "splits", "variants"]
    if "ptxas" in todo:
        ptxas()
    if "splits" in todo:
        splits(formats, flush_mode)
    if "variants" in todo:
        variants(formats, names, flush_mode)
    if "trace" in todo:
        trace(formats, flush_mode)
    if "micro" in todo:
        micro(flush_mode)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
