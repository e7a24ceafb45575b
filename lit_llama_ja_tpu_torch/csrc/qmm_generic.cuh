// The prefill GEMM (M > 16) of K1 and K3-K5 for Hopper (sm_90a), generic over the
// weight's pack format: y = x @ dequant(W), bf16 x and y, f32 dequant (q - zero) * scale,
// f32 accumulation. Included by quant_matmul_int4.cu (K1), quant_matmul_int8.cu (K3) and
// quant_matmul_sub4.cu (K4, K5), which each define the decoders of their formats and
// their C entry points; their decode GEMV (M <= 16) is the one of qmm_gemv.cuh.
//
// The weight is stored K-major as in lit_llama_ja_tpu/quant/linear.py: Kp stored
// K-rows (Kp = K for int4 and int8, the padded K for int2/int3), scales and zeros
// (G, N) f32, and K-row k reads scale row k / ceil(Kp / G) (the _expand_tiles rule). x
// has K columns and is read as zero past them, so the pad rows of a sub-4-bit pack,
// which hold level 0, contribute nothing and no padded copy of x is made.
//
// A decoder (Fmt) tells the kernel how to fetch and decode its bytes: a k-tile's packed
// rows are copied as stored into shared memory (Fmt::RPB0 K-rows per stored row of
// qweight, Fmt::RPB1 per row of qweight_hi, 0 for none), and Fmt::tile_levels<BN>(w, r,
// c, q) decodes the 8 levels of K-row r, columns c..c+7, from there.
//
// What bounds the GEMM on an H100, and what the design does about it:
//   * Prefill (M > 16) is bound by tensor-core flops from M = 64 on: 2 M flops per
//     weight against at most a byte of it and 4 M bytes of x and y per K-row and
//     column pair, past the H100's 295 flops a byte. qmm_gemm_kernel computes one
//     128 x BN output block with two warpgroups, each issuing wgmma m64nBNk16
//     bf16 -> f32 on its 64 rows, both operands read from shared memory:
//       - a ring of 4 stages in dynamic shared memory, filled by cp.async and
//         zero-filled by it past M, N, K and the stored rows: the x tile (128 x 64, in
//         wgmma's K-major 128-byte swizzle), the tile's packed bytes as stored (8, 4, 3
//         or 2 KB at BN = 128) and its group's scale and zero rows. One barrier passes
//         per 64-deep tile;
//       - the four wgmmas of tile k run asynchronously while the same warps issue the
//         copies of tile k+3 and decode tile k+1 into the second of two bf16 B buffers,
//         (q - z) * s in f32 rounded to bf16 as the plain version does, in wgmma's
//         MN-major 128-byte swizzle (64-column panels); generic-proxy writes are fenced
//         to the async proxy before the barrier that hands them to wgmma;
//       - BN = 128 (64 accumulators, 210-241 registers a thread: one block an SM), or
//         BN = 64 where 128-wide tiles would launch fewer blocks than half the card's
//         SMs (32 accumulators, 128 registers and 8-28 bytes of spills: two blocks an
//         SM). On an H100 (80GB HBM3, 700 W; ops/cuda/gemm_probe.py) BN = 128 was the
//         faster wherever 128-wide tiles gave 86 blocks or more (N = 4096 at M = 512:
//         128 blocks on 132 SMs), and BN = 64 where they gave 32.
//     The host picks the copy widths (gemm_plan, ops/cuda/quant_matmul.py): x rows lie
//     2K bytes apart, so 16-, 8- or 4-byte copies as K and the base allow, and an odd K
//     takes plain 2-byte loads into the stage; packed rows lie N bytes apart, so 16-,
//     8- or 4-byte copies, and byte loads when N % 4 != 0; scales 16 or 4. No layer
//     view the wrapper accepts is refused.
//     With mma.sync (the design before this one) the copies, the decode and the
//     product of a tile added up in the same warps' issue slots; wgmma takes the
//     product off them, and the loop of wgmmas alone runs at about the library's time
//     (gemm_probe, same card). What bounds it now: the decode of the next tile and the
//     copies still run in the 8 warps that issue the wgmmas and add up (each about as
//     long as the product; more stages change nothing, so not latency), and at M = 512
//     every weight tile is decoded by 4 row blocks (a 256-row block of four warpgroups,
//     capped at 128 registers a thread, was no faster). Next: TMA and an mbarrier ring,
//     the decode in a producer warpgroup of its own, a persistent grid.
#pragma once
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

// ---------------------------------------------------------------------------
// Prefill: tensor-core GEMM for M > 16
// ---------------------------------------------------------------------------

constexpr int BM = 128;            // rows of x per block: two warpgroups of 64
constexpr int BK = 64;             // K-rows per k-tile: one 128-byte row of x a block row
constexpr int KS = BK / 16;        // wgmma k-steps per tile
constexpr int THREADS = 256;       // two warpgroups
constexpr int TWO_BLOCKS_SMEM = 113 * 1024;  // per block, when two blocks share an SM
constexpr int SW128_ATOM = 1024;   // 8 rows of 128 bytes: the period of the 128-byte swizzle
constexpr int B_PANEL = BK * 128;  // bytes of one 64-column panel of a decoded B tile

constexpr int plane_rows(int rpb) { return rpb ? BK / rpb : 0; }
constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The shared memory of one instantiation. A stage holds one k-tile as it arrives: the
// x tile (BM x BK bf16), the tile's packed rows as stored (BK / RPB0 rows of qweight,
// then BK / RPB1 of qweight_hi, BN bytes each) and the scale and zero rows of the group
// of its first K-row (BN f32 each). Two B buffers hold decoded tiles (BK x BN bf16).
// Stages and B buffers start on 1024-byte boundaries, as wgmma's swizzled operands
// need; SMEM adds one atom of slack to align the dynamic base by hand. Each warpgroup
// keeps a 64 x BN f32 accumulator, BN / 2 registers a thread: at BN = 64 two blocks
// share an SM.
template <class Fmt, int BN>
struct GemmPlan {
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static constexpr int BLOCKS_PER_SM = BN == 64 ? 2 : 1;
  static constexpr int ACC = BN / 2;  // f32 accumulators a thread
  static constexpr int X_CHUNKS = BM * (BK / 8) / THREADS;  // 16-byte x chunks a thread copies
  static constexpr int DR = BK * (BN / 8) / THREADS;  // K-rows a thread decodes, 8 columns each
  static constexpr int STAGES = 4;  // k-tiles in the ring
  static constexpr int W_ROWS0 = plane_rows(Fmt::RPB0);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = (W_ROWS0 + plane_rows(Fmt::RPB1)) * BN;
  static constexpr int STAGE_BYTES = round_up(A_BYTES + W_BYTES + 2 * BN * 4, SW128_ATOM);
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * B_BYTES + SW128_ATOM;
  static_assert(BLOCKS_PER_SM == 1 || SMEM <= TWO_BLOCKS_SMEM, "two blocks must fit an SM");
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of row_bytes rows. The
// chunk index is XORed with the row's low three bits; with 128-byte rows from a
// 1024-byte aligned base this is the 128-byte swizzle (SW128) that wgmma reads, and the
// eight rows that eight lanes' 16-byte stores touch fall in eight bank groups.
__device__ __forceinline__ int swz(int row, int chunk, int row_bytes) {
  return row * row_bytes + ((chunk ^ (row & 7)) << 4);
}

// Byte offset of K-row k, columns c..c+7 (c a multiple of 8) in a decoded B tile:
// wgmma's MN-major SW128 layout, 64-column panels of BK rows of 128 bytes.
__device__ __forceinline__ int b_off(int k, int c) {
  return (c >> 6) * B_PANEL + swz(k, (c >> 3) & 7, 128);
}

// A wgmma shared-memory descriptor of a SW128 operand: start address, leading and
// stride byte offsets (each >> 4), layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// d += A (64 x 16, K-major SW128) @ B (16 x BN, MN-major SW128) on the tensor cores,
// issued by the 128 threads of a warpgroup; d is the m64nBN f32 accumulator, register
// 4j + 2h + e of a thread holding row 16 (warp % 4) + lane / 4 + 8h, column
// 8j + 2 (lane % 4) + e. Asynchronous: see wgmma_commit and wgmma_wait.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Orders this warpgroup's register and shared-memory accesses before the wgmmas after it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to an accumulator across a wgmma boundary.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// Makes this thread's generic-proxy writes to shared memory (st.shared, cp.async)
// visible to the async proxy through which wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 8 bytes of b as exact floats minus `base`: a byte permute puts byte j under the
// exponent of 2^23 (0x4B0000bb is 2^23 + bb), so base 2^23 gives the byte's value.
__device__ __forceinline__ void byte_levels(uint2 b, float base, float q[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    q[j] = __uint_as_float(__byte_perm(j < 4 ? b.x : b.y, 0x4Bu, 0x4550 | (j & 3))) - base;
}

// 16 bytes of x (8 columns from col) into a stage, zero past M (in_rows false) and past
// K. xw is the host's copy width: 16, 8 or 4 bytes by cp.async (2K and the base are
// divisible by it), or 2 for an odd K, whose rows are 2-byte aligned: plain loads.
// `any` is a valid address for the copies that read nothing.
__device__ __forceinline__ void copy_x_chunk(uint8_t* dst, const __nv_bfloat16* src,
                                             const __nv_bfloat16* any, bool in_rows, int col,
                                             int K, int xw) {
  if (xw == 16) {
    const bool v = in_rows && col < K;
    cp_async16_zfill(dst, v ? src : any, v ? 16 : 0);
  } else if (xw == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool v = in_rows && col + 4 * h < K;
      cp_async_ca_zfill<8>(dst + 8 * h, v ? src + 4 * h : any, v ? 8 : 0);
    }
  } else if (xw == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool v = in_rows && col + 2 * h < K;
      cp_async_ca_zfill<4>(dst + 4 * h, v ? src + 2 * h : any, v ? 4 : 0);
    }
  } else {
    uint32_t e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = (in_rows && col + i < K) ? __ldg(reinterpret_cast<const unsigned short*>(src) + i)
                                      : 0u;
    *reinterpret_cast<uint4*>(dst) = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                                                e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
}

// ROWS stored rows of one packed plane from row0, columns n0..n0+BN-1, into a stage,
// zero past the stored rows and past N. ww: 16, 8 or 4-byte cp.async (N and the base
// divisible by it), or 1 when N % 4 != 0: byte loads.
template <int BN, int ROWS, int THREADS>
__device__ __forceinline__ void copy_plane(uint8_t* dst, const uint8_t* src, int row0,
                                           int stored, int n0, int N, int ww) {
  constexpr int LOG_BN = BN == 128 ? 7 : 6;
  const uint8_t* base = src + (size_t)row0 * N + n0;
  if (ww == 1) {
    for (int i = threadIdx.x; i < ROWS * BN; i += THREADS) {
      const int r = i >> LOG_BN, c = i & (BN - 1);
      const bool v = row0 + r < stored && n0 + c < N;
      dst[i] = v ? __ldg(base + r * N + c) : 0;
    }
    return;
  }
  const int shift = ww == 16 ? 4 : ww == 8 ? 3 : 2;  // log2(ww)
  for (int i = threadIdx.x; i < (ROWS * BN) >> shift; i += THREADS) {
    const int r = i >> (LOG_BN - shift), c = (i << shift) & (BN - 1);
    const bool v = row0 + r < stored && n0 + c < N;
    const uint8_t* s = v ? base + r * N + c : src;
    uint8_t* d = dst + r * BN + c;
    if (ww == 16) cp_async16_zfill(d, s, v ? 16 : 0);
    else if (ww == 8) cp_async_ca_zfill<8>(d, s, v ? 8 : 0);
    else cp_async_ca_zfill<4>(d, s, v ? 4 : 0);
  }
}

// Scale and zero row g, columns n0..n0+BN-1 (zero past N), into dst[0, BN) and
// dst[BN, 2 BN). sw: 16 (N % 4 == 0, 16-byte aligned bases) or 4.
template <int BN, int THREADS>
__device__ __forceinline__ void copy_group(float* dst, const float* scales, const float* zeros,
                                           int g, int n0, int N, int sw) {
  const size_t off = (size_t)g * N + n0;
  if (sw == 16) {
    const int i = threadIdx.x;  // BN / 4 chunks of each row
    if (i < BN / 2) {
      const int which = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const float* src = which ? zeros : scales;
      const bool v = n0 + c < N;
      cp_async16_zfill(dst + which * BN + c, v ? src + off + c : src, v ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * BN; i += THREADS) {
    const int which = i / BN, c = i % BN;
    const float* src = which ? zeros : scales;
    const bool v = n0 + c < N;
    cp_async_ca_zfill<4>(dst + i, v ? src + off + c : src, v ? 4 : 0);
  }
}

// K-row r, columns c..c+7 of a B buffer: (q - z) * s in f32, rounded to bf16.
__device__ __forceinline__ void store_b_row(uint8_t* b, int r, int c, const float q[8],
                                            const float s[8], const float z[8]) {
  uint4 v;
  v.x = pack_bf16x2((q[0] - z[0]) * s[0], (q[1] - z[1]) * s[1]);
  v.y = pack_bf16x2((q[2] - z[2]) * s[2], (q[3] - z[3]) * s[3]);
  v.z = pack_bf16x2((q[4] - z[4]) * s[4], (q[5] - z[5]) * s[5]);
  v.w = pack_bf16x2((q[6] - z[6]) * s[6], (q[7] - z[7]) * s[7]);
  *reinterpret_cast<uint4*>(b + b_off(r, c)) = v;
}

// The GEMM: a ring of STAGES k-tiles in dynamic shared memory, filled by cp.async, and
// two bf16 B buffers. Iteration kt waits for tile kt+1, fences its shared-memory writes
// to the async proxy and passes the one barrier of the tile (after it tile kt+1 has
// landed for every thread, tile kt is decoded, and tile kt-1's stage and B buffer are
// free). Each warpgroup then issues the four wgmma k-steps of tile kt on its 64 rows
// and, while the tensor cores run them, the block copies tile kt+3 and decodes tile
// kt+1 into the other B buffer; the wgmmas are waited for before the loop turns. The
// tiles cover K (not Kp): past K the activations are zero.
template <class Fmt, int BN>
__global__ void __launch_bounds__(THREADS, GemmPlan<Fmt, BN>::BLOCKS_PER_SM)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                const uint8_t* __restrict__ qh, const float* __restrict__ scales,
                const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out, int M, int K,
                int Kp, int N, int G, int xw, int ww, int sw) {
  using P = GemmPlan<Fmt, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (-smem_addr(smem_raw) & (SW128_ATOM - 1));
  uint8_t* bbuf = smem + P::STAGES * P::STAGE_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63 of the block
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gsz = (Kp + G - 1) / G;
  const int n_tiles = (K + BK - 1) / BK;
  auto stage = [&](int t) { return smem + (t % P::STAGES) * P::STAGE_BYTES; };

  // this thread's x chunks: rows xr + XR i of the block, columns xc..xc+7 of a tile
  constexpr int XR = THREADS / 8;
  const int xr = tid >> 3, xc = 8 * (tid & 7);
  const __nv_bfloat16* xsrc = x + (size_t)(m0 + xr) * K + xc;
  const size_t x_step = (size_t)XR * K;
  const int xdst = swz(xr, tid & 7, BK * 2);  // rows xr + XR i share the swizzle
  // the copies of tile t: x chunks, the packed rows and the scales
  auto fetch = [&](int t) {
    uint8_t* st = stage(t);
    const int k0 = t * BK;
#pragma unroll
    for (int p = 0; p < P::X_CHUNKS; ++p)
      copy_x_chunk(st + xdst + p * XR * BK * 2, xsrc + p * x_step + k0, x,
                   m0 + xr + XR * p < M, xc + k0, K, xw);
    uint8_t* w = st + P::A_BYTES;
    copy_plane<BN, P::W_ROWS0, THREADS>(w, qw, k0 / Fmt::RPB0, Kp / Fmt::RPB0, n0, N, ww);
    if constexpr (Fmt::RPB1 != 0)
      copy_plane<BN, BK / Fmt::RPB1, THREADS>(w + P::W_ROWS0 * BN, qh, k0 / Fmt::RPB1,
                                              Kp / Fmt::RPB1, n0, N, ww);
    copy_group<BN, THREADS>(reinterpret_cast<float*>(w + P::W_BYTES), scales, zeros, k0 / gsz,
                            n0, N, sw);
  };

  // this thread's decode: K-rows r0.. r0+DR-1 of a tile, columns dc..dc+7. When the
  // tile's K-rows below K lie in one group, s and z come from its stage; when a group
  // boundary falls inside the tile, each row reads its own group's (the _expand_tiles
  // rule) through the cache. Rows past K meet zero activations and only have to be
  // finite.
  const int dc = (tid % (BN / 8)) * 8, r0 = (tid / (BN / 8)) * P::DR;
  auto decode_tile = [&](int t) {
    const int k0 = t * BK;
    const uint8_t* st = stage(t);
    uint8_t* b = bbuf + (t & 1) * P::B_BYTES;
    if ((min(k0 + BK, K) - 1) / gsz == k0 / gsz) {
      const float* sz = reinterpret_cast<const float*>(st + P::A_BYTES + P::W_BYTES);
      float s[8], z[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 sv = *reinterpret_cast<const float4*>(sz + dc + 4 * h);
        const float4 zv = *reinterpret_cast<const float4*>(sz + BN + dc + 4 * h);
        s[4 * h] = sv.x; s[4 * h + 1] = sv.y; s[4 * h + 2] = sv.z; s[4 * h + 3] = sv.w;
        z[4 * h] = zv.x; z[4 * h + 1] = zv.y; z[4 * h + 2] = zv.z; z[4 * h + 3] = zv.w;
      }
#pragma unroll
      for (int i = 0; i < P::DR; ++i) {
        float q[8];
        Fmt::template tile_levels<BN>(st + P::A_BYTES, r0 + i, dc, q);
        store_b_row(b, r0 + i, dc, q, s, z);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < P::DR; ++i) {
      const int r = r0 + i;
      float q[8], rs[8], rz[8];
      Fmt::template tile_levels<BN>(st + P::A_BYTES, r, dc, q);
      const size_t off = (size_t)(min(k0 + r, K - 1) / gsz) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + dc + j;
        rs[j] = n < N ? __ldg(scales + off + n) : 0.f;
        rz[j] = n < N ? __ldg(zeros + off + n) : 0.f;
      }
      store_b_row(b, r, dc, q, rs, rz);
    }
  };

  float acc[P::ACC];
#pragma unroll
  for (int e = 0; e < P::ACC; ++e) acc[e] = 0.f;

  for (int t = 0; t < P::STAGES - 1; ++t) {  // one commit group per tile, empty past the last
    if (t < n_tiles) fetch(t);
    cp_async_commit();
  }
  cp_async_wait<P::STAGES - 2>();
  __syncthreads();
  decode_tile(0);

  // A: this warpgroup's 64 rows of a stage, K-major: 8-row groups 1024 bytes apart, a
  // k-step 32 bytes on. B: MN-major, panels B_PANEL apart, 8-row groups 1024 bytes
  // apart, a k-step 16 rows (2048 bytes) on.
  const uint32_t a_base = smem_addr(smem) + wg * 64 * BK * 2;
  const uint32_t b_base = smem_addr(bbuf);
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<P::STAGES - 3>();  // tile kt+1 has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();
    const int tf = kt + P::STAGES - 1;  // fetched into tile kt-1's stage
    const uint32_t a_s = a_base + (kt % P::STAGES) * P::STAGE_BYTES;
    const uint32_t b_s = b_base + (kt & 1) * P::B_BYTES;
#pragma unroll
    for (int e = 0; e < P::ACC; ++e) fence_operand(acc[e]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_bf16<BN>(acc, sw128_desc(a_s + 32 * ks, 16, SW128_ATOM),
                     sw128_desc(b_s + 2048 * ks, B_PANEL, SW128_ATOM));
    wgmma_commit();
    if (tf < n_tiles) fetch(tf);
    if (kt + 1 < n_tiles) decode_tile(kt + 1);
    cp_async_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < P::ACC; ++e) fence_operand(acc[e]);
  }
  cp_async_wait<0>();  // only empty groups are left; none stays in flight at exit

  // ---- epilogue: f32 accumulators -> bf16, two columns a store when N is even
  const bool pairs = (N & 1) == 0;
  const int row0 = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      __nv_bfloat16* p = out + (size_t)row * N + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
      } else {
        p[0] = __float2bfloat16_rn(v0);
        if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <class Fmt, int BN>
cudaError_t launch_gemm_bn(const __nv_bfloat16* x, const uint8_t* qw, const uint8_t* qh,
                           const float* s, const float* z, __nv_bfloat16* out, int M, int K,
                           int Kp, int N, int G, int xw, int ww, int sw, cudaStream_t stream) {
  using P = GemmPlan<Fmt, BN>;
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};  // the opt-in above 48 KB, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(qmm_gemm_kernel<Fmt, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_gemm_kernel<Fmt, BN><<<grid, THREADS, P::SMEM, stream>>>(x, qw, qh, s, z, out, M, K,
                                                                     Kp, N, G, xw, ww, sw);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// bn (64 or 128) and the copy widths xw (x), ww (packed rows) and sw (scales, zeros)
// come from the wrapper's plan (gemm_plan in ops/cuda/quant_matmul.py); a width that
// the pitches or the pointers cannot take is refused.
template <class Fmt>
cudaError_t launch_gemm(const void* x, const void* qweight, const void* qweight_hi,
                        const void* scales, const void* zeros, void* out, int M, int K, int Kp,
                        int N, int G, int bn, int xw, int ww, int sw, void* stream) {
  const bool x_ok = xw == 2 || ((xw == 4 || xw == 8 || xw == 16) && (2 * K) % xw == 0 &&
                                aligned_to(x, xw));
  const bool w_ok = ww == 1 || ((ww == 4 || ww == 8 || ww == 16) && N % ww == 0 &&
                                aligned_to(qweight, ww) &&
                                (qweight_hi == nullptr || aligned_to(qweight_hi, ww)));
  const bool s_ok =
      sw == 4 || (sw == 16 && N % 4 == 0 && aligned_to(scales, 16) && aligned_to(zeros, 16));
  if (!x_ok || !w_ok || !s_ok || (bn != 64 && bn != 128)) return cudaErrorInvalidValue;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qw = static_cast<const uint8_t*>(qweight);
  auto qh = static_cast<const uint8_t*>(qweight_hi);
  auto s = static_cast<const float*>(scales);
  auto z = static_cast<const float*>(zeros);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return bn == 128
             ? launch_gemm_bn<Fmt, 128>(xb, qw, qh, s, z, o, M, K, Kp, N, G, xw, ww, sw, st)
             : launch_gemm_bn<Fmt, 64>(xb, qw, qh, s, z, o, M, K, Kp, N, G, xw, ww, sw, st);
}

}  // namespace qmm
