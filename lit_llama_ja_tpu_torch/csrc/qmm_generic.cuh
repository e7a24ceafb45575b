// Dequant-matmul kernels for Hopper (sm_90a), generic over the weight's pack format:
// y = x @ dequant(W), bf16 x and y, f32 dequant (q - zero) * scale, f32 accumulation.
// Included by quant_matmul_int8.cu (K3) and quant_matmul_sub4.cu (K4, K5), which each
// define the decoders of their formats and their C entry points.
//
// The weight is stored K-major as in lit_llama_ja_tpu/quant/linear.py: Kp stored
// K-rows (Kp = K for int8, the padded K for int2/int3), scales and zeros (G, N) f32,
// and K-row k reads scale row k / ceil(Kp / G) (the _expand_tiles rule). x has K
// columns and is read as zero past them, so the pad rows of a sub-4-bit pack, which
// hold level 0, contribute nothing and no padded copy of x is made.
//
// A decoder (Fmt) tells the kernels how to fetch and decode its bytes:
//   GEMV: a "unit" is Fmt::U consecutive K-rows x 4 adjacent columns of one lane;
//     Fmt::Unit, Fmt::load_unit(u, qw, qh, unit, n0, N, K, vec), Fmt::level(u, row, col).
//   No load reads past the stored rows; the GEMV stops at K-row K, and past K the
//   GEMM's activations are zero.
//   GEMM: a k-tile's packed rows are copied as stored into shared memory (Fmt::RPB0
//     K-rows per stored row of qweight, Fmt::RPB1 per row of qweight_hi, 0 for none),
//     and Fmt::tile_levels<BN>(w, r, c, q) decodes the 8 levels of K-row r, columns
//     c..c+7, from there.
//
// What bounds these kernels on an H100, and what the design does about it:
//   * Decode (M <= 16) is bound by the weight bytes: 1, 3/8 or 1/4 byte per weight
//     against 2*M flops. qmm_gemv_kernel streams the packed bytes once, coalesced (a
//     warp reads 128 adjacent columns of a packed row, 4 bytes a lane, Fmt::UNROLL
//     units in flight per lane), and applies the zero point as a per-group rank-1
//     correction s*(sum x*q - z*sum x), so the inner loop is a decode and one FMA per
//     weight and row. K is split across blocks (grid.y) so that N = 4096 fills the
//     132 SMs; a second small kernel sums the f32 partials.
//   * Prefill (M > 16) is bound by tensor-core flops from M = 64 on: 2 M flops per
//     weight against at most a byte of it and 4 M bytes of x and y per K-row and
//     column pair, past the H100's 295 flops a byte. qmm_gemm_kernel computes one
//     128 x BN output block with 8 warps of mma.sync m16n8k16 bf16 -> f32:
//       - a ring of 4 stages in dynamic shared memory, filled by cp.async and
//         zero-filled by it past M, N, K and the stored rows: the x tile (128 x 64), the
//         tile's packed bytes as stored (8, 3 or 2 KB at BN = 128) and its group's scale
//         and zero rows. Two tiles are in flight while one multiplies, and one barrier
//         passes per 64-deep tile;
//       - the block decodes tile k+1 from its stage into the second of two bf16 B
//         buffers while tile k multiplies, (q - z) * s in f32 rounded to bf16 as the
//         plain version does, a row per k-step;
//       - A fragments by ldmatrix.x4, B by ldmatrix.x4.trans, from 16-byte chunks
//         XOR-swizzled by row, so neither the fragment reads nor the decoder's 16-byte
//         stores conflict on banks;
//       - BN = 128 (64 x 32 warp tiles, about 180-210 registers a thread: one block an
//         SM), or BN = 64 where 128-wide tiles would launch fewer blocks than the card
//         has SMs (32 x 32 warp tiles, 128 registers: two blocks an SM). At the 7B
//         prefill's M = 512, N = 4096 launches 256 blocks instead of 128; the 125M's
//         N = 780 at M = 2048 208 instead of 112.
//     The host picks the copy widths (gemm_plan, ops/cuda/quant_matmul.py): x rows lie
//     2K bytes apart, so 16-, 8- or 4-byte copies as K and the base allow, and an odd K
//     takes plain 2-byte loads into the stage; packed rows lie N bytes apart, so 16-,
//     8- or 4-byte copies, and byte loads when N % 4 != 0; scales 16 or 4. No layer
//     view the wrapper accepts is refused.
//     What holds it at about 13% of the bf16 peak on an H100: the copies, the decode and
//     the mma.sync of a tile add up instead of overlapping. Taking any one of them out
//     (ops/cuda/gemm_probe.py) saves about its own time, and 6 stages or 16 warps an SM
//     change nothing, so the limit is the instruction slots and register bandwidth that
//     mma.sync shares with the decode in the same warps, not latency. Left for wgmma:
//     Hopper's warpgroup product reads its operands from shared memory, and with TMA
//     and mbarriers feeding it, and the decode in warps of its own, the three can
//     overlap.
#pragma once
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

// 4 bytes (4 columns n0..n0+3 of one packed row), zero past N.
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row, int n0, int N,
                                          bool vec) {
  if (vec) return n0 < N ? __ldg(reinterpret_cast<const uint32_t*>(row + n0)) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) w |= (uint32_t)__ldg(row + n0 + c) << (8 * c);
  return w;
}

__device__ __forceinline__ void load_f4(const float* __restrict__ p, int n0, int N, bool vec,
                                        float out[4]) {
  if (vec && n0 < N) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p + n0));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = (n0 + c < N) ? __ldg(p + n0 + c) : 0.f;
}

// ---------------------------------------------------------------------------
// Decode: split-K GEMV for M <= 16
// ---------------------------------------------------------------------------

constexpr int GEMV_WARPS = 4;
constexpr int GEMV_COLS = 128;  // 32 lanes x 4 columns

// One block: 128 output columns x one K split of `units_per_split` units. Each of its
// 4 warps takes a contiguous quarter of the split; partial sums meet in shared memory.
template <class Fmt, int MT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                const uint8_t* __restrict__ qh, const float* __restrict__ scales,
                const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out,
                float* __restrict__ ws, int M, int K, int Kp, int N, int G,
                int units_per_split) {
  constexpr int U = Fmt::U;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GEMV_COLS + lane * 4;
  const bool vec = (N & 3) == 0;
  const int n_units = (min(K, Kp) + U - 1) / U;  // units past K meet zero activations
  const int split_begin = blockIdx.y * units_per_split;
  const int split_end = min(n_units, split_begin + units_per_split);
  const int per_warp = (split_end - split_begin + GEMV_WARPS - 1) / GEMV_WARPS;
  const int rb = min(split_end, split_begin + warp * per_warp);
  const int re = min(split_end, rb + per_warp);
  const int gsz = (Kp + G - 1) / G;  // K-rows per scale group

  float y[MT][4], acc[MT][4], xs[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    xs[m] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) y[m][c] = acc[m][c] = 0.f;
  }
  int g = (rb * U) / gsz;
  int next_group_k = (g + 1) * gsz;

  // y += s * (sum x*q - z * sum x) for the group just finished; start the next one
  auto flush = [&]() {
    float s[4], z[4];
    load_f4(scales + (size_t)g * N, n0, N, vec, s);
    load_f4(zeros + (size_t)g * N, n0, N, vec, z);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[m][c] += s[c] * (acc[m][c] - z[c] * xs[m]);
        acc[m][c] = 0.f;
      }
      xs[m] = 0.f;
    }
  };

  for (int r = rb; r < re; r += Fmt::UNROLL) {
    typename Fmt::Unit w[Fmt::UNROLL];
#pragma unroll
    for (int i = 0; i < Fmt::UNROLL; ++i)
      if (r + i < re) Fmt::load_unit(w[i], qw, qh, r + i, n0, N, K, vec);
#pragma unroll
    for (int i = 0; i < Fmt::UNROLL; ++i) {
      if (r + i >= re) break;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = (r + i) * U + u;
        if (k >= K) break;
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = m < M ? __bfloat162float(x[(size_t)m * K + k]) : 0.f;
        if (k >= next_group_k) { flush(); ++g; next_group_k += gsz; }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float q = Fmt::level(w[i], u, c);
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], q, acc[m][c]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) xs[m] += xv[m];
      }
    }
  }
  if (rb < re) flush();

  __shared__ float red[GEMV_WARPS - 1][MT][GEMV_COLS];
  if (warp > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp - 1][m][lane * 4 + c] = y[m][c];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + c;
      if (n >= N) continue;
      float v = y[m][c];
#pragma unroll
      for (int w2 = 0; w2 < GEMV_WARPS - 1; ++w2) v += red[w2][m][lane * 4 + c];
      if (gridDim.y == 1)
        out[(size_t)m * N + n] = __float2bfloat16_rn(v);
      else
        ws[((size_t)blockIdx.y * M + m) * N + n] = v;
    }
  }
}

// out[i] = bf16(sum over splits of ws[split][i])
__global__ void qmm_splitk_reduce_kernel(const float* __restrict__ ws,
                                         __nv_bfloat16* __restrict__ out, int ksplit, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < ksplit; ++s) v += ws[(size_t)s * MN + i];
  out[i] = __float2bfloat16_rn(v);
}

template <class Fmt, int MT>
cudaError_t launch_gemv_mt(const __nv_bfloat16* x, const uint8_t* qw, const uint8_t* qh,
                           const float* s, const float* z, __nv_bfloat16* out, float* ws,
                           int M, int K, int Kp, int N, int G, int ksplit, int units,
                           cudaStream_t stream) {
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, ksplit);
  qmm_gemv_kernel<Fmt, MT><<<grid, GEMV_WARPS * 32, 0, stream>>>(x, qw, qh, s, z, out, ws, M, K,
                                                                 Kp, N, G, units);
  return cudaGetLastError();
}

// ws is (ksplit, M, N) f32 scratch when ksplit > 1; units = Fmt::U-row units per split.
template <class Fmt>
cudaError_t launch_gemv(const void* x, const void* qweight, const void* qweight_hi,
                        const void* scales, const void* zeros, void* out, void* ws, int M,
                        int K, int Kp, int N, int G, int ksplit, int units, void* stream) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qw = static_cast<const uint8_t*>(qweight);
  auto qh = static_cast<const uint8_t*>(qweight_hi);
  auto s = static_cast<const float*>(scales);
  auto z = static_cast<const float*>(zeros);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto w = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 1) err = launch_gemv_mt<Fmt, 1>(xb, qw, qh, s, z, o, w, M, K, Kp, N, G, ksplit, units, st);
  else if (M <= 2) err = launch_gemv_mt<Fmt, 2>(xb, qw, qh, s, z, o, w, M, K, Kp, N, G, ksplit, units, st);
  else if (M <= 4) err = launch_gemv_mt<Fmt, 4>(xb, qw, qh, s, z, o, w, M, K, Kp, N, G, ksplit, units, st);
  else if (M <= 8) err = launch_gemv_mt<Fmt, 8>(xb, qw, qh, s, z, o, w, M, K, Kp, N, G, ksplit, units, st);
  else if (M <= 16) err = launch_gemv_mt<Fmt, 16>(xb, qw, qh, s, z, o, w, M, K, Kp, N, G, ksplit, units, st);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess || ksplit == 1) return err;
  const int MN = M * N;
  qmm_splitk_reduce_kernel<<<(MN + 255) / 256, 256, 0, st>>>(w, o, ksplit, MN);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Prefill: tensor-core GEMM for M > 16
// ---------------------------------------------------------------------------

constexpr int BM = 128;            // rows of x per block
constexpr int BK = 64;             // K-rows per k-tile
constexpr int KS = BK / 16;        // mma k-steps per tile
constexpr int TWO_BLOCKS_SMEM = 113 * 1024;  // per block, when two blocks share an SM

constexpr int plane_rows(int rpb) { return rpb ? BK / rpb : 0; }

// The shared memory of one instantiation. A stage holds one k-tile as it arrives: the
// x tile (BM x BK bf16), the tile's packed rows as stored (BK / RPB0 rows of qweight,
// then BK / RPB1 of qweight_hi, BN bytes each) and the scale and zero rows of the group
// of its first K-row (BN f32 each). Two B buffers hold decoded tiles (BK x BN bf16).
// The 8 warps tile the block's BM x BN outputs WARPS_M x WARPS_N: 64 x 32 warp tiles
// at BN = 128, which need more than 128 registers a thread, so that block runs alone
// on an SM; 32 x 32 at BN = 64, two blocks an SM.
template <class Fmt, int BN>
struct GemmPlan {
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static constexpr int WARPS_M = BN == 64 ? 4 : 2, WARPS_N = BN == 64 ? 2 : 4;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BLOCKS_PER_SM = THREADS == 256 && BN == 64 ? 2 : 1;
  static constexpr int WM = BM / WARPS_M;  // output rows per warp
  static constexpr int MI = WM / 16;       // m16 mma tiles per warp
  static constexpr int WN = BN / WARPS_N;  // output columns per warp
  static constexpr int NJ = WN / 8;        // n8 mma tiles per warp
  static_assert(NJ % 2 == 0, "B fragments come two n8 tiles at a time");
  static constexpr int X_CHUNKS = BM * (BK / 8) / THREADS;  // 16-byte x chunks a thread copies
  static constexpr int DR = BK * (BN / 8) / THREADS;  // K-rows a thread decodes, 8 columns each
  static_assert(X_CHUNKS <= KS && KS % DR == 0, "spread over the k-steps");
  static constexpr int DECODE_EVERY = KS / DR;  // k-steps between two of its rows
  static constexpr int STAGES = 4;  // k-tiles in the ring
  static constexpr int W_ROWS0 = plane_rows(Fmt::RPB0);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = (W_ROWS0 + plane_rows(Fmt::RPB1)) * BN;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES + 2 * BN * 4;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * B_BYTES;
  static_assert(BLOCKS_PER_SM == 1 || SMEM <= TWO_BLOCKS_SMEM, "two blocks must fit an SM");
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of row_bytes rows. The
// chunk index is XORed with the row's low three bits, so the eight rows that one
// ldmatrix phase (or eight lanes' 16-byte stores) touch fall in eight bank groups.
__device__ __forceinline__ int swz(int row, int chunk, int row_bytes) {
  return row * row_bytes + ((chunk ^ (row & 7)) << 4);
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

// Row r (columns c..c+7) of a B buffer: (q - z) * s in f32, rounded to bf16.
__device__ __forceinline__ void store_b_row(uint8_t* b, int r, int c, int row_bytes,
                                            const float q[8], const float s[8],
                                            const float z[8]) {
  uint4 v;
  v.x = pack_bf16x2((q[0] - z[0]) * s[0], (q[1] - z[1]) * s[1]);
  v.y = pack_bf16x2((q[2] - z[2]) * s[2], (q[3] - z[3]) * s[3]);
  v.z = pack_bf16x2((q[4] - z[4]) * s[4], (q[5] - z[5]) * s[5]);
  v.w = pack_bf16x2((q[6] - z[6]) * s[6], (q[7] - z[7]) * s[7]);
  *reinterpret_cast<uint4*>(b + swz(r, c >> 3, row_bytes)) = v;
}

// The GEMM: a ring of STAGES k-tiles in dynamic shared memory, filled by cp.async, and
// two bf16 B buffers. Iteration kt waits for tile kt+1, passes the one barrier of the
// tile (after it tile kt+1 has landed for every thread, tile kt is decoded, and tile
// kt-1's stage and B buffer are free), then runs the four k-steps of tile kt with a
// share of the other work between them: a quarter of the copies of tile kt+3 and a
// row of the decode of tile kt+1 into the other B buffer. Spread so, each warp's copy
// and decode instructions interleave with its mma.sync. The tiles cover K (not Kp):
// past K the activations are zero.
template <class Fmt, int BN>
__global__ void __launch_bounds__(GemmPlan<Fmt, BN>::THREADS, GemmPlan<Fmt, BN>::BLOCKS_PER_SM)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                const uint8_t* __restrict__ qh, const float* __restrict__ scales,
                const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out, int M, int K,
                int Kp, int N, int G, int xw, int ww, int sw) {
  using P = GemmPlan<Fmt, BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bbuf = smem + P::STAGES * P::STAGE_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int wm = warp / P::WARPS_N, wn = warp % P::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gsz = (Kp + G - 1) / G;
  const int n_tiles = (K + BK - 1) / BK;
  auto stage = [&](int t) { return smem + (t % P::STAGES) * P::STAGE_BYTES; };

  // this thread's x chunks: rows xr + XR i of the block, columns xc..xc+7 of a tile
  constexpr int XR = P::THREADS / 8;
  const int xr = tid >> 3, xc = 8 * (tid & 7);
  const __nv_bfloat16* xsrc = x + (size_t)(m0 + xr) * K + xc;
  const size_t x_step = (size_t)XR * K;
  const int xdst = swz(xr, tid & 7, BK * 2);  // rows xr + XR i share the swizzle
  // part p of the copies of tile t: x chunk p; part 0 also the packed rows and scales
  auto fetch = [&](int t, int p) {
    uint8_t* st = stage(t);
    const int k0 = t * BK;
    if (p < P::X_CHUNKS)
      copy_x_chunk(st + xdst + p * XR * BK * 2, xsrc + p * x_step + k0, x,
                   m0 + xr + XR * p < M, xc + k0, K, xw);
    if (p != 0) return;
    uint8_t* w = st + P::A_BYTES;
    copy_plane<BN, P::W_ROWS0, P::THREADS>(w, qw, k0 / Fmt::RPB0, Kp / Fmt::RPB0, n0, N, ww);
    if constexpr (Fmt::RPB1 != 0)
      copy_plane<BN, BK / Fmt::RPB1, P::THREADS>(w + P::W_ROWS0 * BN, qh, k0 / Fmt::RPB1,
                                                 Kp / Fmt::RPB1, n0, N, ww);
    copy_group<BN, P::THREADS>(reinterpret_cast<float*>(w + P::W_BYTES), scales, zeros,
                               k0 / gsz, n0, N, sw);
  };

  // this thread's decode: K-rows r0.. r0+DR-1 of a tile, columns dc..dc+7. When the
  // tile's K-rows below K lie in one group, s and z come from its stage; when a group
  // boundary falls inside the tile, each row reads its own group's (the _expand_tiles
  // rule) through the cache. Rows past K meet zero activations and only have to be
  // finite.
  const int dc = (tid % (BN / 8)) * 8, r0 = (tid / (BN / 8)) * P::DR;
  float s[8], z[8];
  bool per_row = false;
  auto decode_scales = [&](int t) {
    const int k0 = t * BK;
    per_row = (min(k0 + BK, K) - 1) / gsz != k0 / gsz;
    if (per_row) return;
    const float* sz = reinterpret_cast<const float*>(stage(t) + P::A_BYTES + P::W_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 sv = *reinterpret_cast<const float4*>(sz + dc + 4 * h);
      const float4 zv = *reinterpret_cast<const float4*>(sz + BN + dc + 4 * h);
      s[4 * h] = sv.x; s[4 * h + 1] = sv.y; s[4 * h + 2] = sv.z; s[4 * h + 3] = sv.w;
      z[4 * h] = zv.x; z[4 * h + 1] = zv.y; z[4 * h + 2] = zv.z; z[4 * h + 3] = zv.w;
    }
  };
  auto decode_row = [&](int t, int i) {  // row r0 + i of tile t
    const int r = r0 + i;
    float q[8];
    Fmt::template tile_levels<BN>(stage(t) + P::A_BYTES, r, dc, q);
    uint8_t* b = bbuf + (t & 1) * P::B_BYTES;
    if (!per_row) {
      store_b_row(b, r, dc, BN * 2, q, s, z);
      return;
    }
    const size_t off = (size_t)(min(t * BK + r, K - 1) / gsz) * N;
    float rs[8], rz[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + dc + j;
      rs[j] = n < N ? __ldg(scales + off + n) : 0.f;
      rz[j] = n < N ? __ldg(zeros + off + n) : 0.f;
    }
    store_b_row(b, r, dc, BN * 2, q, rs, rz);
  };

  float acc[P::MI][P::NJ][4];
#pragma unroll
  for (int i = 0; i < P::MI; ++i)
#pragma unroll
    for (int j = 0; j < P::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < P::STAGES - 1; ++t) {  // one commit group per tile, empty past the last
    if (t < n_tiles) {
#pragma unroll
      for (int p = 0; p < KS; ++p) fetch(t, p);
    }
    cp_async_commit();
  }
  cp_async_wait<P::STAGES - 2>();
  __syncthreads();
  decode_scales(0);
#pragma unroll
  for (int i = 0; i < P::DR; ++i) decode_row(0, i);

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<P::STAGES - 3>();  // tile kt+1 has landed (this thread's copies)
    __syncthreads();
    const int tf = kt + P::STAGES - 1;  // fetched into tile kt-1's stage
    const bool fetching = tf < n_tiles, decoding = kt + 1 < n_tiles;
    const uint32_t a_s = smem_addr(stage(kt));
    const uint32_t b_s = smem_addr(bbuf + (kt & 1) * P::B_BYTES);
    if (decoding) decode_scales(kt + 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (fetching) fetch(tf, ks);
      if (decoding && ks % P::DECODE_EVERY == 0) decode_row(kt + 1, ks / P::DECODE_EVERY);
      uint32_t a[P::MI][4], b[P::NJ][2];
#pragma unroll
      for (int i = 0; i < P::MI; ++i)  // lanes 0-15: rows, k 0-7; lanes 16-31: rows, k 8-15
        ldmatrix_x4(a[i], a_s + swz(wm * P::WM + i * 16 + (lane & 15), 2 * ks + (lane >> 4),
                                    BK * 2));
#pragma unroll
      for (int jp = 0; jp < P::NJ / 2; ++jp) {  // two n8 tiles: k 0-7 / 8-15 of each
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + swz(ks * 16 + (lane & 15),
                                       (wn * P::WN + jp * 16) / 8 + (lane >> 4), BN * 2));
        b[2 * jp][0] = r[0]; b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2]; b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < P::MI; ++i)
#pragma unroll
        for (int j = 0; j < P::NJ; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();  // only empty groups are left; none stays in flight at exit

  // ---- epilogue: f32 accumulators -> bf16, two columns a store when N is even
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < P::MI; ++i) {
#pragma unroll
    for (int j = 0; j < P::NJ; ++j) {
      const int col = n0 + wn * P::WN + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * P::WM + i * 16 + gq + 8 * h;
        if (row >= M || col >= N) continue;
        __nv_bfloat16* p = out + (size_t)row * N + col;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          p[0] = __float2bfloat16_rn(acc[i][j][2 * h]);
          if (col + 1 < N) p[1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        }
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
  qmm_gemm_kernel<Fmt, BN><<<grid, P::THREADS, P::SMEM, stream>>>(x, qw, qh, s, z, out, M, K,
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
