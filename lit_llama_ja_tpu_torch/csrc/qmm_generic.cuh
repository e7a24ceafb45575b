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
//   GEMM: a thread dequantizes K-rows k and k+1 (k even) x 8 adjacent columns;
//     Fmt::Pair, Fmt::load_pair(p, qw, qh, k, n, K, N, nvec), Fmt::pair_level(p, col, e).
//
// What bounds these kernels on an H100, and what the design does about it:
//   * Decode (M <= 16) is bound by the weight bytes: 1, 3/8 or 1/4 byte per weight
//     against 2*M flops. qmm_gemv_kernel streams the packed bytes once, coalesced (a
//     warp reads 128 adjacent columns of a packed row, 4 bytes a lane, Fmt::UNROLL
//     units in flight per lane), and applies the zero point as a per-group rank-1
//     correction s*(sum x*q - z*sum x), so the inner loop is a decode and one FMA per
//     weight and row. K is split across blocks (grid.y) so that N = 4096 fills the
//     132 SMs; a second small kernel sums the f32 partials.
//   * Prefill (M > 16) is bound by tensor-core flops. qmm_gemm_kernel dequantizes a
//     32 x 128 weight tile into shared memory as bf16 (the rounding of the plain
//     version, which casts the f32 dequantized weight to bf16) and multiplies a
//     128 x 128 output block with mma.sync m16n8k16 bf16 -> f32, double-buffered:
//     the next tile's loads are in flight while the current one multiplies. No
//     cp.async/TMA and no wgmma yet, which later work adds.
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

// 8 bytes (columns n..n+7 of one packed row), zero past N.
__device__ __forceinline__ uint2 load8(const uint8_t* __restrict__ row, int n, int N, bool nvec) {
  uint2 b = make_uint2(0, 0);
  if (nvec) {
    if (n < N) b = __ldg(reinterpret_cast<const uint2*>(row + n));
    return b;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t byte = (n + j < N) ? __ldg(row + n + j) : 0u;
    if (j < 4) b.x |= byte << (8 * j);
    else b.y |= byte << (8 * (j - 4));
  }
  return b;
}

__device__ __forceinline__ uint32_t byte_of(uint2 b, int j) {
  return ((j < 4 ? b.x : b.y) >> (8 * (j & 3))) & 0xFFu;
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

constexpr int BM = 128;   // rows of x per block
constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // K-rows per tile
constexpr int LDS = BK + 8;  // padded shared-memory row, in bf16
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int A_CHUNKS = BM * BK / 8 / GEMM_THREADS;  // 16-byte x chunks per thread

// What one thread fetches from device memory for one k-tile: A_CHUNKS 8-wide chunks
// of x and the weight bytes of its K-row pair x 8 columns.
template <class Fmt>
struct TileRegs {
  uint4 a[A_CHUNKS];
  typename Fmt::Pair b;
};

template <class Fmt>
__device__ __forceinline__ void fetch_tile(TileRegs<Fmt>& t, const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ qw,
                                           const uint8_t* __restrict__ qh, int k0, int m0,
                                           int n0, int M, int K, int N, bool xvec, bool nvec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int chunk = tid + c * GEMM_THREADS;
    const int row = m0 + chunk / (BK / 8), col = k0 + (chunk % (BK / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < M) {
      const __nv_bfloat16* p = x + (size_t)row * K + col;
      if (xvec) {
        if (col < K) v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = (col + e < K) ? __ldg(reinterpret_cast<const uint16_t*>(p) + e) : 0u;
        v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                       h[6] | (h[7] << 16));
      }
    }
    t.a[c] = v;
  }
  Fmt::load_pair(t.b, qw, qh, k0 + 2 * (tid & 15), n0 + (tid >> 4) * 8, K, N, nvec);
}

// The thread's 8 scales and zeros of one group, kept in registers across the tiles
// that group spans.
struct GroupRegs {
  int g = -1;
  float s[8], z[8];
};

__device__ __forceinline__ void load_group(GroupRegs& gr, int g, const float* __restrict__ scales,
                                           const float* __restrict__ zeros, int n, int N,
                                           bool nvec) {
  gr.g = g;
  const float* sp = scales + (size_t)g * N + n;
  const float* zp = zeros + (size_t)g * N + n;
  if (nvec && n < N) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 sv = __ldg(reinterpret_cast<const float4*>(sp) + h);
      const float4 zv = __ldg(reinterpret_cast<const float4*>(zp) + h);
      gr.s[4 * h] = sv.x; gr.s[4 * h + 1] = sv.y; gr.s[4 * h + 2] = sv.z; gr.s[4 * h + 3] = sv.w;
      gr.z[4 * h] = zv.x; gr.z[4 * h + 1] = zv.y; gr.z[4 * h + 2] = zv.z; gr.z[4 * h + 3] = zv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gr.s[j] = (n + j < N) ? __ldg(sp + j) : 0.f;
      gr.z[j] = (n + j < N) ? __ldg(zp + j) : 0.f;
    }
  }
}

// x chunks -> As; weight levels -> dequantized in f32 as (q - z) * s, rounded to bf16
// -> Bs, transposed so that one 32-bit word holds the (k, k+1) pair an mma B fragment
// register wants. Rows past K read level 0 and meet zero activations.
template <class Fmt>
__device__ __forceinline__ void store_tile(const TileRegs<Fmt>& t, GroupRegs& gr,
                                           __nv_bfloat16 (*As)[LDS], uint32_t (*Bs)[LDS / 2],
                                           const float* __restrict__ scales,
                                           const float* __restrict__ zeros, int k0, int n0,
                                           int K, int N, int gsz, bool nvec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int chunk = tid + c * GEMM_THREADS;
    *reinterpret_cast<uint4*>(&As[chunk / (BK / 8)][(chunk % (BK / 8)) * 8]) = t.a[c];
  }
  const int prow = tid & 15, col = (tid >> 4) * 8;
  const int n = n0 + col;
  const int g_first = k0 / gsz, g_last = (min(k0 + BK, K) - 1) / gsz;
  if (g_first == g_last) {  // the whole tile in one group: scales from registers
    if (gr.g != g_first) load_group(gr, g_first, scales, zeros, n, N, nvec);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float we = (Fmt::pair_level(t.b, j, 0) - gr.z[j]) * gr.s[j];
      const float wo = (Fmt::pair_level(t.b, j, 1) - gr.z[j]) * gr.s[j];
      Bs[col + j][prow] = pack_bf16x2(we, wo);
    }
    return;
  }
  // a group boundary inside the tile: per-row groups, as _expand_tiles assigns them
  const int k = k0 + 2 * prow;
  const int ge = k / gsz, go = (k + 1) / gsz;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float we = 0.f, wo = 0.f;
    if (n + j < N) {
      if (k < K) {
        const size_t ie = (size_t)ge * N + n + j;
        we = (Fmt::pair_level(t.b, j, 0) - __ldg(zeros + ie)) * __ldg(scales + ie);
      }
      if (k + 1 < K) {
        const size_t io = (size_t)go * N + n + j;
        wo = (Fmt::pair_level(t.b, j, 1) - __ldg(zeros + io)) * __ldg(scales + io);
      }
    }
    Bs[col + j][prow] = pack_bf16x2(we, wo);
  }
}

// Double-buffered: while the tensor cores multiply tile k out of one shared buffer,
// the loads of tile k+1 are in flight into registers; they are dequantized into the
// other buffer afterwards, and one barrier per tile separates the two. The tiles
// cover K (not Kp): past K the activations are zero.
template <class Fmt>
__global__ void __launch_bounds__(GEMM_THREADS)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                const uint8_t* __restrict__ qh, const float* __restrict__ scales,
                const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out, int M, int K,
                int Kp, int N, int G) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][LDS];
  __shared__ __align__(16) uint32_t Bs[2][BN][LDS / 2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gsz = (Kp + G - 1) / G;
  const bool xvec = (K & 7) == 0;
  const bool nvec = (N & 7) == 0;
  const int n_tiles = (K + BK - 1) / BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  TileRegs<Fmt> t;
  GroupRegs gr;
  fetch_tile<Fmt>(t, x, qw, qh, 0, m0, n0, M, K, N, xvec, nvec);
  store_tile<Fmt>(t, gr, As[0], Bs[0], scales, zeros, 0, n0, K, N, gsz, nvec);
  __syncthreads();

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < n_tiles;
    if (more) fetch_tile<Fmt>(t, x, qw, qh, (kt + 1) * BK, m0, n0, M, K, N, xvec, nvec);

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + gq;
        const int col = ks * 16 + 2 * tq;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[buf][row][col]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[buf][row + 8][col]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[buf][row][col + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[buf][row + 8][col + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ncol = wn * 32 + j * 8 + gq;
        const uint32_t b0 = Bs[buf][ncol][ks * 8 + tq];
        const uint32_t b1 = Bs[buf][ncol][ks * 8 + tq + 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16_16816(acc[i][j], a[i], b0, b1);
      }
    }

    if (more)
      store_tile<Fmt>(t, gr, As[buf ^ 1], Bs[buf ^ 1], scales, zeros, (kt + 1) * BK, n0, K, N,
                      gsz, nvec);
    __syncthreads();
  }

  // ---- epilogue: f32 accumulators -> bf16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + gq + 8 * h;
        if (row >= M) continue;
        __nv_bfloat16* p = out + (size_t)row * N + col;
        if (col < N) p[0] = __float2bfloat16_rn(acc[i][j][2 * h]);
        if (col + 1 < N) p[1] = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <class Fmt>
cudaError_t launch_gemm(const void* x, const void* qweight, const void* qweight_hi,
                        const void* scales, const void* zeros, void* out, int M, int K, int Kp,
                        int N, int G, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_gemm_kernel<Fmt><<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qweight),
      static_cast<const uint8_t*>(qweight_hi), static_cast<const float*>(scales),
      static_cast<const float*>(zeros), static_cast<__nv_bfloat16*>(out), M, K, Kp, N, G);
  return cudaGetLastError();
}

}  // namespace qmm
