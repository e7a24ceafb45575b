// Int4 dequant-matmul for Hopper (sm_90a): y = x @ dequant(W), bf16 x and y.
//
// Replaces: the Pallas kernel lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325
//   quant_matmul_int4 (kernel body _qmm4_kernel :45, tiling _plan_tiles :301), with
//   the numerics of its exact unpack="bf16" path, i.e. x @ dequantize_with_k(...).
//
// Layout (the JAX package's, unchanged): qweight (K/2, N) uint8, byte r holds K-row
//   2r in the low nibble (plain) and K-row 2r+1 in the high nibble stored (q-8)&0xF
//   ("hi-biased-v2"); scales, zeros (G, N) f32, K-row k uses group k / ceil(K/G),
//   as lit_llama_ja_tpu/quant/linear.py:475 _expand_tiles does; w = (q - z) * s.
//
// What bounds it on an H100, and what the design does about it:
//   * Decode (M <= 16) is bound by the weight bytes: 0.5 byte per weight against
//     about 2*M flops. qmm4_gemv_kernel streams the packed bytes once, coalesced
//     (4 bytes per lane, a warp covers 128 columns of one packed row, 8 rows in
//     flight per lane), and applies the zero point as a per-group rank-1 correction
//     s*(sum x*q - z*sum x), so the inner loop is one mask, one add and one FMA per
//     weight and row. K is split across blocks (grid.y) so that even N = 4096
//     fills the 132 SMs; a second small kernel sums the f32 partials.
//   * Prefill (M = prompt length) is bound by tensor-core flops: 2*M*K*N against
//     K*N/2 weight bytes. qmm4_gemm_kernel dequantizes a 32 x 128 weight tile into
//     shared memory as bf16 (the same rounding as the plain version, which casts
//     the f32 dequantized weight to bf16) and multiplies a 128 x 128 output block
//     with mma.sync m16n8k16 bf16 -> f32. Each weight tile is dequantized once per
//     128 rows of x, and the next tile's loads are in flight while the current one
//     multiplies (two shared buffers, one barrier per tile). No cp.async/TMA and
//     no wgmma yet, which later work adds.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

// Exact float of a 4-bit level: 0x4B000000 is 2^23 as a float, so OR-ing a small
// integer into the mantissa and subtracting 2^23 converts it without an I2F.
__device__ __forceinline__ float level_to_float(uint32_t q) {
  return __uint_as_float(0x4B000000u | q) - 8388608.0f;
}

__device__ __forceinline__ uint32_t lo_level(uint32_t byte) { return byte & 0xFu; }
// high nibble is stored (q - 8) & 0xF; adding 8 mod 16 flips bit 3
__device__ __forceinline__ uint32_t hi_level(uint32_t byte) { return ((byte >> 4) & 0xFu) ^ 0x8u; }

// ---------------------------------------------------------------------------
// Decode: split-K GEMV for M <= 16
// ---------------------------------------------------------------------------

constexpr int GEMV_WARPS = 4;
constexpr int GEMV_COLS = 128;  // 32 lanes x 4 columns
constexpr int GEMV_UNROLL = 8;  // packed rows loaded ahead per lane

// 4 packed bytes (4 columns of packed row r) for the lane's columns n0..n0+3.
__device__ __forceinline__ uint32_t load_w4(const uint8_t* __restrict__ qw, int r, int n0,
                                            int N, bool vec) {
  const uint8_t* p = qw + (size_t)r * N + n0;
  if (vec) return n0 < N ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) w |= (uint32_t)__ldg(p + c) << (8 * c);
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

// One block: 128 output columns x one K split. Each of its 4 warps takes a
// contiguous quarter of the split's packed rows; partial sums meet in shared memory.
template <int MT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                 const float* __restrict__ scales, const float* __restrict__ zeros,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                 int M, int K, int N, int G, int rows_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GEMV_COLS + lane * 4;
  const bool vec = (N & 3) == 0;
  const int Kh = K >> 1;
  const int split_begin = blockIdx.y * rows_per_split;
  const int split_end = min(Kh, split_begin + rows_per_split);
  const int per_warp = (split_end - split_begin + GEMV_WARPS - 1) / GEMV_WARPS;
  const int rb = min(split_end, split_begin + warp * per_warp);
  const int re = min(split_end, rb + per_warp);
  const int gsz = (K + G - 1) / G;  // K-rows per scale group

  float y[MT][4], acc[MT][4], xs[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    xs[m] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) y[m][c] = acc[m][c] = 0.f;
  }
  int g = (2 * rb) / gsz;
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

  for (int r = rb; r < re; r += GEMV_UNROLL) {
    uint32_t w[GEMV_UNROLL];
#pragma unroll
    for (int u = 0; u < GEMV_UNROLL; ++u) w[u] = (r + u < re) ? load_w4(qw, r + u, n0, N, vec) : 0u;
#pragma unroll
    for (int u = 0; u < GEMV_UNROLL; ++u) {
      if (r + u >= re) break;
      const int k = 2 * (r + u);
      float xe[MT], xo[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * K + k);
          xe[m] = __low2float(p);
          xo[m] = __high2float(p);
        } else {
          xe[m] = xo[m] = 0.f;
        }
      }
      if (k >= next_group_k) { flush(); ++g; next_group_k += gsz; }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float q = level_to_float(lo_level(w[u] >> (8 * c)));
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xe[m], q, acc[m][c]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) xs[m] += xe[m];
      if (k + 1 >= next_group_k) { flush(); ++g; next_group_k += gsz; }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float q = level_to_float(hi_level(w[u] >> (8 * c)));
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xo[m], q, acc[m][c]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) xs[m] += xo[m];
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
__global__ void qmm4_splitk_reduce_kernel(const float* __restrict__ ws,
                                          __nv_bfloat16* __restrict__ out, int ksplit,
                                          int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < ksplit; ++s) v += ws[(size_t)s * MN + i];
  out[i] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Prefill: tensor-core GEMM for M > 16
// ---------------------------------------------------------------------------

constexpr int BM = 128;   // rows of x per block
constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // K-rows per tile (16 packed rows)
constexpr int LDS = BK + 8;  // padded shared-memory row, in bf16
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int A_CHUNKS = BM * BK / 8 / GEMM_THREADS;  // 16-byte x chunks per thread

// What one thread fetches from device memory for one k-tile: A_CHUNKS 8-wide chunks
// of x and 8 packed bytes (one packed row, 8 columns) of the weight.
struct TileRegs {
  uint4 a[A_CHUNKS];
  uint2 b;
};

__device__ __forceinline__ void fetch_tile(TileRegs& t, const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ qw, int k0, int m0,
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
  const int r = (k0 >> 1) + (tid & 15);
  const int n = n0 + (tid >> 4) * 8;
  t.b = make_uint2(0, 0);
  if (r < (K >> 1)) {
    const uint8_t* p = qw + (size_t)r * N + n;
    if (nvec) {
      if (n < N) t.b = __ldg(reinterpret_cast<const uint2*>(p));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t byte = (n + j < N) ? __ldg(p + j) : 0u;
        if (j < 4) t.b.x |= byte << (8 * j);
        else t.b.y |= byte << (8 * (j - 4));
      }
    }
  }
}

// The thread's 8 scales and zeros of one group, kept in registers across the
// tiles that group spans.
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

// x chunks -> As; weight bytes -> dequantized in f32 as (q - z) * s, rounded to bf16
// (the plain version's rounding) -> Bs, transposed so that one 32-bit word holds the
// (k, k+1) pair an mma B fragment register wants. Rows past K dequantize to finite
// values that meet zero activations.
__device__ __forceinline__ void store_tile(const TileRegs& t, GroupRegs& gr,
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
      const uint32_t word = j < 4 ? t.b.x : t.b.y;
      const uint32_t shift = 8 * (j & 3);
      const float we = (level_to_float((word >> shift) & 0xFu) - gr.z[j]) * gr.s[j];
      const float wo = (level_to_float(((word >> (shift + 4)) & 0xFu) ^ 0x8u) - gr.z[j]) * gr.s[j];
      Bs[col + j][prow] = pack_bf16x2(we, wo);
    }
    return;
  }
  // a group boundary inside the tile: per-row groups, as _expand_tiles assigns them
  const int r = (k0 >> 1) + prow;
  const int ge = (2 * r) / gsz, go = (2 * r + 1) / gsz;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float we = 0.f, wo = 0.f;
    if (r < (K >> 1) && n + j < N) {
      const uint32_t byte = (j < 4 ? t.b.x >> (8 * j) : t.b.y >> (8 * (j - 4))) & 0xFFu;
      const size_t ie = (size_t)ge * N + n + j, io = (size_t)go * N + n + j;
      we = (level_to_float(lo_level(byte)) - __ldg(zeros + ie)) * __ldg(scales + ie);
      wo = (level_to_float(hi_level(byte)) - __ldg(zeros + io)) * __ldg(scales + io);
    }
    Bs[col + j][prow] = pack_bf16x2(we, wo);
  }
}

// Double-buffered: while the tensor cores multiply tile k out of one shared buffer,
// the loads of tile k+1 are in flight into registers; they are dequantized into the
// other buffer afterwards, and one barrier per tile separates the two.
__global__ void __launch_bounds__(GEMM_THREADS)
qmm4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                 const float* __restrict__ scales, const float* __restrict__ zeros,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N, int G) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][LDS];
  __shared__ __align__(16) uint32_t Bs[2][BN][LDS / 2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gsz = (K + G - 1) / G;
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

  TileRegs t;
  GroupRegs gr;
  fetch_tile(t, x, qw, 0, m0, n0, M, K, N, xvec, nvec);
  store_tile(t, gr, As[0], Bs[0], scales, zeros, 0, n0, K, N, gsz, nvec);
  __syncthreads();

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < n_tiles;
    if (more) fetch_tile(t, x, qw, (kt + 1) * BK, m0, n0, M, K, N, xvec, nvec);

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
      store_tile(t, gr, As[buf ^ 1], Bs[buf ^ 1], scales, zeros, (kt + 1) * BK, n0, K, N, gsz,
                 nvec);
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

template <int MT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const uint8_t* qw, const float* s,
                        const float* z, __nv_bfloat16* out, float* ws, int M, int K, int N,
                        int G, int ksplit, int rows, cudaStream_t stream) {
  dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, ksplit);
  qmm4_gemv_kernel<MT><<<grid, GEMV_WARPS * 32, 0, stream>>>(x, qw, s, z, out, ws, M, K, N, G,
                                                              rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) bf16, qweight (K/2, N) u8, scales/zeros (G, N) f32 -> out (M, N) bf16.
// ws is (ksplit, M, N) f32 scratch when ksplit > 1; rows = packed rows per split.
int lljt_qmm4_gemv(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, void* ws, int M, int K, int N, int G, int ksplit, int rows,
                   void* stream) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qw = static_cast<const uint8_t*>(qweight);
  auto s = static_cast<const float*>(scales);
  auto z = static_cast<const float*>(zeros);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto w = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 1) err = launch_gemv<1>(xb, qw, s, z, o, w, M, K, N, G, ksplit, rows, st);
  else if (M <= 2) err = launch_gemv<2>(xb, qw, s, z, o, w, M, K, N, G, ksplit, rows, st);
  else if (M <= 4) err = launch_gemv<4>(xb, qw, s, z, o, w, M, K, N, G, ksplit, rows, st);
  else if (M <= 8) err = launch_gemv<8>(xb, qw, s, z, o, w, M, K, N, G, ksplit, rows, st);
  else if (M <= 16) err = launch_gemv<16>(xb, qw, s, z, o, w, M, K, N, G, ksplit, rows, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
  const int MN = M * N;
  qmm4_splitk_reduce_kernel<<<(MN + 255) / 256, 256, 0, st>>>(w, o, ksplit, MN);
  return static_cast<int>(cudaGetLastError());
}

int lljt_qmm4_gemm(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, int M, int K, int N, int G, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm4_gemm_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<__nv_bfloat16*>(out), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
