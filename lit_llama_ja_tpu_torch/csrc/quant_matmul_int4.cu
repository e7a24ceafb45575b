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
//   * Prefill (M > 16) is bound by tensor-core flops: 2*M*K*N against K*N/2 weight
//     bytes. It runs the one GEMM of qmm_generic.cuh (see its note) through the
//     decoder Int4Fmt below: a k-tile's 32 packed rows are copied as stored, and
//     K-row r reads the low (r even) or high (r odd) nibble of packed row r/2.
#include "qmm_generic.cuh"

namespace {

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

using qmm::GEMV_COLS;
using qmm::GEMV_WARPS;
constexpr int GEMV_UNROLL = 8;  // packed rows loaded ahead per lane

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
    qmm::load_f4(scales + (size_t)g * N, n0, N, vec, s);
    qmm::load_f4(zeros + (size_t)g * N, n0, N, vec, z);
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
    for (int u = 0; u < GEMV_UNROLL; ++u)
      w[u] = (r + u < re) ? qmm::load4(qw + (size_t)(r + u) * N, n0, N, vec) : 0u;
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

// The GEMM's decoder: K-row r of a k-tile in shared memory (the tile's BK / 2 packed
// rows as stored), columns c..c+7, four columns a word.
struct Int4Fmt {
  static constexpr int RPB0 = 2, RPB1 = 0;  // two K-rows per packed row; no second plane
  template <int BN>
  static __device__ __forceinline__ void tile_levels(const uint8_t* w, int r, int c, float q[8]) {
    const uint2 b = *reinterpret_cast<const uint2*>(w + (r >> 1) * BN + c);
    const int shift = 4 * (r & 1);
    const uint32_t flip = (r & 1) ? 0x08080808u : 0u;  // the high nibble's (q - 8) & 0xF
    qmm::byte_levels(make_uint2(((b.x >> shift) & 0x0F0F0F0Fu) ^ flip,
                                ((b.y >> shift) & 0x0F0F0F0Fu) ^ flip),
                     8388608.f, q);  // 2^23
  }
};

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
  qmm::qmm_splitk_reduce_kernel<<<(MN + 255) / 256, 256, 0, st>>>(w, o, ksplit, MN);
  return static_cast<int>(cudaGetLastError());
}

// bn, xw, ww, sw: the tile width and copy widths of the wrapper's GEMM plan.
int lljt_qmm4_gemm(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, int M, int K, int N, int G, int bn, int xw, int ww, int sw,
                   void* stream) {
  return static_cast<int>(qmm::launch_gemm<Int4Fmt>(x, qweight, nullptr, scales, zeros, out, M,
                                                    K, K, N, G, bn, xw, ww, sw, stream));
}

}  // extern "C"
