// Causal flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(hd), causal) v
// and the per-row logsumexp, bf16 in and out, f32 softmax statistics and accumulators.
//
// Replaces: the Pallas kernel lit_llama_ja_tpu/ops/pallas/flash_attention.py:78
//   _flash_forward (kernel body _flash_kernel :33), reached through flash_attention :286.
//   Like it, this kernel emits lse = m + log(l) per row for the backward (K6).
//
// What bounds it on an H100, and what the design does about it: it is bound by
// tensor-core flops (4 * hd per visible (query, key) pair against 8 * hd bytes per
// token), so it never materializes the (T, T) scores: one block owns 64 query rows
// of one (batch, head), keeps its q fragments in registers, and walks 64-key tiles
// of k and v through shared memory up to the diagonal only. q k^T and p v run on
// mma.sync m16n8k16 (bf16 -> f32); the online softmax keeps its running max and sum
// in f32 registers; p is passed from the score accumulators to the p v product in
// registers, without a trip through shared memory. Only the diagonal tile is masked
// element by element. Head dims 64, 78 and 128 run natively: the head dim is padded
// to a multiple of 16 (78 -> 80) inside shared memory with zeros, and the true scale
// 1/sqrt(hd) is applied to the scores. The last tile of a T that is not a multiple
// of 64 is masked, and its padded rows are computed but never stored. Tiles are
// single-buffered (no cp.async/TMA pipeline, no wgmma yet).
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block (16 per warp)
constexpr int BKV = 64;      // keys per tile
constexpr int THREADS = 128;

template <int HDP>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[HDP + 8], const uint16_t* __restrict__ src,
                                          long long stride_t, int row0, int T, int hd, bool vec) {
  load_rows<HDP, BKV, THREADS>(dst, src, stride_t, row0, T, hd, vec);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int nh, int T, int hd, long long sqb, long long sqh,
                 long long sqt, long long skb, long long skh, long long skt, long long svb,
                 long long svh, long long svt, float scale_log2, int vec) {
  constexpr int LD = HDP + 8;
  constexpr int KQ = HDP / 16;  // k16 steps over the head dim
  constexpr int NO = HDP / 8;   // n8 tiles of the output
  __shared__ __align__(16) uint16_t Ks[BKV][LD];
  __shared__ __align__(16) uint16_t Vs[BKV][LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;

  const uint16_t* qp = q + b * sqb + h * sqh;
  const uint16_t* kp = k + b * skb + h * skh;
  const uint16_t* vp = v + b * svb + h * svh;

  // q fragments (A operand, 16 rows x HDP), loaded once
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const int c = kk * 16 + 2 * tq;
    auto ld = [&](int row, int col) -> uint32_t {
      return (row < T && col < hd)
                 ? __ldg(reinterpret_cast<const uint32_t*>(qp + row * sqt + col))
                 : 0u;
    };
    qf[kk][0] = ld(row_a, c);
    qf[kk][1] = ld(row_b, c);
    qf[kk][2] = ld(row_a, c + 8);
    qf[kk][3] = ld(row_b, c + 8);
  }

  float oacc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 units
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the running sum

  const int last_kt = (min(q0 + BQ, T) - 1) / BKV;  // the diagonal tile
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
    load_tile<HDP>(Ks, kp, skt, k0, T, hd, vec);
    load_tile<HDP>(Vs, vp, svt, k0, T, hd, vec);
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const uint16_t* kr = &Ks[j * 8 + gq][kk * 16 + 2 * tq];
        mma_bf16_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale to log2 units, mask the diagonal tile, row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * scale_log2;
        if (kt == last_kt) {
          const int col = k0 + j * 8 + 2 * tq + (e & 1);
          const int row = (e < 2) ? row_a : row_b;
          if (col > row || col >= T) val = -INFINITY;
        }
        s[j][e] = val;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // every row sees key 0 in tile 0, so the new max is finite
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_a);
      s[j][1] = exp2f(s[j][1] - mn_a);
      s[j][2] = exp2f(s[j][2] - mn_b);
      s[j][3] = exp2f(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      oacc[j][0] *= alpha_a;
      oacc[j][1] *= alpha_a;
      oacc[j][2] *= alpha_b;
      oacc[j][3] *= alpha_b;
    }

    // o += p v; the score accumulator layout is the A-fragment layout of p
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * tq;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = j * 8 + gq;
        const uint32_t b0 = Vs[kr][c] | ((uint32_t)Vs[kr + 1][c] << 16);
        const uint32_t b1 = Vs[kr + 8][c] | ((uint32_t)Vs[kr + 9][c] << 16);
        mma_bf16_16816(oacc[j], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  __nv_bfloat16* ob = o + (size_t)bh * T * hd;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * tq;
    if (c >= hd) continue;  // hd is even, so c < hd implies c + 1 < hd
    if (row_a < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * hd + c) =
          __floats2bfloat162_rn(oacc[j][0] * inv_a, oacc[j][1] * inv_a);
    if (row_b < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * hd + c) =
          __floats2bfloat162_rn(oacc[j][2] * inv_b, oacc[j][3] * inv_b);
  }
  if (tq == 0) {
    constexpr float LN2 = 0.69314718055994531f;
    if (row_a < T) lse[(size_t)bh * T + row_a] = (m_a + log2f(l_a)) * LN2;
    if (row_b < T) lse[(size_t)bh * T + row_b] = (m_b + log2f(l_b)) * LN2;
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int nh, int T, int hd, const long long* st, float scale_log2, int vec,
                   cudaStream_t stream) {
  dim3 grid((T + BQ - 1) / BQ, B * nh);
  flash_fwd_kernel<HDP><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), nh, T, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale_log2, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (B, nh, T, hd) bf16 with unit stride along hd and the given element
// strides for batch, head and token; o: contiguous (B, nh, T, hd) bf16; lse:
// contiguous (B, nh, T) f32. hd must be even and at most 128.
int lljt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int nh, int T, int hd, long long sqb, long long sqh, long long sqt,
                   long long skb, long long skh, long long skt, long long svb, long long svh,
                   long long svt, float scale_log2, int vec, void* stream) {
  const long long st[9] = {sqb, sqh, sqt, skb, skh, skt, svb, svh, svt};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 64) err = launch<64>(q, k, v, o, lse, B, nh, T, hd, st, scale_log2, vec, s);
  else if (hd <= 80) err = launch<80>(q, k, v, o, lse, B, nh, T, hd, st, scale_log2, vec, s);
  else if (hd <= 128) err = launch<128>(q, k, v, o, lse, B, nh, T, hd, st, scale_log2, vec, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
