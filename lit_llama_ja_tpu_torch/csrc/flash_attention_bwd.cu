// Causal flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q k^T / sqrt(hd), causal) v, recomputing the probabilities from the
// forward's logsumexp. bf16 in and out, f32 accumulation.
//
// Replaces: the Pallas kernels lit_llama_ja_tpu/ops/pallas/flash_attention.py:207
//   _flash_backward (bodies _flash_bwd_dq_kernel :130 and _flash_bwd_dkv_kernel :165),
//   the backward of the custom VJP at :283-304. Same math:
//     p  = exp(q k^T * scale - lse)   (causal; lse in natural-log units, from K2)
//     dp = dO v^T
//     ds = p * (dp - D) * scale       (D = rowsum(dO * O), computed by the wrapper)
//     dq = ds k,  dk = ds^T q,  dv = p^T dO
//
// What bounds it on an H100, and what the design does about it: five products of
// 2 * hd flops per visible (query, key) pair (s, dp, dv, dk, dq) against 16 * hd bytes
// per token, so it is bound by tensor-core flops and must never materialize the
// (T, T) matrices. It follows the JAX split, which needs no atomics and so is
// deterministic: two kernels on one stream, launched by one entry point.
//   * dkv: one block per 64-key tile of one (batch, head). Its k and v tiles sit in
//     shared memory for the whole walk; it walks the 64-query tiles from the
//     diagonal down to T, with dk and dv in f32 registers (16 keys per warp). s and
//     dp are computed transposed (keys as rows), so p^T and ds^T leave the score
//     accumulators as the A fragments of the dv and dk products, in registers.
//   * dq: one block per 64-query tile. Its q and dO fragments stay in registers; it
//     walks the 64-key tiles up to the diagonal, with dq in f32 registers, and ds
//     leaves the score accumulators as the A fragment of the dq product.
// Both use mma.sync m16n8k16 (bf16 -> f32), like K2. Only the diagonal tile is
// masked element by element; rows past T get lse = +inf, so their p is 0. Head dims
// 64, 78 and 128 run natively: the head dim is padded to a multiple of 16 in shared
// memory and in the fragments with zeros. Tiles are single-buffered (no cp.async/TMA
// pipeline, no wgmma yet), and s and dp are recomputed in both kernels (seven
// products in all, against the five the function needs).
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // ob/oh/ot: dO
};

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from rows r and r + 1 of one column of a shared tile, lo from row r: the
// B fragment of a product whose k dimension runs down the tile's rows.
template <int LD>
__device__ __forceinline__ uint32_t col_pair(uint16_t (*t)[LD], int r, int c) {
  return t[r][c] | ((uint32_t)t[r + 1][c] << 16);
}

// A fragment (16 x 16, row-major) for rows r0 .. r0 + 15 and columns k0 .. k0 + 15
// of a shared tile.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t a[4], uint16_t (*t)[LD], int r0, int k0,
                                       int gq, int tq) {
  a[0] = ld_pair(&t[r0 + gq][k0 + 2 * tq]);
  a[1] = ld_pair(&t[r0 + gq + 8][k0 + 2 * tq]);
  a[2] = ld_pair(&t[r0 + gq][k0 + 2 * tq + 8]);
  a[3] = ld_pair(&t[r0 + gq + 8][k0 + 2 * tq + 8]);
}

// Store a warp's 16 x HDP f32 accumulator rows (row_a, row_b = row_a + 8) as bf16
// into a contiguous (T, hd) slice.
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float acc[NO][4], int row_a,
                                           int T, int hd, int tq) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * tq;
    if (c >= hd) continue;  // hd is even, so c < hd implies c + 1 < hd
    if (row_a < T)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row_a * hd + c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (row_b < T)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row_b * hd + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per 64-key tile
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nh,
                     int T, int hd, Strides st, float scale, float scale_log2, int vec) {
  constexpr int LD = HDP + 8;
  constexpr int KQ = HDP / 16;  // k16 steps over the head dim
  constexpr int NO = HDP / 8;   // n8 tiles of the outputs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t(*Ks)[LD] = reinterpret_cast<uint16_t(*)[LD]>(smem_raw);
  uint16_t(*Vs)[LD] = Ks + BKV;
  uint16_t(*Qs)[LD] = Vs + BKV;
  uint16_t(*Os)[LD] = Qs + BQ;  // dO
  float* lse_s = reinterpret_cast<float*>(Os + BQ);  // log2 units, +inf past T
  float* dd_s = lse_s + BQ;

  const int kt = blockIdx.x;  // the first key tiles walk the most query tiles
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int k0 = kt * BKV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int key_a = k0 + warp * 16 + gq, key_b = key_a + 8;

  const uint16_t* qp = q + b * st.qb + h * st.qh;
  const uint16_t* op = dout + b * st.ob + h * st.oh;
  const float* lse_p = lse + (size_t)bh * T;
  const float* dd_p = dd + (size_t)bh * T;

  load_rows<HDP, BKV, THREADS>(Ks, k + b * st.kb + h * st.kh, st.kt, k0, T, hd, vec);
  load_rows<HDP, BKV, THREADS>(Vs, v + b * st.vb + h * st.vh, st.vt, k0, T, hd, vec);

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int n_qt = (T + BQ - 1) / BQ;
  for (int qt = kt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile is no longer read
    load_rows<HDP, BQ, THREADS>(Qs, qp, st.qt, q0, T, hd, vec);
    load_rows<HDP, BQ, THREADS>(Os, op, st.ot, q0, T, hd, vec);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int r = q0 + i;
      lse_s[i] = r < T ? lse_p[r] * LOG2E : INFINITY;
      dd_s[i] = r < T ? dd_p[r] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x 64 queries
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ka[4], va[4];
      a_frag<LD>(ka, Ks, warp * 16, kk * 16, gq, tq);
      a_frag<LD>(va, Vs, warp * 16, kk * 16, gq, tq);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const uint16_t* qr = &Qs[j * 8 + gq][kk * 16 + 2 * tq];
        mma_bf16_16816(s[j], ka, ld_pair(qr), ld_pair(qr + 8));
        const uint16_t* orow = &Os[j * 8 + gq][kk * 16 + 2 * tq];
        mma_bf16_16816(dp[j], va, ld_pair(orow), ld_pair(orow + 8));
      }
    }

    // p^T and ds^T in place of s^T and dp^T; only the diagonal tile is masked
    const bool diag = qt == kt;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * tq + (e & 1);
        float x = s[j][e] * scale_log2 - lse_s[ql];
        if (diag && ((e < 2) ? key_a : key_b) > q0 + ql) x = -INFINITY;
        const float p = exp2f(x);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dd_s[ql]) * scale;
      }
    }

    // dv += p^T dO and dk += ds^T q; k runs over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * tq;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = j * 8 + gq;
        mma_bf16_16816(dv_acc[j], pa, col_pair<LD>(Os, kr, c), col_pair<LD>(Os, kr + 8, c));
        mma_bf16_16816(dk_acc[j], da, col_pair<LD>(Qs, kr, c), col_pair<LD>(Qs, kr + 8, c));
      }
    }
  }

  store_rows<NO>(dk + (size_t)bh * T * hd, dk_acc, key_a, T, hd, tq);
  store_rows<NO>(dv + (size_t)bh * T * hd, dv_acc, key_a, T, hd, tq);
}

// ---------------------------------------------------------------------------
// dq: one block per 64-query tile
// ---------------------------------------------------------------------------
template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int nh, int T, int hd, Strides st,
                    float scale, float scale_log2, int vec) {
  constexpr int LD = HDP + 8;
  constexpr int KQ = HDP / 16;
  constexpr int NO = HDP / 8;
  __shared__ __align__(16) uint16_t Ks[BKV][LD];
  __shared__ __align__(16) uint16_t Vs[BKV][LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / nh, h = bh % nh;
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;

  const uint16_t* qp = q + b * st.qb + h * st.qh;
  const uint16_t* op = dout + b * st.ob + h * st.oh;
  const uint16_t* kp = k + b * st.kb + h * st.kh;
  const uint16_t* vp = v + b * st.vb + h * st.vh;

  // q and dO fragments (A operands, 16 rows x HDP), loaded once
  uint32_t qf[KQ][4], of[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const int c = kk * 16 + 2 * tq;
    auto ld = [&](const uint16_t* base, long long stride, int row, int col) -> uint32_t {
      return (row < T && col < hd)
                 ? __ldg(reinterpret_cast<const uint32_t*>(base + row * stride + col))
                 : 0u;
    };
    qf[kk][0] = ld(qp, st.qt, row_a, c);
    qf[kk][1] = ld(qp, st.qt, row_b, c);
    qf[kk][2] = ld(qp, st.qt, row_a, c + 8);
    qf[kk][3] = ld(qp, st.qt, row_b, c + 8);
    of[kk][0] = ld(op, st.ot, row_a, c);
    of[kk][1] = ld(op, st.ot, row_b, c);
    of[kk][2] = ld(op, st.ot, row_a, c + 8);
    of[kk][3] = ld(op, st.ot, row_b, c + 8);
  }
  const float* lse_p = lse + (size_t)bh * T;
  const float* dd_p = dd + (size_t)bh * T;
  const float lse_a = row_a < T ? lse_p[row_a] * LOG2E : INFINITY;
  const float lse_b = row_b < T ? lse_p[row_b] * LOG2E : INFINITY;
  const float dd_a = row_a < T ? dd_p[row_a] : 0.f;
  const float dd_b = row_b < T ? dd_p[row_b] : 0.f;

  float dq_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  const int last_kt = (min(q0 + BQ, T) - 1) / BKV;  // the diagonal tile
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
    load_rows<HDP, BKV, THREADS>(Ks, kp, st.kt, k0, T, hd, vec);
    load_rows<HDP, BKV, THREADS>(Vs, vp, st.vt, k0, T, hd, vec);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows x 64 keys
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const uint16_t* kr = &Ks[j * 8 + gq][kk * 16 + 2 * tq];
        mma_bf16_16816(s[j], qf[kk], ld_pair(kr), ld_pair(kr + 8));
        const uint16_t* vr = &Vs[j * 8 + gq][kk * 16 + 2 * tq];
        mma_bf16_16816(dp[j], of[kk], ld_pair(vr), ld_pair(vr + 8));
      }
    }

    // ds in place of s; the diagonal tile also masks the keys past T
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e < 2) ? row_a : row_b;
        float x = s[j][e] * scale_log2 - ((e < 2) ? lse_a : lse_b);
        if (kt == last_kt) {
          const int col = k0 + j * 8 + 2 * tq + (e & 1);
          if (col > row || col >= T) x = -INFINITY;
        }
        const float p = exp2f(x);
        s[j][e] = p * (dp[j][e] - ((e < 2) ? dd_a : dd_b)) * scale;
      }
    }

    // dq += ds k; k runs over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * tq;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = j * 8 + gq;
        mma_bf16_16816(dq_acc[j], da, col_pair<LD>(Ks, kr, c), col_pair<LD>(Ks, kr + 8, c));
      }
    }
  }

  store_rows<NO>(dq + (size_t)bh * T * hd, dq_acc, row_a, T, hd, tq);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dd, void* dq, void* dk, void* dv, int B, int nh,
                   int T, int hd, const Strides& st, float scale, float scale_log2, int vec,
                   cudaStream_t stream) {
  constexpr int LD = HDP + 8;
  constexpr size_t DKV_SMEM = (2 * BKV + 2 * BQ) * LD * sizeof(uint16_t) + 2 * BQ * sizeof(float);
  static_assert(DKV_SMEM <= 227 * 1024, "dkv tiles exceed the shared memory of a block");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(DKV_SMEM));
  if (err != cudaSuccess) return err;
  const auto* qh = static_cast<const uint16_t*>(q);
  const auto* kh = static_cast<const uint16_t*>(k);
  const auto* vh = static_cast<const uint16_t*>(v);
  const auto* oh = static_cast<const uint16_t*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(dd);
  dim3 grid_q((T + BQ - 1) / BQ, B * nh);
  flash_bwd_dq_kernel<HDP><<<grid_q, THREADS, 0, stream>>>(
      qh, kh, vh, oh, lf, df, static_cast<__nv_bfloat16*>(dq), nh, T, hd, st, scale,
      scale_log2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv((T + BKV - 1) / BKV, B * nh);
  flash_bwd_dkv_kernel<HDP><<<grid_kv, THREADS, DKV_SMEM, stream>>>(
      qh, kh, vh, oh, lf, df, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      nh, T, hd, st, scale, scale_log2, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dO: (B, nh, T, hd) bf16 with unit stride along hd and the given element
// strides for batch, head and token; lse and D: contiguous (B, nh, T) f32; dq, dk,
// dv: contiguous (B, nh, T, hd) bf16. hd must be even and at most 128.
int lljt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dd, void* dq, void* dk, void* dv, int B, int nh,
                   int T, int hd, long long sqb, long long sqh, long long sqt, long long skb,
                   long long skh, long long skt, long long svb, long long svh, long long svt,
                   long long sob, long long soh, long long sot, float scale, float scale_log2,
                   int vec, void* stream) {
  const Strides st{sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 64)
    err = launch<64>(q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale, scale_log2, vec, s);
  else if (hd <= 80)
    err = launch<80>(q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale, scale_log2, vec, s);
  else if (hd <= 128)
    err = launch<128>(q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale, scale_log2, vec, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
