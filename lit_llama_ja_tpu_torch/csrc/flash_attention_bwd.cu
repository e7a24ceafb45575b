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
// (T, T) matrices. It follows the JAX split, which needs no atomics and so gives the
// same bits on every run: two kernels on one stream, launched by one entry point, each
// output element summed by one thread in a fixed order.
//   * dkv: one block per BR = 64 or 128 keys (4 or 8 warps of 16 keys) of one
//     (batch, head); k and v are copied once into shared memory. Query tiles of BQT
//     rows (64; 32 at head dims above 80, to keep the accumulators in registers) with
//     their lse and D rows stream through a cp.async ring of bwd_stages() from the
//     diagonal down to T: the next tiles copy while the current one computes. s and
//     dp are computed transposed (keys as rows), so p^T and ds^T leave the score
//     accumulators as the A fragments of the dv and dk products, in registers.
//   * dq: one block per BR query rows (16 a warp); q and dO are copied once into shared
//     memory, and 64-key tiles of k and v stream through a cp.async ring of
//     bwd_stages() up to the diagonal; ds leaves the score accumulators as the A
//     fragment of dq += ds k.
//   * Every tensor-core operand in shared memory is read by ldmatrix.x4: the k, v, q and
//     dO A fragments and the B of s and dp without .trans, the B of dv (dO), dk (q) and
//     dq (k) with .trans. Rows of HDP + 8 elements keep them free of bank conflicts.
//   * The scale folds into one FFMA per score before exp2f. Only the tiles that cross a
//     warp's diagonal or hold T's ragged end are masked element by element, and a warp
//     skips the tiles that its diagonal leaves wholly masked.
// Head dims up to 128 run natively: padded to HDP = 64, 80 or 128 with zeros inside
// shared memory. s and dp are recomputed in both kernels (seven products against the
// five the function needs); the one-pass form needs f32 atomics for dq, whose order
// changes the bits from run to run.
#include "flash_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using flash::KV_ROWS;
using flash::LOG2E;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // ob/oh/ot: dO
};

// query rows of each streamed tile of the dkv kernel
template <int HDP>
__host__ __device__ constexpr int dkv_q_rows() { return HDP > 80 ? 32 : 64; }

template <int HDP, int BR>
constexpr size_t dkv_smem() {
  constexpr int BQT = dkv_q_rows<HDP>(), S = flash::bwd_stages<HDP>();
  return size_t(2 * BR + 2 * S * BQT) * flash::Tile<HDP>::LD * sizeof(uint16_t) +
         2 * S * BQT * sizeof(float);
}

template <int HDP, int BR>
constexpr size_t dq_smem() {
  constexpr int S = flash::bwd_stages<HDP>();
  return size_t(2 * BR + 2 * S * KV_ROWS) * flash::Tile<HDP>::LD * sizeof(uint16_t);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per BR keys
// ---------------------------------------------------------------------------
template <int HDP, int BR>
__global__ void __launch_bounds__(2 * BR)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nh,
                     int T, int hd, Strides st, float scale, float scale_log2, int width) {
  using Tl = flash::Tile<HDP>;
  constexpr int LD = Tl::LD, KQ = Tl::KQ, NO = Tl::NO;
  constexpr int BQT = dkv_q_rows<HDP>(), NS = BQT / 8;
  constexpr int NT = 2 * BR, S = flash::bwd_stages<HDP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem_raw);  // (BR, LD)
  uint16_t* Vs = Ks + BR * LD;                            // (BR, LD)
  uint16_t* Qs = Vs + BR * LD;                            // S stages of (BQT, LD)
  uint16_t* Os = Qs + S * BQT * LD;                       // dO: S stages of (BQT, LD)
  float* lse_s = reinterpret_cast<float*>(Os + S * BQT * LD);  // S stages of BQT
  float* dd_s = lse_s + S * BQT;                               // S stages of BQT

  const int bh = flash::block_head();
  const int k0 = flash::block_tile() * BR;  // the first key blocks walk the most query tiles
  const int b = bh / nh, h = bh % nh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wk0 = k0 + warp * 16;  // this warp's first key
  const int key_a = wk0 + gq, key_b = key_a + 8;

  const uint16_t* qp = q + b * st.qb + h * st.qh;
  const uint16_t* op = dout + b * st.ob + h * st.oh;
  const float* lse_p = lse + (size_t)bh * T;
  const float* dd_p = dd + (size_t)bh * T;

  const int qt_first = k0 / BQT, n_qt = (T + BQT - 1) / BQT;
  // the i-th query tile of the walk (qt_first + i) goes to stage i % S as one copy
  // group, S - 1 tiles ahead; past the last tile an empty group keeps the count fixed
  auto fetch = [&](int i) {
    const int q0 = (qt_first + i) * BQT, stage = i % S;
    if (q0 < T) {
      flash::copy_rows<HDP, BQT, NT>(Qs + stage * BQT * LD, qp, st.qt, q0, T, hd, width);
      flash::copy_rows<HDP, BQT, NT>(Os + stage * BQT * LD, op, st.ot, q0, T, hd, width);
      flash::copy_vec<BQT, NT>(lse_s + stage * BQT, lse_p, q0, T);
      flash::copy_vec<BQT, NT>(dd_s + stage * BQT, dd_p, q0, T);
    }
    cp_async_commit();
  };

  // k and v join the first tile's group
  flash::copy_rows<HDP, BR, NT>(Ks, k + b * st.kb + h * st.kh, st.kt, k0, T, hd, width);
  flash::copy_rows<HDP, BR, NT>(Vs, v + b * st.vb + h * st.vh, st.vt, k0, T, hd, width);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) fetch(i);

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int i = qt - qt_first, stage = i % S;
    cp_async_wait<S - 2>();  // the S - 2 groups after this tile's may be in flight
    __syncthreads();  // this tile visible; every warp is past tile i - 1
    fetch(i + S - 1);  // into tile i - 1's stage

    const int q0 = qt * BQT;
    // a warp whose keys all lie past this tile's last query, or past T, skips it
    if (wk0 > q0 + BQT - 1 || wk0 >= T) continue;
    const uint16_t* Qt = Qs + stage * BQT * LD;
    const uint16_t* Ot = Os + stage * BQT * LD;
    const float* lse_t = lse_s + stage * BQT;
    const float* dd_t = dd_s + stage * BQT;

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x BQT queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, flash::a_addr<LD>(Ks, warp * 16, kk * 16, lane));
      ldmatrix_x4(va, flash::a_addr<LD>(Vs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t qb[4], ob[4];
        ldmatrix_x4(qb, flash::b_nk_addr<LD>(Qt, jp * 16, kk * 16, lane));
        ldmatrix_x4(ob, flash::b_nk_addr<LD>(Ot, jp * 16, kk * 16, lane));
        mma_bf16_16816(s[2 * jp], ka, qb[0], qb[1]);
        mma_bf16_16816(s[2 * jp + 1], ka, qb[2], qb[3]);
        mma_bf16_16816(dp[2 * jp], va, ob[0], ob[1]);
        mma_bf16_16816(dp[2 * jp + 1], va, ob[2], ob[3]);
      }
    }

    // p^T and ds^T in place of s^T and dp^T
    const bool masked = q0 < wk0 + 15 || q0 + BQT > T;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int ql = j * 8 + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(dd_t + ql);
      const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E}, dv2[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, nl[e & 1]));
        if (masked) {
          const int query = q0 + ql + (e & 1);
          if (((e < 2) ? key_a : key_b) > query || query >= T) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dv2[e & 1]) * scale;
      }
    }

    // dv += p^T dO and dk += ds^T q; k runs over the tile's BQT queries
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t pa[4], da[4];
      flash::acc_to_a(pa, s, kk);
      flash::acc_to_a(da, dp, kk);
      flash::mma_a_bkn<LD, NO>(dv_acc, pa, Ot, kk * 16, lane);
      flash::mma_a_bkn<LD, NO>(dk_acc, da, Qt, kk * 16, lane);
    }
  }
  cp_async_wait<0>();

  flash::store_rows<NO>(dk + (size_t)bh * T * hd, dk_acc, key_a, T, hd, tq);
  flash::store_rows<NO>(dv + (size_t)bh * T * hd, dv_acc, key_a, T, hd, tq);
}

// ---------------------------------------------------------------------------
// dq: one block per BR query rows
// ---------------------------------------------------------------------------
template <int HDP, int BR>
__global__ void __launch_bounds__(2 * BR)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int nh, int T, int hd, Strides st,
                    float scale, float scale_log2, int width) {
  using Tl = flash::Tile<HDP>;
  constexpr int LD = Tl::LD, KQ = Tl::KQ, NO = Tl::NO, NS = KV_ROWS / 8;
  constexpr int NT = 2 * BR, S = flash::bwd_stages<HDP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // (BR, LD)
  uint16_t* Os = Qs + BR * LD;                            // dO: (BR, LD)
  uint16_t* Ks = Os + BR * LD;                            // S stages of (KV_ROWS, LD)
  uint16_t* Vs = Ks + S * KV_ROWS * LD;                   // S stages of (KV_ROWS, LD)

  const int bh = flash::block_head();
  const int qt = flash::block_tiles() - 1 - flash::block_tile();  // longest rows first
  const int b = bh / nh, h = bh % nh;
  const int q0 = qt * BR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr0 = q0 + warp * 16;
  const int row_a = wr0 + gq, row_b = row_a + 8;

  const uint16_t* kp = k + b * st.kb + h * st.kh;
  const uint16_t* vp = v + b * st.vb + h * st.vh;
  const int last_kt = (min(q0 + BR, T) - 1) / KV_ROWS;  // the block's last tile
  // k and v of tile t go to stage t % S as one copy group, S - 1 tiles ahead; past the
  // last tile an empty group keeps the count fixed
  auto fetch = [&](int t) {
    if (t <= last_kt) {
      const int stage = t % S;
      flash::copy_rows<HDP, KV_ROWS, NT>(Ks + stage * KV_ROWS * LD, kp, st.kt, t * KV_ROWS, T,
                                         hd, width);
      flash::copy_rows<HDP, KV_ROWS, NT>(Vs + stage * KV_ROWS * LD, vp, st.vt, t * KV_ROWS, T,
                                         hd, width);
    }
    cp_async_commit();
  };
  // q and dO join tile 0's group
  flash::copy_rows<HDP, BR, NT>(Qs, q + b * st.qb + h * st.qh, st.qt, q0, T, hd, width);
  flash::copy_rows<HDP, BR, NT>(Os, dout + b * st.ob + h * st.oh, st.ot, q0, T, hd, width);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) fetch(t);

  const float* lse_p = lse + (size_t)bh * T;
  const float* dd_p = dd + (size_t)bh * T;
  // rows past T get lse = +inf, so their p is 0
  const float nl_a = row_a < T ? -lse_p[row_a] * LOG2E : -INFINITY;
  const float nl_b = row_b < T ? -lse_p[row_b] * LOG2E : -INFINITY;
  const float dd_a = row_a < T ? dd_p[row_a] : 0.f;
  const float dd_b = row_b < T ? dd_p[row_b] : 0.f;

  float dq_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * KV_ROWS;
    const int stage = kt % S;
    cp_async_wait<S - 2>();  // the S - 2 groups after this tile's may be in flight
    __syncthreads();  // this tile visible; every warp is past tile kt - 1
    fetch(kt + S - 1);  // into tile kt - 1's stage

    // a warp whose rows all lie above this tile's first key, or past T, skips it
    if (k0 > wr0 + 15 || wr0 >= T) continue;
    const uint16_t* Kt = Ks + stage * KV_ROWS * LD;
    const uint16_t* Vt = Vs + stage * KV_ROWS * LD;

    // s = q k^T and dp = dO v^T for this warp's 16 rows x 64 keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, flash::a_addr<LD>(Qs, warp * 16, kk * 16, lane));
      ldmatrix_x4(oa, flash::a_addr<LD>(Os, warp * 16, kk * 16, lane));
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, flash::b_nk_addr<LD>(Kt, jp * 16, kk * 16, lane));
        ldmatrix_x4(vb, flash::b_nk_addr<LD>(Vt, jp * 16, kk * 16, lane));
        mma_bf16_16816(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16_16816(s[2 * jp + 1], qa, kb[2], kb[3]);
        mma_bf16_16816(dp[2 * jp], oa, vb[0], vb[1]);
        mma_bf16_16816(dp[2 * jp + 1], oa, vb[2], vb[3]);
      }
    }

    // ds in place of s
    const bool masked = k0 + KV_ROWS - 1 > wr0 || k0 + KV_ROWS > T;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, (e < 2) ? nl_a : nl_b));
        if (masked) {
          const int col = k0 + j * 8 + 2 * tq + (e & 1);
          if (col > ((e < 2) ? row_a : row_b) || col >= T) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - ((e < 2) ? dd_a : dd_b)) * scale;
      }
    }

    // dq += ds k; k runs over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
      uint32_t da[4];
      flash::acc_to_a(da, s, kk);
      flash::mma_a_bkn<LD, NO>(dq_acc, da, Kt, kk * 16, lane);
    }
  }
  cp_async_wait<0>();

  flash::store_rows<NO>(dq + (size_t)bh * T * hd, dq_acc, row_a, T, hd, tq);
}

template <int HDP, int BR>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dd, void* dq, void* dk, void* dv, int B, int nh,
                   int T, int hd, const Strides& st, float scale, float scale_log2, int width,
                   cudaStream_t stream) {
  constexpr size_t DQ_SMEM = dq_smem<HDP, BR>(), DKV_SMEM = dkv_smem<HDP, BR>();
  static_assert(DQ_SMEM <= 227 * 1024 && DKV_SMEM <= 227 * 1024,
                "K6's tiles exceed the shared memory of a block");
  cudaError_t err = flash::allow_smem(flash_bwd_dq_kernel<HDP, BR>, DQ_SMEM);
  if (err == cudaSuccess) err = flash::allow_smem(flash_bwd_dkv_kernel<HDP, BR>, DKV_SMEM);
  if (err != cudaSuccess) return err;
  const auto* qh = static_cast<const uint16_t*>(q);
  const auto* kh = static_cast<const uint16_t*>(k);
  const auto* vh = static_cast<const uint16_t*>(v);
  const auto* oh = static_cast<const uint16_t*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(dd);
  const dim3 grid = flash::grid_of(B * nh, (T + BR - 1) / BR);
  flash_bwd_dq_kernel<HDP, BR><<<grid, 2 * BR, DQ_SMEM, stream>>>(
      qh, kh, vh, oh, lf, df, static_cast<__nv_bfloat16*>(dq), nh, T, hd, st, scale,
      scale_log2, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<HDP, BR><<<grid, 2 * BR, DKV_SMEM, stream>>>(
      qh, kh, vh, oh, lf, df, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      nh, T, hd, st, scale, scale_log2, width);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_rows(int rows, const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* dd, void* dq, void* dk, void* dv, int B,
                        int nh, int T, int hd, const Strides& st, float scale, float scale_log2,
                        int width, cudaStream_t s) {
  if (rows == 64)
    return launch<HDP, 64>(q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale,
                           scale_log2, width, s);
  return launch<HDP, 128>(q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale,
                          scale_log2, width, s);
}

}  // namespace

extern "C" {

// q, k, v, dO: (B, nh, T, hd) bf16 with unit stride along hd and the given element
// strides for batch, head and token; lse and D: contiguous (B, nh, T) f32; dq, dk,
// dv: contiguous (B, nh, T, hd) bf16. hd must be even and at most 128. rows (64 or
// 128: query rows a dq block, keys a dkv block) and width (bytes a cp.async, as for
// lljt_flash_fwd) come from flash_plan in ops/cuda/flash_attention.py.
int lljt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dd, void* dq, void* dk, void* dv, int B, int nh,
                   int T, int hd, long long sqb, long long sqh, long long sqt, long long skb,
                   long long skh, long long skt, long long svb, long long svh, long long svt,
                   long long sob, long long soh, long long sot, float scale, float scale_log2,
                   int rows, int width, void* stream) {
  if ((rows != 64 && rows != 128) || (width != 4 && width != 8 && width != 16) ||
      hd <= 0 || hd % 2 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 64)
    err = launch_rows<64>(rows, q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale,
                          scale_log2, width, s);
  else if (hd <= 80)
    err = launch_rows<80>(rows, q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale,
                          scale_log2, width, s);
  else
    err = launch_rows<128>(rows, q, k, v, dout, lse, dd, dq, dk, dv, B, nh, T, hd, st, scale,
                           scale_log2, width, s);
  return static_cast<int>(err);
}

}  // extern "C"
