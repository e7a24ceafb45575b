// Causal flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(hd), causal) v
// and the per-row logsumexp, bf16 in and out, f32 softmax statistics and accumulators.
//
// Replaces: the Pallas kernel lit_llama_ja_tpu/ops/pallas/flash_attention.py:78
//   _flash_forward (kernel body _flash_kernel :33), reached through flash_attention :286.
//   Like it, this kernel emits lse = m + log(l) per row for the backward (K6).
//
// What bounds it on an H100, and what the design does about it: it is bound by
// tensor-core flops (4 * hd per visible (query, key) pair against 8 * hd bytes per
// token), so it never materializes the (T, T) scores, and the work of a block is to keep
// its mma.sync m16n8k16 (bf16 -> f32) units fed. FlashAttention-2's data movement:
//   * One block owns BQ = 64 or 128 query rows of one (batch, head): 2 or 4 warps of
//     32 rows, two m16 tiles a warp, so that every B fragment read from shared memory
//     feeds two mma (with one, the B reads alone would take all of shared memory's
//     bandwidth at the tensor cores' rate). The wrapper's flash_plan picks the size. q is
//     copied once into shared memory and read as A fragments by ldmatrix.x4: once into
//     registers up to hd 80, again for each key tile at hd 128, where it would not fit
//     beside the accumulators.
//   * 64-key tiles of k and v stream through a ring of S = fwd_stages() stages in
//     dynamic shared memory, filled by cp.async (16, 8 or 4 bytes a copy, as the row
//     starts allow; rows past T and columns past hd zero-filled by the copy). k and v
//     are separate copy groups: a tile's k is issued before the q k^T of the tile S - 1
//     before it, and its v after that, so v's copy runs under the softmax and p v, and
//     k's under everything. Two stages measured as fast as three (flash_probe).
//   * Every B operand is one ldmatrix.x4 per two n8 tiles: k without .trans as the B of
//     q k^T, v with .trans as the B of p v. Rows of HDP + 8 elements keep ldmatrix free
//     of bank conflicts (flash_common.cuh).
//   * p stays in registers: the score accumulators are the A fragments of p v.
//   * The online softmax keeps its running max (raw score units) and sum in f32; the
//     scale folds into one FFMA per score before exp2f. Only the tiles that cross a
//     warp's diagonal or hold T's ragged end are masked element by element; a warp skips
//     tiles that lie wholly above its diagonal. Blocks of the longest rows start first,
//     each tile index for every head before the next (flash_common.cuh, block order).
// Head dims up to 128 run natively: padded to HDP = 64, 80 or 128 with zeros inside
// shared memory, with the true scale 1/sqrt(hd). wgmma and TMA are later work.
#include "flash_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using flash::KV_ROWS;
constexpr int ROWS_PER_WARP = 32;  // two m16 tiles

template <int HDP, int BQ>
constexpr size_t fwd_smem() {
  return size_t(BQ + 2 * flash::fwd_stages<HDP>() * KV_ROWS) * flash::Tile<HDP>::LD *
         sizeof(uint16_t);
}

// One online-softmax step of one m16 tile of a warp (rows row_a and row_b = row_a + 8):
// s holds this key tile's raw scores (-inf where masked) and becomes p; the running
// max (raw units) and this thread's part of the running sum advance, and the output
// accumulators are rescaled.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (*s)[4], float (*oacc)[4], float& m_a,
                                             float& m_b, float& l_a, float& l_b,
                                             float scale_log2) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
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
  const float alpha_a = exp2f((m_a - mn_a) * scale_log2);
  const float alpha_b = exp2f((m_b - mn_b) * scale_log2);
  m_a = mn_a;
  m_b = mn_b;
  const float ms_a = mn_a * scale_log2, ms_b = mn_b * scale_log2;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j][0] = exp2f(fmaf(s[j][0], scale_log2, -ms_a));
    s[j][1] = exp2f(fmaf(s[j][1], scale_log2, -ms_a));
    s[j][2] = exp2f(fmaf(s[j][2], scale_log2, -ms_b));
    s[j][3] = exp2f(fmaf(s[j][3], scale_log2, -ms_b));
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
}

template <int HDP, int BQ>
__global__ void __launch_bounds__(BQ / ROWS_PER_WARP * 32)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int nh, int T, int hd, long long sqb, long long sqh,
                 long long sqt, long long skb, long long skh, long long skt, long long svb,
                 long long svh, long long svt, float scale_log2, int width) {
  using Tl = flash::Tile<HDP>;
  constexpr int LD = Tl::LD, KQ = Tl::KQ, NO = Tl::NO, NS = KV_ROWS / 8;
  constexpr int MT = ROWS_PER_WARP / 16;  // m16 tiles a warp: each B fragment feeds MT mma
  constexpr int NT = BQ / ROWS_PER_WARP * 32;
  // q's A fragments stay in registers up to hd 80; at 128 they would not fit beside
  // the accumulators, and are read again from shared memory for each key tile
  constexpr bool Q_IN_REGS = HDP <= 80;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // (BQ, LD)
  constexpr int S = flash::fwd_stages<HDP>();
  uint16_t* Ks = Qs + BQ * LD;                            // S stages of (KV_ROWS, LD)
  uint16_t* Vs = Ks + S * KV_ROWS * LD;                   // S stages of (KV_ROWS, LD)

  const int bh = flash::block_head();
  const int qt = flash::block_tiles() - 1 - flash::block_tile();  // longest rows first
  const int b = bh / nh, h = bh % nh;
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr0 = q0 + warp * ROWS_PER_WARP;  // this warp's first row

  const uint16_t* qp = q + b * sqb + h * sqh;
  const uint16_t* kp = k + b * skb + h * skh;
  const uint16_t* vp = v + b * svb + h * svh;

  const int last_kt = (min(q0 + BQ, T) - 1) / KV_ROWS;  // the block's last tile
  // k and v of tile t go to stage t % S as two copy groups, S - 1 tiles ahead; a tile
  // past the last commits an empty group, so the count of groups in flight is fixed
  auto fetch_k = [&](int t) {
    if (t <= last_kt)
      flash::copy_rows<HDP, KV_ROWS, NT>(Ks + (t % S) * KV_ROWS * LD, kp, skt, t * KV_ROWS, T,
                                         hd, width);
    cp_async_commit();
  };
  auto fetch_v = [&](int t) {
    if (t <= last_kt)
      flash::copy_rows<HDP, KV_ROWS, NT>(Vs + (t % S) * KV_ROWS * LD, vp, svt, t * KV_ROWS, T,
                                         hd, width);
    cp_async_commit();
  };
  flash::copy_rows<HDP, BQ, NT>(Qs, qp, sqt, q0, T, hd, width);  // in k(0)'s group
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    fetch_k(t);
    fetch_v(t);
  }

  uint32_t qf[Q_IN_REGS ? KQ : 1][MT][4];
  float oacc[MT][NO][4];
  float m_a[MT], m_b[MT], l_a[MT], l_b[MT];  // running max (raw units) and sum
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    m_a[mi] = m_b[mi] = -INFINITY;
    l_a[mi] = l_b[mi] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mi][j][e] = 0.f;
  }

  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * KV_ROWS;
    const uint16_t* Kt = Ks + (kt % S) * KV_ROWS * LD;
    const uint16_t* Vt = Vs + (kt % S) * KV_ROWS * LD;
    // groups after k(kt): v(kt), then k and v of the S - 2 tiles after it
    cp_async_wait<2 * S - 3>();
    __syncthreads();  // k(kt) visible; every warp is past q k^T of tile kt - 1
    if (Q_IN_REGS && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < (Q_IN_REGS ? KQ : 1); ++kk)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          ldmatrix_x4(qf[kk][mi],
                      flash::a_addr<LD>(Qs, warp * ROWS_PER_WARP + mi * 16, kk * 16, lane));
    }
    fetch_k(kt + S - 1);  // into tile kt - 1's stage

    // a warp whose rows all lie above this tile's first key, or past T, skips it
    const bool active = k0 <= wr0 + ROWS_PER_WARP - 1 && wr0 < T;
    float s[MT][NS][4];
    if (active) {
      // s = q k^T for this warp's rows x 64 keys
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if constexpr (Q_IN_REGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[mi][e] = qf[kk][mi][e];
          } else {
            ldmatrix_x4(qa[mi],
                        flash::a_addr<LD>(Qs, warp * ROWS_PER_WARP + mi * 16, kk * 16, lane));
          }
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t kb[4];
          ldmatrix_x4(kb, flash::b_nk_addr<LD>(Kt, jp * 16, kk * 16, lane));
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16_16816(s[mi][2 * jp], qa[mi], kb[0], kb[1]);
            mma_bf16_16816(s[mi][2 * jp + 1], qa[mi], kb[2], kb[3]);
          }
        }
      }
      // mask the tiles that cross this warp's diagonal or hold T's end
      if (k0 + KV_ROWS - 1 > wr0 || k0 + KV_ROWS > T) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + j * 8 + 2 * tq + (e & 1);
              const int row = wr0 + mi * 16 + gq + ((e < 2) ? 0 : 8);
              if (col > row || col >= T) s[mi][j][e] = -INFINITY;
            }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        softmax_step<NS, NO>(s[mi], oacc[mi], m_a[mi], m_b[mi], l_a[mi], l_b[mi], scale_log2);
    }

    // groups after v(kt): k and v of the S - 2 tiles after it, and k(kt + S - 1)
    cp_async_wait<2 * S - 3>();
    __syncthreads();  // v(kt) visible; every warp is past p v of tile kt - 1
    fetch_v(kt + S - 1);  // into tile kt - 1's stage

    if (active) {
      // o += p v; p is the A fragment straight from the score accumulators, and each
      // of v's B fragments (ldmatrix .trans) feeds the warp's MT m16 tiles
#pragma unroll
      for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) flash::acc_to_a(pa[mi], s[mi], kk);
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, flash::b_kn_addr<LD>(Vt, kk * 16, jp * 16, lane));
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16_16816(oacc[mi][2 * jp], pa[mi], vb[0], vb[1]);
            mma_bf16_16816(oacc[mi][2 * jp + 1], pa[mi], vb[2], vb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  constexpr float LN2 = 0.69314718055994531f;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float la = l_a[mi], lb = l_b[mi];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    const int row_a = wr0 + mi * 16 + gq, row_b = row_a + 8;
    flash::store_rows<NO>(o + (size_t)bh * T * hd, oacc[mi], row_a, T, hd, tq, 1.f / la,
                          1.f / lb);
    if (tq == 0) {
      if (row_a < T) lse[(size_t)bh * T + row_a] = (m_a[mi] * scale_log2 + log2f(la)) * LN2;
      if (row_b < T) lse[(size_t)bh * T + row_b] = (m_b[mi] * scale_log2 + log2f(lb)) * LN2;
    }
  }
}

template <int HDP, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int nh, int T, int hd, const long long* st, float scale_log2, int width,
                   cudaStream_t stream) {
  constexpr size_t SMEM = fwd_smem<HDP, BQ>();
  static_assert(SMEM <= 227 * 1024, "K2's tiles exceed the shared memory of a block");
  cudaError_t err = flash::allow_smem(flash_fwd_kernel<HDP, BQ>, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid = flash::grid_of(B * nh, (T + BQ - 1) / BQ);
  flash_fwd_kernel<HDP, BQ><<<grid, BQ / ROWS_PER_WARP * 32, SMEM, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), nh, T, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale_log2, width);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_rows(int rows, const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int nh, int T, int hd, const long long* st,
                        float scale_log2, int width, cudaStream_t stream) {
  if (rows == 64)
    return launch<HDP, 64>(q, k, v, o, lse, B, nh, T, hd, st, scale_log2, width, stream);
  return launch<HDP, 128>(q, k, v, o, lse, B, nh, T, hd, st, scale_log2, width, stream);
}

}  // namespace

extern "C" {

// q, k, v: (B, nh, T, hd) bf16 with unit stride along hd and the given element
// strides for batch, head and token; o: contiguous (B, nh, T, hd) bf16; lse:
// contiguous (B, nh, T) f32. hd must be even and at most 128. rows (64 or 128) and
// width (bytes a cp.async: 16, 8 or 4, which must divide every stride in bytes and
// every base address) come from flash_plan in ops/cuda/flash_attention.py.
int lljt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int nh, int T, int hd, long long sqb, long long sqh, long long sqt,
                   long long skb, long long skh, long long skt, long long svb, long long svh,
                   long long svt, float scale_log2, int rows, int width, void* stream) {
  if ((rows != 64 && rows != 128) || (width != 4 && width != 8 && width != 16) ||
      hd <= 0 || hd % 2 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqh, sqt, skb, skh, skt, svb, svh, svt};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd <= 64) err = launch_rows<64>(rows, q, k, v, o, lse, B, nh, T, hd, st, scale_log2, width, s);
  else if (hd <= 80) err = launch_rows<80>(rows, q, k, v, o, lse, B, nh, T, hd, st, scale_log2, width, s);
  else err = launch_rows<128>(rows, q, k, v, o, lse, B, nh, T, hd, st, scale_log2, width, s);
  return static_cast<int>(err);
}

}  // extern "C"
