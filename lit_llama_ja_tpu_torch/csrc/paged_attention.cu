// Paged int8 decode attention for Hopper (sm_90a): one query token per slot against
// that slot's pages of an int8 KV page pool, out = softmax(q k^T / sqrt(hd), tok <= pos) v
// with per-token scales folded in: s = (q . k) * k_scale / sqrt(hd), p v = (p * v_scale) v.
//
// Replaces: lit_llama_ja_tpu/ops/pallas/paged_attention.py:99 paged_decode_attention
//   (kernel body _kernel :42) as K7, and :228 paged_decode_attention_db (_db_kernel :154)
//   as K8, the same function with the pages streamed through a two-stage pipeline.
//
// Layout: pages (P, nh, page, hd) int8, scales (P, nh, page) f32, the pool layout of
// infer/paged.py (one layer's view of the stacked (L, P, nh, page, hd) pool); tables
// (B, AP) int32 page indices; pos (B,) int32, the last visible token of each slot.
//
// What bounds it on an H100, and what the design does about it: it is bound by bytes
// (2 * hd + 8 bytes per visible token and head against 4 * hd flops), so it reads each
// visible token's k, v and scales exactly once and nothing else: the tokens past pos[b],
// and so every page wholly past it, are never read. The TPU kernel holds one whole page
// of every head per grid step (1 MB per stage at 7B with page 128, against 227 KB of
// shared memory on an SM), so here one block owns one (slot, head) and one split of
// CHUNK = 256 of its tokens (flash-decoding): at B = 1 and 32 heads, 2048 tokens make
// 256 blocks instead of 32, and no block walks more than four tiles, so the chain of
// tile latencies a block waits through stays short. A second kernel folds the splits'
// partial (max, sum, sum p v) into the output, skipping the splits past a slot's last
// token; a launch whose table spans at most CHUNK tokens has no second kernel, its one
// split writing the output. At least 132 SMs' worth of blocks are there at B = 1
// only from about 1,100 tokens on (32 heads); shorter contexts leave SMs idle. The block first
// copies its split's page indices into shared memory, so no tile waits on a table
// read. It walks its tokens in tiles of 64; a tile gathers its tokens from as many
// pages as it spans. A head's page block (page, hd) is contiguous, so each page
// segment of a tile is one contiguous run of bytes, copied by 16-byte cp.async when the
// run and the shared destination are 16-byte aligned (any layer view of the stacked
// pool with page * hd a multiple of 16, as 16 x 78 is) and byte by byte otherwise: no
// page size or head dim is refused, and a row of 78 bytes never has to be aligned. All
// of a tile's copies are in flight at once. Scores: each warp takes four tokens at a
// time, its lanes across the head dim, with four interleaved shuffle reductions; the
// online softmax keeps its running max and sum in f32 in warp 0; p v: each thread owns
// one element of the head dim (hd <= 128), with four partial sums. Masked tokens are
// never loaded, so they weigh an exact 0. K7 waits for a tile's copies before it folds
// the tile; K8 issues the next tile's copies before it folds the current one, through
// two shared-memory stages.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // one thread per head-dim element in the p v product
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;  // tokens per tile
constexpr int CHUNK = 256;  // tokens per split (one block); a multiple of TILE
constexpr int MAX_HD = 128;

struct Stage {
  int8_t k[TILE * MAX_HD];
  int8_t v[TILE * MAX_HD];
  float ks[TILE];
  float vs[TILE];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// n bytes from src to shared dst by the block: 16-byte cp.async copies when both are
// 16-byte aligned, the rest (and everything when they are not) byte by byte.
__device__ __forceinline__ void copy_run(int8_t* dst, const int8_t* __restrict__ src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n16 = n >> 4;
    for (int c = threadIdx.x; c < n16; c += THREADS) cp_async16(dst + 16 * c, src + 16 * c);
    done = n16 << 4;
  }
  for (int c = done + threadIdx.x; c < n; c += THREADS) dst[c] = src[c];
}

// Tokens [t0, t1) of one (slot, head) into one stage: one contiguous run per page, and
// the scales by 4-byte cp.async copies. pages[j - j0] is the pool page of the slot's
// table entry j.
__device__ __forceinline__ void load_tile(Stage& st, const int8_t* __restrict__ k,
                                          const float* __restrict__ ks,
                                          const int8_t* __restrict__ v,
                                          const float* __restrict__ vs, const int* pages,
                                          int j0, int h, int nh, int page, int hd, int t0,
                                          int t1) {
  for (int tok = t0; tok < t1;) {
    const int j = tok / page;
    const int off = tok - j * page;
    const int end = min(t1, (j + 1) * page);
    const long long blk = (static_cast<long long>(pages[j - j0]) * nh + h) * page + off;
    const int n = end - tok, at = tok - t0;
    copy_run(st.k + at * hd, k + blk * hd, n * hd);
    copy_run(st.v + at * hd, v + blk * hd, n * hd);
    for (int c = threadIdx.x; c < n; c += THREADS) {
      cp_async4(st.ks + at + c, ks + blk + c);
      cp_async4(st.vs + at + c, vs + blk + c);
    }
    tok = end;
  }
}

// Visible tokens of slot b: 0..pos[b], within the AP pages of its table.
__device__ __forceinline__ int visible(const int* __restrict__ pos, int b, int AP, int page) {
  return max(0, min(pos[b] + 1, AP * page));
}

// One (head, slot, split) block: attention over the split's visible tokens. With one
// split it writes the output; otherwise its unnormalized sum of p v (acc_part) and its
// running max (log2 units) and sum (ml_part), for paged_decode_combine.
template <bool PIPELINED>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int* __restrict__ tables,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ acc_part, float* __restrict__ ml_part, int nh, int page,
                    int hd, int AP, float scale_log2) {
  constexpr int NSTAGE = PIPELINED ? 2 : 1;
  __shared__ __align__(16) Stage stages[NSTAGE];
  __shared__ float q_s[MAX_HD];
  __shared__ float s_s[TILE];  // scores, then p * v_scale
  __shared__ int pages_s[CHUNK + 1];  // the split's page indices (page 1 at worst)
  __shared__ float alpha_s, l_s;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_all = visible(pos, b, AP, page);
  const int t_begin = split * CHUNK;
  if (t_begin >= n_all) {  // past the slot's tokens: the combine skips this split
    if (n_all == 0 && n_split == 1)  // nothing visible (never with pos >= 0): zeros
      for (int d = tid; d < hd; d += THREADS)
        o[(static_cast<long long>(b) * nh + h) * hd + d] = __float2bfloat16(0.f);
    return;
  }
  const int t_end = min(t_begin + CHUNK, n_all);
  const int* table = tables + static_cast<long long>(b) * AP;
  const int j0 = t_begin / page, nj = (t_end - 1) / page - j0 + 1;
  for (int i = tid; i < nj; i += THREADS) pages_s[i] = table[j0 + i];
  const long long qo = (static_cast<long long>(b) * nh + h) * hd;
  for (int d = tid; d < hd; d += THREADS) q_s[d] = __bfloat162float(q[qo + d]);
  __syncthreads();

  const int n_tiles = (t_end - t_begin + TILE - 1) / TILE;
  float qr[MAX_HD / 32];  // this lane's elements of q: d = lane + 32 i
  float acc = 0.f;         // this thread's head-dim element of sum p v
  float m_run = -INFINITY, l_run = 0.f;  // warp 0: running max (log2 units) and sum

  load_tile(stages[0], k, ks, v, vs, pages_s, j0, h, nh, page, hd, t_begin,
            min(t_begin + TILE, t_end));
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < MAX_HD / 32; ++i) qr[i] = lane + 32 * i < hd ? q_s[lane + 32 * i] : 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = t_begin + i * TILE, n = min(TILE, t_end - t0);
    const Stage& st = stages[PIPELINED ? (i & 1) : 0];
    if (PIPELINED && i + 1 < n_tiles) {
      // the other stage was last read in tile i - 1, before the barrier that ended it
      load_tile(stages[(i + 1) & 1], k, ks, v, vs, pages_s, j0, h, nh, page, hd, t0 + TILE,
                min(t0 + 2 * TILE, t_end));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores, four tokens per warp at a time so that the reductions overlap
    for (int tb = warp; tb < n; tb += 4 * WARPS) {
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = tb + u * WARPS;
        if (t < n) {
          const int8_t* kr = st.k + t * hd;
#pragma unroll
          for (int j = 0; j < MAX_HD / 32; ++j) {
            const int d = lane + 32 * j;
            if (d < hd) dot[u] = fmaf(qr[j], static_cast<float>(kr[d]), dot[u]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = tb + u * WARPS;
          if (t < n) s_s[t] = dot[u] * st.ks[t] * scale_log2;
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s_s[t]);
      const float m_new = fmaxf(m_run, warp_max(mx));
      const float alpha = exp2f(m_run - m_new);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = exp2f(s_s[t] - m_new);
        sum += p;
        s_s[t] = p * st.vs[t];
      }
      l_run = l_run * alpha + warp_sum(sum);
      m_run = m_new;
      if (lane == 0) alpha_s = alpha;
    }
    __syncthreads();

    if (tid < hd) {
      const int8_t* vc = st.v + tid;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
      int t = 0;
      for (; t + 4 <= n; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pv[u] = fmaf(s_s[t + u], static_cast<float>(vc[(t + u) * hd]), pv[u]);
      }
      for (; t < n; ++t) pv[0] = fmaf(s_s[t], static_cast<float>(vc[t * hd]), pv[0]);
      acc = acc * alpha_s + ((pv[0] + pv[1]) + (pv[2] + pv[3]));
    }
    __syncthreads();  // the stage and s_s are rewritten by the next tile
    if (!PIPELINED && i + 1 < n_tiles) {
      load_tile(stages[0], k, ks, v, vs, pages_s, j0, h, nh, page, hd, t0 + TILE,
                min(t0 + 2 * TILE, t_end));
      cp_async_commit();
    }
  }

  if (tid == 0) {
    l_s = l_run;
    if (n_split > 1) {
      const long long at = (static_cast<long long>(b) * nh + h) * n_split + split;
      ml_part[2 * at] = m_run;
      ml_part[2 * at + 1] = l_run;
    }
  }
  __syncthreads();
  if (tid < hd) {
    if (n_split > 1)
      acc_part[((static_cast<long long>(b) * nh + h) * n_split + split) * hd + tid] = acc;
    else
      o[qo + tid] = __float2bfloat16(acc / l_s);  // l_s >= 1: split 0 holds token 0
  }
}

// Folds the splits of each (slot, head): out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s.
__global__ void __launch_bounds__(THREADS)
paged_decode_combine(const float* __restrict__ acc_part, const float* __restrict__ ml_part,
                     const int* __restrict__ pos, __nv_bfloat16* __restrict__ o, int nh,
                     int page, int hd, int AP, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= hd) return;
  const int n_valid = (visible(pos, b, AP, page) + CHUNK - 1) / CHUNK;
  const long long base = (static_cast<long long>(b) * nh + h) * n_split;
  float m = -INFINITY;
  for (int s = 0; s < n_valid; ++s) m = fmaxf(m, ml_part[2 * (base + s)]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_valid; ++s) {
    const float w = exp2f(ml_part[2 * (base + s)] - m);
    l = fmaf(ml_part[2 * (base + s) + 1], w, l);
    acc = fmaf(acc_part[(base + s) * hd + d], w, acc);
  }
  o[(static_cast<long long>(b) * nh + h) * hd + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

}  // namespace

extern "C" {

// Tokens per split; the caller sizes the workspace with it.
int lljt_paged_decode_chunk() { return CHUNK; }

// q: contiguous (B, nh, hd) bf16; k, v: contiguous (P, nh, page, hd) int8; ks, vs:
// contiguous (P, nh, page) f32; tables: contiguous (B, AP) int32 with entries in [0, P);
// pos: (B,) int32; o: contiguous (B, nh, hd) bf16. hd <= 128. work: f32 workspace of
// work_len >= B * nh * n_split * (hd + 2) floats, n_split = ceil(AP * page / CHUNK)
// (unused, and may be null, when n_split is 1). pipelined: 0 runs K7, 1 K8.
int lljt_paged_decode(const void* q, const void* k, const void* ks, const void* v,
                      const void* vs, const void* tables, const void* pos, void* o, void* work,
                      int B, int nh, int page, int hd, int AP, long long work_len,
                      float scale_log2, int pipelined, void* stream) {
  if (hd < 1 || hd > MAX_HD || page < 1 || AP < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long span = static_cast<long long>(AP) * page;
  const int n_split = static_cast<int>((span + CHUNK - 1) / CHUNK);
  const long long n_acc = static_cast<long long>(B) * nh * n_split * hd;
  if (n_split > 1 && (work == nullptr || work_len < n_acc + 2LL * B * nh * n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nh, B, n_split);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* tp = static_cast<const int*>(tables);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* acc = static_cast<float*>(work);
  float* ml = n_split > 1 ? acc + n_acc : nullptr;
  if (pipelined)
    paged_decode_kernel<true><<<grid, THREADS, 0, s>>>(qp, kp, ksp, vp, vsp, tp, pp, op, acc,
                                                       ml, nh, page, hd, AP, scale_log2);
  else
    paged_decode_kernel<false><<<grid, THREADS, 0, s>>>(qp, kp, ksp, vp, vsp, tp, pp, op, acc,
                                                        ml, nh, page, hd, AP, scale_log2);
  if (n_split > 1)
    paged_decode_combine<<<dim3(nh, B), THREADS, 0, s>>>(acc, ml, pp, op, nh, page, hd, AP,
                                                         n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
