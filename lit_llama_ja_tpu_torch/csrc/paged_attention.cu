// Paged int8 decode attention for Hopper (sm_90a): one query token per slot against
// that slot's pages of an int8 KV page pool, out = softmax(q k^T / sqrt(hd), tok <= pos) v
// with per-token scales folded in: s = (q . k) * k_scale / sqrt(hd), p v = (p * v_scale) v.
//
// Replaces: lit_llama_ja_tpu/ops/pallas/paged_attention.py:99 paged_decode_attention
//   (kernel body _kernel :42, pallas_call :141) as K7, and :228 paged_decode_attention_db
//   (_db_kernel :154, pallas_call :266) as K8, the same function with the pages streamed
//   by DMA.
//
// Layout: pages (P, nh, page, hd) int8, scales (P, nh, page) f32, the pool layout of
// infer/paged.py (one layer's view of the stacked (L, P, nh, page, hd) pool); tables
// (B, AP) int32 page indices; pos (B,) int32, the last visible token of each slot.
//
// What bounds it on an H100: bytes. A visible token costs 2 * hd + 8 bytes a head (its k
// and v rows and two f32 scales) against 4 * hd flops, so the kernels read each visible
// token's rows and scales once and nothing else: tokens past pos[b], and so every page
// wholly past it, are never read. What the design does about the rest:
//   * Splits planned for the card (paged_plan, ops/cuda/paged_attention.py): the tokens
//     of one (slot, head) are cut into `splits` spans of `span` tokens, a whole number of
//     block tiles, from the shapes and the SM count alone (never pos, which lives on the
//     device). The splits of one (slot, head) are the blocks of one thread-block cluster
//     (at most 8). A block whose span starts past the slot's last token exits at once.
//   * One launch, no workspace: each block merges its warps' partial (max, sum, sum p v)
//     in warp order, pushes the result into a slot of rank 0's shared memory (distributed
//     shared memory), and rank 0 merges the slots in rank order and writes bf16. The order
//     of every sum is fixed, so two launches give equal bits.
//   * The fold, a warp tile of 16 tokens at a time, each warp over its own tokens: the
//     scores on the tensor cores (mma.sync m16n8k16, f16 in, f32 sums) with the k tile as
//     A, read 16 bytes a lane straight from shared memory, and q as B (f16: exact for
//     bf16 values from 2^-14 up, scaled by a power of two where max |q| >= 2^15), so
//     that each lane ends with the scores of two tokens and no shuffle sums a dot. The
//     levels become operands without I2F: the byte xor 0x80 under the f16 exponent of
//     1024 is 1152 + level (one PRMT for two levels), and 1152 * sum q comes off each
//     score. The softmax runs over the warp (a max and a sum of 3 shuffles each); p v
//     stays in f32 FFMAs over 16 bytes of v a lane, each level made exact by the f32
//     magic 2^23 (one PRMT and one FADD). No block barrier belongs to the softmax.
//   * K7: each warp copies its own tiles into its own ring of three stages by 16-byte
//     cp.async, one contiguous run per page and head (page * hd bytes: 2,048 at page 16
//     and hd 128), and waits on its own copies: the loop has no block barrier at all.
//   * K8: one producer warp feeds a ring of three block tiles by 1-D TMA bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx), one per page-head run of k and of v and
//     one per scale run, lane r issuing run r's after its own table read; the four
//     folding warps wait on each stage's full barrier and release it on its empty
//     barrier. Runs whose source, destination or size is not a multiple of 16 bytes
//     (page 3 or 4 at hd 78, the 12-byte scale runs of page 3, views at odd offsets) are
//     copied by the producer's lanes instead.
//   * Head dims that are not a multiple of 16 (the 125M model's 78) take the general
//     route: byte reads from shared memory masked at hd, the same two products. Copies
//     fall back from 16-byte to 4-byte to byte runs wherever a run or its ends are not
//     aligned, so no page size, head dim or layer view is refused.
// The variants measured and dropped (k's dot in f32 FFMAs, one producer lane issuing every
// run, table entries read a tile ahead, rings of 2 or 4 stages, 8 warps a block) and their
// times: PERF.md, section 6 (`ops/cuda/paged_probe.py`).
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;        // warps that fold tokens
constexpr int WT = 16;          // tokens of a warp tile: the rows of one m16n8k16 product
constexpr int MAX_HD = 128;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int K7_STAGES = 3;    // each warp's cp.async ring
constexpr int K8_STAGES = 3;    // the block's TMA ring
constexpr int SLOT = MAX_HD + 2;  // a partial: max, sum, then sum p v over hd
// shared memory before the rings: the warps' partials, then rank 0's slots of the
// cluster's partials
constexpr int HEAD_BYTES = (WARPS + MAX_CLUSTER) * SLOT * 4;
static_assert(HEAD_BYTES % 16 == 0, "the rings start 16-byte aligned");

// One ring slot of n tokens: their k rows, their v rows, their k scales, their v scales.
// n is a multiple of 16, so every part starts 16-byte aligned.
__host__ __device__ constexpr int tile_bytes(int n, int hd) { return n * (2 * hd + 8); }

struct Tile {
  int8_t* k;
  int8_t* v;
  float* ks;
  float* vs;
};

__device__ __forceinline__ Tile tile_at(uint8_t* base, int n, int hd) {
  return {reinterpret_cast<int8_t*>(base), reinterpret_cast<int8_t*>(base + n * hd),
          reinterpret_cast<float*>(base + 2 * n * hd),
          reinterpret_cast<float*>(base + 2 * n * hd + 4 * n)};
}

// A warp's running softmax over its tokens: max (log2 units) and sum, the same in every
// lane, and the lane's 16 elements of sum (p * v_scale) v.
struct Fold {
  float m, l, acc[16];
};

// Visible tokens of slot b: 0..pos[b], within the AP pages of its table (an idle slot's
// position may lie past its table).
__device__ __forceinline__ int visible(const int* __restrict__ pos, int b, int AP, int page) {
  return max(0, min(pos[b] + 1, AP * page));
}

// c += a * b on the tensor cores: a 16x16 f16 A fragment, a 16x8 f16 B fragment, a 16x8
// f32 accumulator (the m16n8k16 register layouts, as mma_bf16_16816).
__device__ __forceinline__ void mma_f16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 levels of w ^ 0x80808080 (bytes 0 and 1: sel 0x4140; bytes 2 and 3: 0x4342) as
// the f16x2 pair 1152 + level, without I2F: the byte, level + 128, under the f16 exponent
// of 1024 (0x64).
__device__ __forceinline__ uint32_t half2_levels(uint32_t w, uint32_t sel) {
  return __byte_perm(w, 0x64646464u, sel);
}

// Four int8 levels packed in w as exact floats, without I2F: (level ^ 0x80) is 0..255,
// permuted into the low byte of 0x4B000000 (2^23) it reads 2^23 + level + 128.
__device__ __forceinline__ void levels4(uint32_t w, float (&f)[4]) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}

// 16 bytes of a row from shared memory, columns c0..c0+15: one 16-byte load (VEC: hd % 16
// == 0, so the row and the columns are aligned), else byte loads, zero at and past hd.
template <bool VEC>
__device__ __forceinline__ uint4 row16(const int8_t* row, int c0, int hd) {
  if (VEC) return *reinterpret_cast<const uint4*>(row + c0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (c0 + e < hd)
      w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[c0 + e])) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// q as the B operand of the score product (every column of B is q): in k16 step s, lane
// t = lane % 4 holds dims D + {0, 1} (b[s][0]) and D + {2, 3} (b[s][1]), D = 64 (s / 4) +
// 16 t + 4 (s % 4), the dims of its bytes of a k row. q is scaled by 2^-e so that it fits
// f16 (e = 0 unless max |q| >= 2^15); off = 1152 * sum of the f16 values, the offset that
// the levels' f16 form adds; scale = 2^e.
struct QFrag {
  uint32_t b[8][2];
  float off, scale;
};

// J: the 64-byte column blocks of a row (hd <= 64J).
template <int J>
__device__ __forceinline__ void load_q(QFrag& Q, const __nv_bfloat16* __restrict__ q, int hd,
                                       int lane) {
  const int t = lane & 3;
  float x[4 * J][4];
  float mx = 0.f;
#pragma unroll
  for (int s = 0; s < 4 * J; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 64 * (s >> 2) + 16 * t + 4 * (s & 3) + e;
      x[s][e] = d < hd ? __bfloat162float(q[d]) : 0.f;
      mx = fmaxf(mx, fabsf(x[s][e]));
    }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const int e2 = max(0, static_cast<int>((__float_as_uint(mx) >> 23) & 0xFF) - 127 - 14);
  const float down = __uint_as_float(static_cast<uint32_t>(127 - e2) << 23);
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < 4 * J; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2 v = __floats2half2_rn(x[s][2 * h] * down, x[s][2 * h + 1] * down);
      Q.b[s][h] = *reinterpret_cast<const uint32_t*>(&v);
      sum += __low2float(v) + __high2float(v);
    }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  Q.off = 1152.f * sum;
  Q.scale = __uint_as_float(static_cast<uint32_t>(127 + e2) << 23);
}

// One warp tile of n tokens (rows 0..15 at k, v, ks, vs; rows n.. are never weighed).
// Scores on the tensor cores: A is the k tile as f16 levels + 1152 (rows: tokens; lane (g,
// t) = (lane / 4, lane % 4) reads 16 bytes of rows g and g + 8 at columns 64 j + 16 t, so
// a load instruction covers whole rows), B is q, and lane (g, t) gets the scores of tokens
// g and g + 8. The softmax runs over the warp. p v: lane group G = lane / (4 J) takes tokens
// G, G + 8 / J, ... and each of its lanes 16 bytes of their v rows, f32 sums.
template <int J, bool VEC>
__device__ __forceinline__ void fold_tile(Fold& st, const QFrag& Q, const int8_t* k,
                                          const int8_t* v, const float* ks, const float* vs,
                                          int n, int hd, float scale_log2, int lane) {
  constexpr int VL = 4 * J, VG = 32 / VL, TPV = WT / VG;
  const int g = lane >> 2, t = lane & 3;
  uint4 lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int8_t* row = k + (g + 8 * h) * hd;
    if (J == 1) {
      lo[h] = 16 * t < hd ? row16<VEC>(row, 16 * t, hd) : make_uint4(0u, 0u, 0u, 0u);
      hi[h] = lo[h];
    } else {  // odd rows read their second half first, so no two rows meet on a bank
      const int c1 = 64 * (g & 1) + 16 * t, c2 = 64 * (~g & 1) + 16 * t;
      const uint4 first = c1 < hd ? row16<VEC>(row, c1, hd) : make_uint4(0u, 0u, 0u, 0u);
      const uint4 second = c2 < hd ? row16<VEC>(row, c2, hd) : make_uint4(0u, 0u, 0u, 0u);
      lo[h] = g & 1 ? second : first;
      hi[h] = g & 1 ? first : second;
    }
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < 4 * J; ++s) {
    const uint32_t w0 = word(s < 4 ? lo[0] : hi[0], s & 3) ^ 0x80808080u;
    const uint32_t w1 = word(s < 4 ? lo[1] : hi[1], s & 3) ^ 0x80808080u;
    const uint32_t a[4] = {half2_levels(w0, 0x4140), half2_levels(w1, 0x4140),
                           half2_levels(w0, 0x4342), half2_levels(w1, 0x4342)};
    mma_f16_16816(c, a, Q.b[s][0], Q.b[s][1]);
  }
  const float f = Q.scale * scale_log2;
  const float s0 = g < n ? (c[0] - Q.off) * f * ks[g] : -INFINITY;
  const float s1 = g + 8 < n ? (c[2] - Q.off) * f * ks[g + 8] : -INFINITY;
  float mt = fmaxf(s0, s1);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
  const float mx = fmaxf(st.m, mt);  // finite: token 0 of the tile is visible
  const float alpha = mx == st.m ? 1.f : exp2f(st.m - mx);
  const float p0 = g < n ? exp2f(s0 - mx) : 0.f;
  const float p1 = g + 8 < n ? exp2f(s1 - mx) : 0.f;
  float ps = p0 + p1;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
  st.l = st.l * alpha + ps;
  if (alpha != 1.f) {  // the same in every lane
#pragma unroll
    for (int e = 0; e < 16; ++e) st.acc[e] *= alpha;
  }
  st.m = mx;
  const int G = lane / VL, c0 = 16 * (lane % VL);
  const bool cols = c0 < hd;
#pragma unroll
  for (int i = 0; i < TPV; ++i) {
    const int tok = G + VG * i;  // below 8 exactly when i < TPV / 2
    const float p = __shfl_sync(0xffffffffu, i < TPV / 2 ? p0 : p1, 4 * (tok & 7));
    if (tok < n && cols) {
      const float pv = p * vs[tok];
      const uint4 w = row16<VEC>(v + tok * hd, c0, hd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float fl[4];
        levels4(word(w, j), fl);
#pragma unroll
        for (int e = 0; e < 4; ++e) st.acc[4 * j + e] = fmaf(pv, fl[e], st.acc[4 * j + e]);
      }
    }
  }
}

// The warp's lane groups summed by a butterfly over the group index (one max for the
// whole warp, so no weights); afterwards every group holds the warp's sums.
template <int J>
__device__ __forceinline__ void merge_groups(Fold& st) {
#pragma unroll
  for (int o = 4 * J; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 16; ++e) st.acc[e] += __shfl_xor_sync(0xffffffffu, st.acc[e], o);
}

// Cluster barriers at cluster scope (see qmm_gemv.cuh): arrive with release so that the
// slots written into rank 0 are seen after its wait (acquire).
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of both kernels. part holds each folding warp's (max, sum, acc[hd]); the caller
// has passed a __syncthreads after writing it, and arrived once (relaxed) on the cluster
// barrier at its start. The block merges its warps in warp order and writes the result
// into slot `rank` of rank 0's slots; rank 0 then merges slots 0..n_valid-1 in rank order.
// Blocks past the slot's tokens exited before their first arrive, and a cluster barrier
// waits only for threads that have not exited.
__device__ __forceinline__ void finish(const float* part, float* slots, int rank, int n_valid,
                                       int hd, __nv_bfloat16* __restrict__ out) {
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, part[w * SLOT]);
  float wt[WARPS], L = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = part[w * SLOT] == -INFINITY ? 0.f : exp2f(part[w * SLOT] - M);
    L = fmaf(part[w * SLOT + 1], wt[w], L);
  }
  namespace cg = cooperative_groups;
  float* dst = cg::this_cluster().map_shared_rank(slots, 0) + rank * SLOT;
  cluster_wait();  // rank 0 has started: its shared memory may be written
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) A = fmaf(part[w * SLOT + 2 + d], wt[w], A);
    dst[2 + d] = A;
  }
  if (threadIdx.x == 0) {
    dst[0] = M;
    dst[1] = L;
  }
  cluster_arrive_release();
  cluster_wait();
  if (rank != 0) return;
  float Mc = -INFINITY;
  for (int r = 0; r < n_valid; ++r) Mc = fmaxf(Mc, slots[r * SLOT]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float A = 0.f, Lc = 0.f;
    for (int r = 0; r < n_valid; ++r) {
      const float w = exp2f(slots[r * SLOT] - Mc);  // every slot holds a token: finite
      Lc = fmaf(slots[r * SLOT + 1], w, Lc);
      A = fmaf(slots[r * SLOT + 2 + d], w, A);
    }
    out[d] = __float2bfloat16(A / Lc);  // Lc >= 1: the slot of the max holds p = 1
  }
}

// Lanes of group 0 (4 J lanes) write the warp's partial into part[warp].
template <int J>
__device__ __forceinline__ void store_partial(float* part, const Fold& st, int warp, int lane,
                                              int hd) {
  float* p = part + warp * SLOT;
  if (lane < 4 * J) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (16 * lane + e < hd) p[2 + 16 * lane + e] = st.acc[e];
  }
  if (lane == 0) {
    p[0] = st.m;
    p[1] = st.l;
  }
}

// n bytes from src to shared dst by one warp: 16-byte cp.async copies where both ends are
// 16-byte aligned, 4-byte ones where they are 4-byte aligned, byte loads for the rest.
__device__ __forceinline__ void warp_copy_async(int8_t* dst, const int8_t* __restrict__ src,
                                                int n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  int done = 0;
  if ((a & 15) == 0) {
    const int n16 = n >> 4;
    for (int c = lane; c < n16; c += 32) cp_async16(dst + 16 * c, src + 16 * c);
    done = n16 << 4;
  } else if ((a & 3) == 0) {
    const int n4 = n >> 2;
    for (int c = lane; c < n4; c += 32) cp_async4(dst + 4 * c, src + 4 * c);
    done = n4 << 2;
  }
  for (int c = done + lane; c < n; c += 32) dst[c] = src[c];
}

struct Pool {
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  const int* table;  // this slot's row of the tables
  int h, nh, page, hd;
};

// Page run r of tokens [t0, t1) in a ring slot: the four copies (k, v, k scales, v
// scales) from the pool into the slot.
struct Run {
  int8_t* dst[4];
  const int8_t* src[4];
  int len[4];
};

__device__ __forceinline__ Run page_run(const Tile& T, const Pool& P, int t0, int t1, int r) {
  const int j = t0 / P.page + r;
  const int tok = max(t0, j * P.page), cnt = min(t1, (j + 1) * P.page) - tok, at = tok - t0;
  const long long row =  // the pool row of token tok
      (static_cast<long long>(__ldg(P.table + j)) * P.nh + P.h) * P.page + (tok - j * P.page);
  return {{T.k + at * P.hd, T.v + at * P.hd, reinterpret_cast<int8_t*>(T.ks + at),
           reinterpret_cast<int8_t*>(T.vs + at)},
          {P.k + row * P.hd, P.v + row * P.hd, reinterpret_cast<const int8_t*>(P.ks + row),
           reinterpret_cast<const int8_t*>(P.vs + row)},
          {cnt * P.hd, cnt * P.hd, 4 * cnt, 4 * cnt}};
}

// Page runs of tokens [t0, t1).
__device__ __forceinline__ int page_runs(int t0, int t1, int page) {
  return (t1 - 1) / page - t0 / page + 1;
}

// Tokens [t0, t1) into a ring slot of n tokens by one warp's cp.async copies: one run per
// page for each of k, v and the two scales.
__device__ __forceinline__ void warp_copy_tokens(uint8_t* slot, int n, const Pool& P, int t0,
                                                 int t1, int lane) {
  const Tile T = tile_at(slot, n, P.hd);
  for (int r = 0; r < page_runs(t0, t1, P.page); ++r) {
    const Run R = page_run(T, P, t0, t1, r);
#pragma unroll
    for (int c = 0; c < 4; ++c) warp_copy_async(R.dst[c], R.src[c], R.len[c], lane);
  }
}

// K7: block (rank, head, slot) over tokens [rank * span, (rank + 1) * span) of the slot,
// WARPS warps each folding its warp tiles w, w + WARPS, ... from its own cp.async ring.
template <int J, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_k7(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                const float* __restrict__ ks, const int8_t* __restrict__ v,
                const float* __restrict__ vs, const int* __restrict__ tables,
                const int* __restrict__ pos, __nv_bfloat16* __restrict__ o, int nh, int page,
                int hd, int AP, int span, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long qo = (static_cast<long long>(b) * nh + h) * hd;
  const int n_all = visible(pos, b, AP, page);
  const int t_begin = rank * span;
  if (t_begin >= n_all) {  // past the slot's tokens
    if (n_all == 0 && rank == 0)  // nothing visible (never with pos >= 0): zeros
      for (int d = threadIdx.x; d < hd; d += blockDim.x) o[qo + d] = __float2bfloat16(0.f);
    return;
  }
  cluster_arrive_relaxed();
  const int t_end = min(t_begin + span, n_all), n_valid = (n_all + span - 1) / span;
  const Pool P{k, ks, v, vs, tables + static_cast<long long>(b) * AP, h, nh, page, hd};
  const int SB = tile_bytes(WT, hd);
  uint8_t* ring = smem + HEAD_BYTES + warp * K7_STAGES * SB;
  const int n_wt = (t_end - t_begin + WT - 1) / WT;
  const int mine = warp < n_wt ? (n_wt - warp + WARPS - 1) / WARPS : 0;
  auto issue = [&](int i) {
    const int t0 = t_begin + (warp + WARPS * i) * WT;
    warp_copy_tokens(ring + (i % K7_STAGES) * SB, WT, P, t0, min(t0 + WT, t_end), lane);
  };
#pragma unroll
  for (int i = 0; i < K7_STAGES - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }
  QFrag Q;
  load_q<J>(Q, q + qo, hd, lane);
  Fold st{-INFINITY, 0.f, {}};
  for (int i = 0; i < mine; ++i) {
    if (i + K7_STAGES - 1 < mine) issue(i + K7_STAGES - 1);  // into the slot freed last
    cp_async_commit();
    cp_async_wait<K7_STAGES - 1>();
    __syncwarp();  // every lane's copies of tile i have landed
    const int t0 = t_begin + (warp + WARPS * i) * WT;
    const Tile T = tile_at(ring + (i % K7_STAGES) * SB, WT, hd);
    fold_tile<J, VEC>(st, Q, T.k, T.v, T.ks, T.vs, min(WT, t_end - t0), hd, scale_log2, lane);
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  merge_groups<J>(st);
  float* part = reinterpret_cast<float*>(smem);
  store_partial<J>(part, st, warp, lane, hd);
  __syncthreads();
  finish(part, part + WARPS * SLOT, rank, n_valid, hd, o + qo);
}

// mbarrier helpers (shared::cta addresses).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
// A 1-D TMA bulk copy of n bytes (n % 16 == 0, both ends 16-byte aligned) that completes
// its bytes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool bulk_ok(const void* dst, const void* src, int n) {
  return n > 0 && (n & 15) == 0 &&
         ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
}

// n bytes from src to shared dst by one warp's loads and stores: 4 bytes at a time where
// both ends allow it, else bytes.
__device__ __forceinline__ void warp_copy_sync(int8_t* dst, const int8_t* __restrict__ src, int n,
                                               int lane) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 3) == 0) {
    const int n4 = n >> 2;
    for (int c = lane; c < n4; c += 32)
      reinterpret_cast<uint32_t*>(dst)[c] = __ldg(reinterpret_cast<const uint32_t*>(src) + c);
    done = n4 << 2;
  }
  for (int c = done + lane; c < n; c += 32) dst[c] = src[c];
}

// The producer warp's fill of one ring slot of n tokens with tokens [t0, t1), lane r
// taking page runs r, r + 32, ...: the runs a bulk copy cannot take are copied by the
// warp's lanes first; then lane 0 arrives on full expecting the bulk bytes, and each lane
// issues the bulk copies of its runs, one per run of k, v and each scale.
__device__ __forceinline__ void produce(uint8_t* slot, int n, uint64_t* full, const Pool& P,
                                        int t0, int t1, int lane) {
  const Tile T = tile_at(slot, n, P.hd);
  const int n_runs = page_runs(t0, t1, P.page);
  uint32_t bulk = 0;
  bool rest = false;
  for (int r = lane; r < n_runs; r += 32) {
    const Run R = page_run(T, P, t0, t1, r);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (bulk_ok(R.dst[c], R.src[c], R.len[c])) bulk += R.len[c];
      else rest = true;
    }
  }
  bulk = __reduce_add_sync(0xffffffffu, bulk);
  if (__any_sync(0xffffffffu, rest)) {
    for (int r = 0; r < n_runs; ++r) {
      const Run R = page_run(T, P, t0, t1, r);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!bulk_ok(R.dst[c], R.src[c], R.len[c]))
          warp_copy_sync(R.dst[c], R.src[c], R.len[c], lane);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();  // the lanes' stores come before lane 0's arrive (release)
  if (lane == 0) mbar_arrive_expect_tx(full, bulk);
  __syncwarp();  // and the bytes are expected before any copy can complete
  for (int r = lane; r < n_runs; r += 32) {
    const Run R = page_run(T, P, t0, t1, r);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (bulk_ok(R.dst[c], R.src[c], R.len[c])) bulk_copy(R.dst[c], R.src[c], R.len[c], full);
  }
}

// K8: the same block as K7 with one more warp, the producer, which fills a ring of
// K8_STAGES block tiles (WARPS warp tiles each) by TMA bulk copies; folding warp w takes
// warp tile w of each block tile.
template <int J, bool VEC>
__global__ void __launch_bounds__((WARPS + 1) * 32)
paged_decode_k8(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                const float* __restrict__ ks, const int8_t* __restrict__ v,
                const float* __restrict__ vs, const int* __restrict__ tables,
                const int* __restrict__ pos, __nv_bfloat16* __restrict__ o, int nh, int page,
                int hd, int AP, int span, float scale_log2) {
  constexpr int BT = WARPS * WT;
  extern __shared__ __align__(128) uint8_t smem[];
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long qo = (static_cast<long long>(b) * nh + h) * hd;
  const int n_all = visible(pos, b, AP, page);
  const int t_begin = rank * span;
  if (t_begin >= n_all) {
    if (n_all == 0 && rank == 0)
      for (int d = threadIdx.x; d < hd; d += blockDim.x) o[qo + d] = __float2bfloat16(0.f);
    return;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + HEAD_BYTES);
  uint64_t* empty = full + K8_STAGES;
  uint8_t* ring = smem + HEAD_BYTES + 16 * K8_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K8_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();
  const int t_end = min(t_begin + span, n_all), n_valid = (n_all + span - 1) / span;
  const int SB = tile_bytes(BT, hd);
  const int n_bt = (t_end - t_begin + BT - 1) / BT;
  float* part = reinterpret_cast<float*>(smem);
  if (warp == WARPS) {  // the producer
    const Pool P{k, ks, v, vs, tables + static_cast<long long>(b) * AP, h, nh, page, hd};
    for (int i = 0; i < n_bt; ++i) {
      const int s = i % K8_STAGES, r = i / K8_STAGES;
      if (r > 0) mbar_wait(empty + s, (r - 1) & 1);
      const int t0 = t_begin + i * BT;
      produce(ring + s * SB, BT, full + s, P, t0, min(t0 + BT, t_end), lane);
    }
  } else {
    QFrag Q;
    load_q<J>(Q, q + qo, hd, lane);
    Fold st{-INFINITY, 0.f, {}};
    for (int i = 0; i < n_bt; ++i) {
      const int s = i % K8_STAGES, r = i / K8_STAGES;
      mbar_wait(full + s, r & 1);
      const int n = t_end - (t_begin + i * BT + warp * WT);
      if (n > 0) {
        const Tile T = tile_at(ring + s * SB, BT, hd);
        fold_tile<J, VEC>(st, Q, T.k + warp * WT * hd, T.v + warp * WT * hd, T.ks + warp * WT,
                          T.vs + warp * WT, min(WT, n), hd, scale_log2, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    merge_groups<J>(st);
    store_partial<J>(part, st, warp, lane, hd);
  }
  __syncthreads();
  finish(part, part + WARPS * SLOT, rank, n_valid, hd, o + qo);
}

int k7_smem(int hd) { return HEAD_BYTES + WARPS * K7_STAGES * tile_bytes(WT, hd); }
int k8_smem(int hd) { return HEAD_BYTES + 16 * K8_STAGES + K8_STAGES * tile_bytes(WARPS * WT, hd); }

template <int J, bool VEC>
cudaError_t launch(bool k8, int device, int splits, int nh, int B, int hd, cudaStream_t stream,
                   const __nv_bfloat16* q, const int8_t* k, const float* ks, const int8_t* v,
                   const float* vs, const int* tables, const int* pos, __nv_bfloat16* o, int page,
                   int AP, int span, float scale_log2) {
  constexpr int MAX_DEVICES = 64;
  static bool opted[2][MAX_DEVICES] = {};
  auto kernel = k8 ? paged_decode_k8<J, VEC> : paged_decode_k7<J, VEC>;
  const int hd_max = 64 * J;
  if (device >= MAX_DEVICES || !opted[k8][device]) {  // once a device: the largest hd's ring
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        k8 ? k8_smem(hd_max) : k7_smem(hd_max));
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) opted[k8][device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, nh, B);
  cfg.blockDim = dim3((WARPS + (k8 ? 1 : 0)) * 32, 1, 1);
  cfg.dynamicSmemBytes = k8 ? k8_smem(hd) : k7_smem(hd);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q, k, ks, v, vs, tables, pos, o, nh,
                                             page, hd, AP, span, scale_log2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// q: contiguous (B, nh, hd) bf16; k, v: contiguous (P, nh, page, hd) int8; ks, vs:
// contiguous (P, nh, page) f32; tables: contiguous (B, AP) int32 with entries in [0, P);
// pos: (B,) int32; o: contiguous (B, nh, hd) bf16. hd <= 128. splits (1..8) and span
// from the wrapper's plan: the blocks of a cluster, each over span tokens, a multiple of
// the block tile WARPS * WT, with splits * span covering the AP * page tokens and
// no split empty of them. pipelined: 0 runs K7, 1 K8. device: the CUDA device of the
// tensors and the stream, made current for the launch. A plan the shapes cannot take is
// refused.
int lljt_paged_decode(const void* q, const void* k, const void* ks, const void* v,
                      const void* vs, const void* tables, const void* pos, void* o, int B, int nh,
                      int page, int hd, int AP, int splits, int span, float scale_log2,
                      int pipelined, int device, void* stream) {
  const long long total = static_cast<long long>(AP) * page;
  const int tile = WARPS * WT;
  if (B < 1 || nh < 1 || hd < 1 || hd > MAX_HD || page < 1 || AP < 1 || splits < 1 ||
      splits > MAX_CLUSTER || span < tile || span % tile != 0 ||
      static_cast<long long>(splits) * span < total ||
      static_cast<long long>(splits - 1) * span >= total || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* tp = static_cast<const int*>(tables);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  const bool k8 = pipelined != 0;
  auto run = [&](auto fn) {
    return fn(k8, device, splits, nh, B, hd, st, qp, kp, ksp, vp, vsp, tp, pp, op, page, AP,
              span, scale_log2);
  };
  if (hd % 16) err = run(launch<2, false>);
  else if (hd <= 64) err = run(launch<1, true>);
  else err = run(launch<2, true>);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
