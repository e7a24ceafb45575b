// Dequant-matmuls with int8 activations (W4A8, W8A8, W2A8, W3A8) for Hopper (sm_90a):
// y = sum over k of xq[k] * (q[k] - z) * s, with xq the int8-rounded activation. Shared
// by csrc/quant_matmul_w4a8.cu (the int4 decoder), csrc/quant_matmul_a8.cu (int8 and
// uint8) and csrc/quant_matmul_sub4_a8.cu (int2 and int3).
//
// Numerics (the JAX kernels' int8dot* epilogues, step by step in the plain versions of
//   ops/cuda/quant_matmul.py and ops/cuda/quant_matmul_sub4.py): x is cast to bf16; for
//   each (row, activation group of `group` K elements, laid out by the wrapper's plan
//   from the JAX tile plan) rsx = 127 / max(amax, 1e-30) by IEEE division, xq = round
//   half to even of x * rsx. The int32 sum D of xq * (decoded level) over a group is
//   exact; the group folds into the f32 accumulator as
//   ((D >> SHIFT) - (sum of xq) * (z - zshift)) * (s / rsx), with the group's scale and
//   zero rows. A decoder stores its levels as (q - zshift) << SHIFT: int4 as 16 (q - 8),
//   uint8 as q - 128, int8, int2 and int3 as q.
//
// Two routes, picked by the wrapper (ops/cuda/quant_matmul.py::a8_launch).
//
// The decode route (M <= 16; a8_gemv, planned by a8_gemv_plan): one launch on the caller's
//   stream, nothing allocated but the output, built like the exact GEMV of qmm_gemv.cuh.
//   What bounds it on an H100 is the weight bytes (4096 x 4096 int8 at M = 1: 16.8 MB,
//   5.0 us at 3.35 TB/s) and a fixed cost a launch; the route's design against the four
//   causes that held the first version back:
//   * Loads in flight. Four warps a block of 128 output columns, each warp over its share
//     of the block's k32 steps; each lane loads 16 bytes (columns 16g .. 16g + 15) of each
//     stored row that its K-rows need straight into registers, a batch of F::GU steps
//     issued before the products of the batch before (two register buffers, no copy
//     between them, which would wait for the loads), the first batch before the block
//     rounds x. No weight byte goes through shared memory. At M <= 8 a block keeps to
//     168 registers, so three fit an SM and the clusters of a 7B linear run in one wave.
//   * The operands for decode. The weight is the A operand of mma.sync m16n8k32 s8 (16
//     output columns x 32 K-rows), x̂ the B operand (32 K-rows x 8 rows of x; a second
//     product for rows 9-16), so a decode step wastes B's padding rows, not A's. K and N
//     are permuted inside a step: lane (g, t) = (lane / 4, lane % 4) supplies A rows g and
//     g + 8 as columns 16g + 2j and 16g + 2j + 1 of mma j, and its K bytes 4t.. and
//     16 + 4t.. as K-rows 8t .. 8t + 3 and 8t + 4 .. 8t + 7 of the step; so a lane's loads
//     are its own A fragments (F::gfrag decodes them in registers: int8 by a 4x4 byte
//     transpose, int4 by fused_quad, int2 and int3 by spread2), and its B fragment is one
//     8-byte load of x̂'s row g from shared memory.
//   * The quantize pass, fused. Each block rounds the activation groups that its steps
//     reach, with the operations of a8_quantize: their K-rows, 8 a lane, dealt to the
//     warps in units of 32 lanes of one (group, row); a pass for each group's amax over
//     all of it, a pass for the levels with rsx = 127 / amax by IEEE division and their
//     sums, which stages the levels of the block's steps in shared memory (zero past the
//     groups). Every block rounds a group with the same operations, so every block holds
//     the same levels.
//   * Split K in one launch, over k32 steps, not groups. The K splits of a column tile are
//     the blocks of one thread-block cluster (at most 8). A step that two groups share
//     (groups off 32 K, as the 125M's 60) runs once for each, the x̂ bytes outside the
//     group masked. Each warp adds its int32 sums D of a (group, row, column) into its
//     block's shared memory when it leaves the group (|x̂| <= 127, |level| <= 128 and at
//     most MAX_GROUP K-rows a group keep them exact). Then block r of the cluster folds
//     its share of the tile's (row, column) elements: for each group, D summed over the
//     blocks that hold it (distributed shared memory), ((D >> SHIFT) - S (z - zshift)) *
//     (s / rsx) in f32, added in group order; a thread an element with its sum in a
//     register where the share has 128 elements or more, else every thread computes
//     parts into shared memory and a thread an element adds them in order. So the bits
//     depend neither on the split nor on the launch, and there is no workspace and no
//     second kernel.
//   A debugging pointer (levels, null from the wrappers) receives x̂, rsx and the level
//   sums from the blocks of column tile 0, for the chip check of the rounding.
//
// Above 16 rows (a8_quantize, a8_mma, a8_merge; planned by a8_launch_plan), three
// launches:
//   1. a8_quantize: one block per (activation group, row) writes xq (Mpad, Kpad) int8
//      (zero past K, past the groups and on the pad rows), rsx and the group's level sum.
//   2. a8_mma: one warp a block, 32 output columns, up to 4 row tiles of 16, over a
//      range of activation groups (the split). mma.sync m16n8k32 s8 x s8 -> s32: A is xq
//      (16 rows x 32 K a tile, loaded straight from the row-major buffer), B the weight
//      decoded in registers from the stored rows that the warp copies through shared
//      memory, F::U k32 steps a batch. A group that does not start or end on a multiple
//      of 32 K (60 and 780 at the 125M shapes) runs its edge steps with the A bytes
//      outside the group zeroed, so a step shared by two groups runs once for each. The
//      int32 sums fold into f32 at every group's end.
//   3. a8_merge (when the groups split): the splits' f32 partials summed in split order,
//      so two launches give equal bits.
//   It is simple, not fast: one warp a block, byte reads of the stored tile from shared
//   memory, no cp.async ring.
//
// A decoder F gives, for the route above 16 rows: PLANES (1 or 2 stored arrays),
//   ROWS0/ROWS1 (stored rows of each that one k32 step reads), U (k32 steps a batch),
//   SHIFT, and frag(tile, u, h, t, c): the B register of column c, K-rows 32 u + 16 h +
//   4 t .. + 3 of the batch, from the batch's shared tiles (plane 0's U * ROWS0 rows of 32
//   bytes, then plane 1's). For the decode route: GLOADS (16-byte loads a lane a k32
//   step), GU (k32 steps a batch), grow(s, t, i) and gplane(i) (the stored row and plane
//   of load i of step s for lanes t), and gfrag(w, j, a): mma j's A fragment from the
//   step's loads.
#pragma once
#include "common.cuh"
#include "qmm_gemv.cuh"

#include <cooperative_groups.h>

namespace a8 {

constexpr int COLS = 32;  // output columns a block
constexpr int QTHREADS = 128;

__device__ __forceinline__ void mma_s8_16832(int d[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bytes of the word at K-rows kb .. kb+3 that lie in [k0, k1), as a mask.
__device__ __forceinline__ uint32_t keep_bytes(int kb, int k0, int k1) {
  const int lo = min(max(k0 - kb, 0), 4), hi = min(max(k1 - kb, 0), 4);
  if (hi <= lo) return 0u;
  return static_cast<uint32_t>(((1ull << (8 * hi)) - 1) ^ ((1ull << (8 * lo)) - 1));
}

// One block per (group j, row m): the group's K elements [j group, (j + 1) group) of x
// (zero at k >= K) rounded to int8 levels. Kread = n_act * group.
__global__ void __launch_bounds__(QTHREADS)
    a8_quantize(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                float* __restrict__ rsx, int* __restrict__ sx, int M, int K, int Kpad,
                int group, int n_act) {
  const int j = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = j * group, k1 = k0 + group;
  int8_t* qrow = xq + static_cast<size_t>(m) * Kpad;
  __shared__ float red_f[QTHREADS / 32];
  __shared__ int red_i[QTHREADS / 32];
  if (j == n_act - 1)
    for (int k = k1 + tid; k < Kpad; k += QTHREADS) qrow[k] = 0;
  if (m >= M) {  // a pad row: zeros, and a finite 1 / rsx
    for (int k = k0 + tid; k < k1; k += QTHREADS) qrow[k] = 0;
    if (tid == 0) {
      rsx[m * n_act + j] = 1.f;
      sx[m * n_act + j] = 0;
    }
    return;
  }
  const __nv_bfloat16* xrow = x + static_cast<size_t>(m) * K;
  float amax = 0.f;
  for (int k = k0 + tid; k < min(k1, K); k += QTHREADS)
    amax = fmaxf(amax, fabsf(__bfloat162float(xrow[k])));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red_f[warp] = amax;
  __syncthreads();
  amax = red_f[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, red_f[w]);
  const float r = __fdiv_rn(127.f, fmaxf(amax, 1e-30f));  // IEEE, as the JAX kernels
  int sum = 0;
  for (int k = k0 + tid; k < k1; k += QTHREADS) {
    const float v = k < K ? __bfloat162float(xrow[k]) : 0.f;
    const int q = __float2int_rn(__fmul_rn(v, r));  // half to even
    qrow[k] = static_cast<int8_t>(q);
    sum += q;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red_i[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < QTHREADS / 32; ++w) total += red_i[w];
    rsx[m * n_act + j] = r;
    sx[m * n_act + j] = total;
  }
}

__device__ __forceinline__ void store_out(void* out, bool f32, size_t idx, float v) {
  if (f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
}

// 16 bytes of a stored row at columns col .. col + 15 (zero past N), by one 16-byte load
// (vec) or byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* src, int col, int N, bool vec) {
  if (vec) return col < N ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
  uint8_t b[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = col + i < N ? __ldg(src + i) : uint8_t(0);
  return make_uint4(b[0] | b[1] << 8 | b[2] << 16 | static_cast<uint32_t>(b[3]) << 24,
                    b[4] | b[5] << 8 | b[6] << 16 | static_cast<uint32_t>(b[7]) << 24,
                    b[8] | b[9] << 8 | b[10] << 16 | static_cast<uint32_t>(b[11]) << 24,
                    b[12] | b[13] << 8 | b[14] << 16 | static_cast<uint32_t>(b[15]) << 24);
}

// The batch's stored rows of one plane, ROWS a k32 step, steps sb .. sb + U - 1 (rows of
// steps at or past s1, past the plane's `rows` and columns past N as 0), into its shared
// tile: 16-byte chunk i of the batch is row i / 2, bytes 16 (i % 2) .. + 15.
template <int ROWS, int U>
__device__ __forceinline__ void stage_plane(uint8_t* tile, const uint8_t* __restrict__ w,
                                            int rows, int N, int c0, int sb, int s1, bool vec,
                                            int lane) {
  constexpr int PER_LANE = U * ROWS / 16;
  uint4 v[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int chunk = lane + 32 * i, r = chunk >> 1, col = c0 + (chunk & 1) * 16;
    const int row = sb * ROWS + r;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (sb + r / ROWS < s1 && row < rows) v[i] = load16(w + static_cast<size_t>(row) * N + col, col, N, vec);
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int chunk = lane + 32 * i;
    *reinterpret_cast<uint4*>(tile + (chunk >> 1) * COLS + (chunk & 1) * 16) = v[i];
  }
}

// One block: output columns c0 .. c0+31, rows r0 .. r0 + 16 MT - 1 of x̂, activation
// groups [j0, j1) of split blockIdx.y. Lane (g, t) = (lane / 4, lane % 4) holds the
// m16n8k32 fragments: A rows g and g+8, K bytes 4t.. and 16+4t..; B column g, K rows
// 4t.. and 16+4t..; C rows g and g+8, columns 2t and 2t+1.
template <class F, int MT>
__global__ void __launch_bounds__(32)
    a8_mma(const int8_t* __restrict__ xq, const float* __restrict__ rsx,
           const int* __restrict__ sx, const uint8_t* __restrict__ w0,
           const uint8_t* __restrict__ w1, int rows0, int rows1,
           const float* __restrict__ scales, const float* __restrict__ zeros, float zshift,
           void* __restrict__ out, float* __restrict__ ws, int M, int Mpad, int Kpad, int N,
           int group, int n_act, int rep, int ksplit, int out_f32, int vec) {
  constexpr int U = F::U;
  __shared__ __align__(16) uint8_t tile[U * (F::ROWS0 + F::ROWS1) * COLS];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * COLS, split = blockIdx.y, r0 = blockIdx.z * 16 * MT;
  const int j0 = static_cast<int>(static_cast<long long>(split) * n_act / ksplit);
  const int j1 = static_cast<int>(static_cast<long long>(split + 1) * n_act / ksplit);
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][jn][i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * group, k1 = k0 + group;
    const int s0 = k0 >> 5, s1 = (k1 + 31) >> 5;
    const bool whole = ((k0 | k1) & 31) == 0;
    int d[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[mt][jn][i] = 0;

    for (int sb = s0; sb < s1; sb += U) {
      __syncwarp();
      stage_plane<F::ROWS0, U>(tile, w0, rows0, N, c0, sb, s1, vec, lane);
      if constexpr (F::PLANES == 2)
        stage_plane<F::ROWS1, U>(tile + U * F::ROWS0 * COLS, w1, rows1, N, c0, sb, s1, vec, lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (sb + u >= s1) break;
        const int kb = 32 * (sb + u);
        uint32_t b[4][2];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          b[jn][0] = F::frag(tile, u, 0, t, 8 * jn + g);
          b[jn][1] = F::frag(tile, u, 1, t, 8 * jn + g);
        }
        uint32_t m_lo = 0xffffffffu, m_hi = 0xffffffffu;
        if (!whole) {
          m_lo = keep_bytes(kb + 4 * t, k0, k1);
          m_hi = keep_bytes(kb + 16 + 4 * t, k0, k1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int8_t* xa = xq + static_cast<size_t>(r0 + 16 * mt + g) * Kpad + kb + 4 * t;
          const size_t down = static_cast<size_t>(8) * Kpad;
          uint32_t a[4];
          a[0] = __ldg(reinterpret_cast<const uint32_t*>(xa)) & m_lo;
          a[1] = __ldg(reinterpret_cast<const uint32_t*>(xa + down)) & m_lo;
          a[2] = __ldg(reinterpret_cast<const uint32_t*>(xa + 16)) & m_hi;
          a[3] = __ldg(reinterpret_cast<const uint32_t*>(xa + down + 16)) & m_hi;
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) mma_s8_16832(d[mt][jn], a, b[jn][0], b[jn][1]);
        }
      }
    }
    // fold group j: ((D >> SHIFT) - S (z - zshift)) * (s / rsx), columns past N read as
    // s = 0
    const int srow = j / rep;
    float sc[4][2], zc[4][2];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * jn + 2 * t + e;
        sc[jn][e] = c < N ? __ldg(scales + static_cast<size_t>(srow) * N + c) : 0.f;
        zc[jn][e] = c < N ? __ldg(zeros + static_cast<size_t>(srow) * N + c) - zshift : 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * mt + g + 8 * h;
        const float rr = __ldg(rsx + r * n_act + j);
        const float S = static_cast<float>(__ldg(sx + r * n_act + j));
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dd = static_cast<float>(d[mt][jn][2 * h + e] >> F::SHIFT);
            const float part = __fmul_rn(__fsub_rn(dd, __fmul_rn(S, zc[jn][e])),
                                         __fdiv_rn(sc[jn][e], rr));
            acc[mt][jn][2 * h + e] = __fadd_rn(acc[mt][jn][2 * h + e], part);
          }
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * mt + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * jn + 2 * t + e;
          if (c >= N) continue;
          const float v = acc[mt][jn][2 * h + e];
          if (ksplit == 1)
            store_out(out, out_f32, static_cast<size_t>(r) * N + c, v);
          else
            ws[(static_cast<size_t>(split) * Mpad + r) * N + c] = v;
        }
    }
}

// out = the splits' partials summed in split order.
__global__ void a8_merge(const float* __restrict__ ws, void* __restrict__ out, int M, int Mpad,
                         int N, int ksplit, int out_f32) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(M) * N) return;
  const size_t plane = static_cast<size_t>(Mpad) * N;
  float s = 0.f;
  for (int p = 0; p < ksplit; ++p) s = __fadd_rn(s, ws[p * plane + i]);
  store_out(out, out_f32, i, s);
}

// The arguments every entry point hands to `launch`: the wrapper's plan and scratch.
struct Args {
  const void* x;
  const uint8_t* w0;
  const uint8_t* w1;
  int rows0, rows1;  // stored rows of each plane
  const float* scales;
  const float* zeros;
  float zshift;
  void* out;
  void* xq;
  void* rsx;
  void* sx;
  void* ws;
  int M, K, N, group, n_act, rep, mt, ksplit, out_f32, vec;
};

// The three launches for decoder F. group * n_act >= K (the groups may cover stored pad
// rows past K, where x reads as 0); Kpad = group * n_act rounded up to 32, Mpad = M
// rounded up to 16 mt.
template <class F>
int launch(const Args& a, cudaStream_t st) {
  if (a.group <= 0 || static_cast<long long>(a.group) * a.n_act < a.K || a.mt < 1 || a.mt > 4 ||
      a.ksplit < 1 || a.ksplit > a.n_act || a.rep < 1 || (a.ksplit > 1 && a.ws == nullptr) ||
      a.M <= 0 || a.N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kpad = (a.group * a.n_act + 31) / 32 * 32;
  const int Mpad = (a.M + 16 * a.mt - 1) / (16 * a.mt) * (16 * a.mt);
  auto* q8 = static_cast<int8_t*>(a.xq);
  auto* r = static_cast<float*>(a.rsx);
  auto* s8 = static_cast<int*>(a.sx);
  a8_quantize<<<dim3(a.n_act, Mpad), QTHREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(a.x),
                                                         q8, r, s8, a.M, a.K, Kpad, a.group,
                                                         a.n_act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + COLS - 1) / COLS, a.ksplit, Mpad / (16 * a.mt));
  auto* wsp = static_cast<float*>(a.ws);
#define A8_MMA(MT)                                                                           \
  a8_mma<F, MT><<<grid, 32, 0, st>>>(q8, r, s8, a.w0, a.w1, a.rows0, a.rows1, a.scales,     \
                                     a.zeros, a.zshift, a.out, wsp, a.M, Mpad, Kpad, a.N,     \
                                     a.group, a.n_act, a.rep, a.ksplit, a.out_f32, a.vec)
  switch (a.mt) {
    case 1: A8_MMA(1); break;
    case 2: A8_MMA(2); break;
    case 3: A8_MMA(3); break;
    default: A8_MMA(4); break;
  }
#undef A8_MMA
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ksplit == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(a.M) * a.N;
  a8_merge<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(wsp, a.out, a.M, Mpad, a.N,
                                                                   a.ksplit, a.out_f32);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------------------
// The decode route (M <= 16)
// ---------------------------------------------------------------------------------------

constexpr int GCOLS = qmmv::COLS;       // output columns a block: 8 lane groups of 16
constexpr int GWARPS = qmmv::WARPS;     // warps a block, each over its share of the steps
constexpr int GTHREADS = qmmv::THREADS;
constexpr int MAX_CLUSTER = qmmv::MAX_CLUSTER;
constexpr int MAX_GROUP = 1 << 17;      // K-rows a group: 127 * 128 * 2^17 < 2^31
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block can have
constexpr int FOLD_FLOATS = 2048;       // the parts of the fold in groups, at least
constexpr int FOLD_BY_PARTS = GTHREADS; // blocks with fewer elements fold in parts

// Shared memory of a block of a8_gemv (the wrapper's a8_gemv_smem computes the same):
// D int32 [ng][MT * 8 * GCOLS] in the lane-major fragment layout of the exact GEMV's
// partial sums (qmmv::y_at: a warp's atomic adds fall on 32 banks), rsx f32 [ng][M],
// level sums int32 [ng][M], then one region that holds x̂ of the block's steps (M rows of
// xs bytes), later the fold's tables (each block's first group; each group's blocks and
// scale row, and every row's rsx and level sum), sums and parts.
struct GemvSmem {
  int ng;      // activation groups that a block's steps reach, at most
  int slot;    // ints of D a group: MT * 8 rows of GCOLS
  int xs;      // bytes a staged row: 32 steps rounded up to 128, + 32, which is 32 mod
               // 128, so the 8-byte B loads of a half-warp (rows g .. g + 3, 32 bytes
               // each) fall on 32 banks
  int share;   // output elements (column, row) of the tile that a block folds
  int tables;  // floats of the fold's tables
  int region;  // bytes of the last region
  __host__ __device__ GemvSmem(int M, int steps, int group, int n_act, int ksplit) {
    const int reach = (32 * steps + group - 2) / group + 1;
    ng = reach < n_act ? reach : n_act;
    slot = (M <= 8 ? 8 : 16) * GCOLS;
    xs = (32 * steps + 127) / 128 * 128 + 32;
    share = (M * GCOLS + ksplit - 1) / ksplit;
    tables = MAX_CLUSTER + (2 * M + 1) * n_act;
    const int fold = 4 * (tables + share + FOLD_FLOATS);
    region = M * xs > fold ? M * xs : fold;
  }
  __host__ __device__ int bytes(int M) const { return ng * (4 * slot + 8 * M) + region; }
};

// The eight bf16 of a 16-byte load as floats (a bf16 is the high half of its float).
__device__ __forceinline__ void bf16x8(const uint4& v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 16 bytes of a stored row at columns col .. col + 15 (zero past N): one 16-byte load
// streamed past L1 (VEC), or 4-byte loads (lw 4: N % 4 == 0) or byte loads.
template <bool VEC>
__device__ __forceinline__ uint4 load_cols(const uint8_t* row, int col, int N, int lw) {
  if (VEC) return col < N ? qmmv::ld_stream16(row + col) : make_uint4(0u, 0u, 0u, 0u);
  uint32_t v[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int c = col + 4 * h;
    if (lw == 4) {
      v[h] = c < N ? __ldg(reinterpret_cast<const uint32_t*>(row + c)) : 0u;
    } else {
      v[h] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b < N) v[h] |= static_cast<uint32_t>(__ldg(row + c + b)) << (8 * b);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One block: output columns blockIdx.y * 128 .. + 127, k32 steps [rank steps, (rank + 1)
// steps) of the k_read = group * n_act K-rows that the activation groups cover, rank =
// blockIdx.x in a cluster of gridDim.x blocks. MT n8 products (rows 1-8, 9-16). rows0,
// rows1: stored rows of each plane (loads past them read 0).
template <class F, int MT, bool VEC>
__global__ void __launch_bounds__(GTHREADS, MT == 1 ? 3 : 1)  // MT 1: clusters of 8 in one wave
    a8_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w0,
            const uint8_t* __restrict__ w1, int rows0, int rows1,
            const float* __restrict__ scales, const float* __restrict__ zeros, float zshift,
            void* __restrict__ out, uint8_t* __restrict__ levels, int M, int K, int N,
            int group, int n_act, int rep, int steps, int lw, int out_f32) {
  constexpr int U = F::GU, L = F::GLOADS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ksplit = gridDim.x, rank = blockIdx.x;
  const GemvSmem lay(M, steps, group, n_act, ksplit);
  int* dl = reinterpret_cast<int*>(smem);                         // [ng][slot]
  float* rs = reinterpret_cast<float*>(dl + lay.ng * lay.slot);   // [ng][M]
  int* sxs = reinterpret_cast<int*>(rs + lay.ng * M);             // [ng][M]
  uint8_t* region = reinterpret_cast<uint8_t*>(sxs + lay.ng * M);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int k_read = group * n_act, S = (k_read + 31) >> 5;
  const int sb0 = rank * steps, sb1 = min(S, sb0 + steps);
  const int jb0 = 32 * sb0 / group;                        // the block's first group
  const int ngl = (min(32 * sb1, k_read) - 1) / group + 1 - jb0;
  const int col0 = blockIdx.y * GCOLS, col = col0 + 16 * g;
  const bool dbg = levels != nullptr && blockIdx.y == 0;
  const int kpad = 32 * S;

  auto load_batch = [&](uint4 (&w)[U][L], int s0, int we) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int r = F::grow(s0 + u, t, i);
        const bool p1 = F::gplane(i);
        w[u][i] = s0 + u < we && r < (p1 ? rows1 : rows0)
                      ? load_cols<VEC>((p1 ? w1 : w0) + static_cast<size_t>(r) * N, col, N, lw)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
  };

  int d[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][j][i] = 0;
  int cur = -1, ck0 = 0, ck1 = 0;  // the group being summed and its K-rows [ck0, ck1)

  // the warp's sums of group cur into the block's D; accumulator i of mma j of product mt
  // is column 16g + 2j + (i >> 1), row 8 mt + 2t + (i & 1), at qmmv::y_at(mt, j, i, lane)
  auto flush = [&]() {
    if (cur < 0) return;
    int* dst = dl + (cur - jb0) * lay.slot;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (8 * mt + 2 * t + (i & 1) < M)
            atomicAdd(dst + qmmv::y_at(mt, j, i, lane), d[mt][j][i]);
          d[mt][j][i] = 0;
        }
  };
  auto enter = [&](int j) {
    if (j == cur) return;
    flush();
    cur = j;
    ck0 = j * group;
    ck1 = ck0 + group;
  };
  auto product = [&](const uint4 (&w)[L], const uint32_t (&b)[MT][2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t a[4];
      F::gfrag(w, j, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8_16832(d[mt][j], a, b[mt][0], b[mt][1]);
    }
  };
  // steps s0 .. s0 + U - 1 (those below we); a step that reaches past the group being
  // summed runs once for each group it reaches, x̂ masked to the group's K-rows (one
  // product a step in the code, so the loop stays small)
  auto compute = [&](const uint4 (&w)[U][L], int s0, int we) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s >= we) break;
      const int kb = 32 * s, kend = min(kb + 32, k_read);
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = 8 * mt + g;
        const uint2 v = r < M ? *reinterpret_cast<const uint2*>(region + r * lay.xs +
                                                                32 * (s - sb0) + 8 * t)
                              : make_uint2(0u, 0u);
        b[mt][0] = v.x;
        b[mt][1] = v.y;
      }
      const bool inside = kb >= ck0 && kend <= ck1;
      int j = inside ? cur : kb / group;
      const int jz = inside ? cur : (kend - 1) / group;
      for (;;) {
        enter(j);
        uint32_t mlo = 0xffffffffu, mhi = 0xffffffffu;
        if (!inside) {
          mlo = keep_bytes(kb + 8 * t, ck0, ck1);
          mhi = keep_bytes(kb + 8 * t + 4, ck0, ck1);
        }
        uint32_t bm[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          bm[mt][0] = b[mt][0] & mlo;
          bm[mt][1] = b[mt][1] & mhi;
        }
        product(w[u], bm);
        if (j == jz) break;
        ++j;
      }
    }
  };

  // The rounding of the groups [jb0, jb0 + ngl): units of 32 pieces (8 K-rows each, or 1
  // where K or the group is not a multiple of 8) of one (group, row), dealt to the warps
  // in turn, BQ of them loaded before the first is used. Pass 0 takes each group's amax
  // (into rs, as bits); pass 1 rounds with 127 / amax, adds the levels into sxs and
  // stages those of the block's steps; then rs becomes rsx.
  constexpr int BQ = 4;
  const int pw = (K & 7) == 0 && (group & 7) == 0 ? 8 : 1;
  const int upg = (group / pw + 31) / 32;  // units a (group, row)
  const int units = ngl * M * upg;
  auto quantize = [&](int pass) {
    for (int u0 = 0; u0 < units; u0 += GWARPS * BQ) {
      uint4 raw[BQ];
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        const int u = u0 + q * GWARPS + warp, pr = u / upg;
        const int m = pr % M, k0 = (jb0 + pr / M) * group;
        const int k = k0 + pw * (32 * (u - pr * upg) + lane);
        raw[q] = make_uint4(0u, 0u, 0u, 0u);
        if (u < units && k < min(k0 + group, K)) {
          const __nv_bfloat16* xr = x + static_cast<size_t>(m) * K + k;
          if (pw == 8)
            raw[q] = __ldg(reinterpret_cast<const uint4*>(xr));
          else
            raw[q].y = static_cast<uint32_t>(__bfloat16_as_ushort(*xr)) << 16;  // bf16x8's v[3]
        }
      }
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        const int u = u0 + q * GWARPS + warp, pr = u / upg;
        if (u >= units) break;  // uniform in the warp
        const int m = pr % M, jl = pr / M;
        const int k = (jb0 + jl) * group + pw * (32 * (u - pr * upg) + lane);
        float v[8];
        bf16x8(raw[q], v);
        if (pass == 0) {
          float mx = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(v[i]));
#pragma unroll
          for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          if (lane == 0)
            atomicMax(reinterpret_cast<unsigned*>(rs) + jl * M + m, __float_as_uint(mx));
          continue;
        }
        const float r = __fdiv_rn(127.f, fmaxf(rs[jl * M + m], 1e-30f));  // IEEE, as JAX
        uint32_t qw[2] = {0u, 0u};
        int sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int lv = __float2int_rn(__fmul_rn(v[i], r));  // half to even; 0 where v is
          sum += lv;
          qw[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(lv)) << (8 * (i & 3));
        }
        if (pw == 1) qw[0] >>= 24;  // the one level sits in v[3]
#pragma unroll
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) atomicAdd(sxs + jl * M + m, sum);
        if (k >= min((jb0 + jl + 1) * group, K) || k < 32 * sb0 || k >= 32 * sb1) continue;
        auto put = [&](uint8_t* dst) {
          if (pw == 8)
            *reinterpret_cast<uint2*>(dst) = make_uint2(qw[0], qw[1]);
          else
            *dst = static_cast<uint8_t>(qw[0]);
        };
        put(region + m * lay.xs + (k - 32 * sb0));
        if (dbg) put(levels + static_cast<size_t>(m) * kpad + k);
      }
    }
  };

  const int per = (sb1 - sb0 + GWARPS * U - 1) / (GWARPS * U) * U;  // whole batches
  const int wb = min(sb1, sb0 + warp * per), we = min(sb1, wb + per);
  uint4 wa[U][L], wn[U][L];  // two batches: one multiplied while the other is in flight
  load_batch(wa, wb, we);  // in flight while the block rounds x
  for (int e = tid; e < ngl * lay.slot; e += GTHREADS) dl[e] = 0;
  for (int e = tid; e < ngl * M; e += GTHREADS) {
    rs[e] = 0.f;
    sxs[e] = 0;
  }
  for (int e = tid; e < M * lay.xs / 4; e += GTHREADS) reinterpret_cast<uint32_t*>(region)[e] = 0u;
  if (dbg)  // the check's levels past K, which no piece writes
    for (int e = tid; e < M * 32 * (sb1 - sb0); e += GTHREADS) {
      const int m = e / (32 * (sb1 - sb0)), k = 32 * sb0 + e % (32 * (sb1 - sb0));
      if (k >= K) levels[static_cast<size_t>(m) * kpad + k] = 0;
    }
  __syncthreads();
  quantize(0);
  __syncthreads();
  quantize(1);
  __syncthreads();
  for (int e = tid; e < ngl * M; e += GTHREADS) rs[e] = __fdiv_rn(127.f, fmaxf(rs[e], 1e-30f));
  __syncthreads();
  if (dbg)
    for (int e = tid; e < ngl * M; e += GTHREADS) {
      const int m = e % M, j = jb0 + e / M;
      float* drs = reinterpret_cast<float*>(levels + static_cast<size_t>(M) * kpad);
      drs[m * n_act + j] = rs[e];
      reinterpret_cast<int*>(drs + M * n_act)[m * n_act + j] = sxs[e];
    }
  for (int s0 = wb; s0 < we; s0 += 2 * U) {  // no copy between the buffers: it would wait
    load_batch(wn, s0 + U, we);
    compute(wa, s0, we);
    load_batch(wa, s0 + 2 * U, we);
    compute(wn, s0 + U, we);
  }
  flush();
  __syncthreads();

  // every block's D is complete: the elements e = c M + m (column c, row m) of the block's
  // share [e0, e0 + nm) of the tile fold every group in group order. With at least
  // FOLD_BY_PARTS elements a thread an element does, its sum in a register; with fewer
  // (decode), thread (ei, ji) of an EP x JP grid computes the parts of elements ei, ei +
  // EP, .. and groups ji, ji + JP, .. of up to jn groups at a time, then a thread an
  // element adds them in order. Each block's first group, each group's blocks and scale
  // row, and every group's rsx and level sums are tabled in shared memory first.
  const int e0 = rank * lay.share;
  const int nm = max(0, min(M * GCOLS, e0 + lay.share) - e0);
  int* jbt = reinterpret_cast<int*>(region);  // [ksplit]: each block's jb0
  int* gtab = jbt + MAX_CLUSTER;  // [n_act]: first block | last block << 4 | scale row << 8
  float* rsa = reinterpret_cast<float*>(gtab + n_act);  // [n_act][M]
  int* sxa = reinterpret_cast<int*>(rsa + n_act * M);   // [n_act][M]
  float* acc = reinterpret_cast<float*>(sxa + n_act * M);  // [nm]
  float* part = acc + lay.share;                           // [jn][nm]
  if (tid < ksplit) jbt[tid] = 32 * tid * steps / group;
  for (int j = tid; j < n_act; j += GTHREADS)
    gtab[j] = j * group / 32 / steps | ((j + 1) * group - 1) / 32 / steps << 4 | (j / rep) << 8;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  qmmv::cluster_arrive_release();  // also orders the tables for this block's threads
  qmmv::cluster_wait();
  constexpr int B = 4;  // remote loads a thread issues before it uses the first
  for (int b0 = 0; b0 < n_act * M; b0 += B * GTHREADS) {  // from each group's first block
    float r[B];
    int sm[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int idx = b0 + q * GTHREADS + tid;
      if (idx < n_act * M) {
        const int j = idx / M, bf = gtab[j] & 15, at = (j - jbt[bf]) * M + idx % M;
        r[q] = cluster.map_shared_rank(rs, bf)[at];
        sm[q] = cluster.map_shared_rank(sxs, bf)[at];
      }
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int idx = b0 + q * GTHREADS + tid;
      if (idx < n_act * M) {
        rsa[idx] = r[q];
        sxa[idx] = sm[q];
      }
    }
  }
  // group j's part of element (m, c), D at `at` of its slots
  auto fold_part = [&](int j, int m, int at, int n) {
    const int tab = gtab[j], bf = tab & 15, bl = (tab >> 4) & 15;
    int ds = cluster.map_shared_rank(dl, bf)[(j - jbt[bf]) * lay.slot + at];
    for (int b = bf + 1; b <= bl; ++b)
      ds += cluster.map_shared_rank(dl, b)[(j - jbt[b]) * lay.slot + at];
    const float sc = n < N ? __ldg(scales + static_cast<size_t>(tab >> 8) * N + n) : 0.f;
    const float zc = n < N ? __ldg(zeros + static_cast<size_t>(tab >> 8) * N + n) - zshift : 0.f;
    return __fmul_rn(__fsub_rn(static_cast<float>(ds >> F::SHIFT),
                               __fmul_rn(static_cast<float>(sxa[j * M + m]), zc)),
                     __fdiv_rn(sc, rsa[j * M + m]));
  };
  __syncthreads();
  if (nm >= FOLD_BY_PARTS) {
    for (int e = tid; e < nm; e += GTHREADS) {
      const int c = (e0 + e) / M, m = e0 + e - c * M, n = col0 + c;
      const int at = qmmv::y_at_mc(m, c);
      float a = 0.f;
#pragma unroll 4
      for (int j = 0; j < n_act; ++j) a = __fadd_rn(a, fold_part(j, m, at, n));
      if (n < N) store_out(out, out_f32, static_cast<size_t>(m) * N + n, a);
    }
  } else {
    const int jn = max(1, (lay.region / 4 - lay.tables - lay.share) / max(nm, 1));
    const int EP = min(max(nm, 1), GTHREADS), JP = GTHREADS / EP;
    const int ei = tid % EP, ji = tid / EP;
    for (int e = tid; e < nm; e += GTHREADS) acc[e] = 0.f;
    for (int jc = 0; jc < n_act; jc += jn) {
      const int je = min(n_act, jc + jn);
      if (ji < JP)
        for (int e = ei; e < nm; e += EP) {
          const int c = (e0 + e) / M, m = e0 + e - c * M;
          const int at = qmmv::y_at_mc(m, c);
          for (int j = jc + ji; j < je; j += JP)
            part[(j - jc) * nm + e] = fold_part(j, m, at, col0 + c);
        }
      __syncthreads();
      for (int e = tid; e < nm; e += GTHREADS) {
        float a = acc[e];
        for (int jj = 0; jj < je - jc; ++jj) a = __fadd_rn(a, part[jj * nm + e]);
        acc[e] = a;
      }
      __syncthreads();
    }
    for (int e = tid; e < nm; e += GTHREADS) {
      const int c = (e0 + e) / M, m = e0 + e - c * M, n = col0 + c;
      if (n < N) store_out(out, out_f32, static_cast<size_t>(m) * N + n, acc[e]);
    }
  }
  qmmv::cluster_arrive_relaxed();  // no block leaves while another reads its shared memory
  qmmv::cluster_wait();
}

// The arguments every decode-route entry point hands to `launch_gemv`.
struct GemvArgs {
  const void* x;
  const uint8_t* w0;
  const uint8_t* w1;
  int rows0, rows1;  // stored rows of each plane
  const float* scales;
  const float* zeros;
  float zshift;
  void* out;
  void* levels;  // null, or x̂ (M, 32 S) int8, rsx (M, n_act) f32, sums (M, n_act) int32
  int M, K, N, group, n_act, rep, ksplit, steps, lw, out_f32;
};

template <class F, int MT, bool VEC>
cudaError_t launch_gemv_as(const GemvArgs& a, int smem, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = qmmv::opt_in(a8_gemv<F, MT, VEC>, SMEM_MAX, done);
  if (err != cudaSuccess) return err;
  return qmmv::launch_cluster(a8_gemv<F, MT, VEC>, smem, a.ksplit, a.N, st,
                              static_cast<const __nv_bfloat16*>(a.x), a.w0, a.w1, a.rows0,
                              a.rows1, a.scales, a.zeros, a.zshift, a.out,
                              static_cast<uint8_t*>(a.levels), a.M, a.K, a.N, a.group,
                              a.n_act, a.rep, a.steps, a.lw, a.out_f32);
}

// The decode route for decoder F: 1 <= M <= 16, K <= group * n_act (K-rows past K read x
// as 0), ksplit blocks of `steps` k32 steps covering the groups, lw 16, 4 or 1 (the
// widest load that N and the planes' bases allow). A plan that the shapes or pointers
// cannot take is refused.
template <class F>
int launch_gemv(const GemvArgs& a, cudaStream_t st) {
  const long long k_read = static_cast<long long>(a.group) * a.n_act;
  const long long S = (k_read + 31) / 32;
  const bool w_ok = a.lw == 1 || ((a.lw == 4 || a.lw == 16) && a.N % a.lw == 0 &&
                                  qmmv::aligned_to(a.w0, a.lw) && qmmv::aligned_to(a.w1, a.lw));
  if (a.M < 1 || a.M > 16 || a.K < 1 || a.N < 1 || a.group < 1 || a.group > MAX_GROUP ||
      k_read < a.K || k_read > (1 << 30) || a.rep < 1 || a.ksplit < 1 ||
      a.ksplit > MAX_CLUSTER || a.steps < 1 || static_cast<long long>(a.ksplit) * a.steps < S ||
      static_cast<long long>(a.ksplit - 1) * a.steps >= S || !w_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = GemvSmem(a.M, a.steps, a.group, a.n_act, a.ksplit).bytes(a.M);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = a.lw == 16;
  cudaError_t err;
  if (a.M <= 8)
    err = vec ? launch_gemv_as<F, 1, true>(a, smem, st) : launch_gemv_as<F, 1, false>(a, smem, st);
  else
    err = vec ? launch_gemv_as<F, 2, true>(a, smem, st) : launch_gemv_as<F, 2, false>(a, smem, st);
  return static_cast<int>(err);
}

}  // namespace a8
