// Dequant-matmuls with int8 activations (W4A8, W8A8, W2A8, W3A8) for Hopper (sm_90a):
// y = sum over k of xq[k] * (q[k] - z) * s, with xq the int8-rounded activation. Shared
// by csrc/quant_matmul_w4a8.cu (the int4 decoder) and csrc/quant_matmul_a8.cu (int8,
// uint8, int2 and int3).
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
// Three launches on the caller's stream:
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
//
// A decoder F gives: PLANES (1 or 2 stored arrays), ROWS0/ROWS1 (stored rows of each
//   that one k32 step reads), U (k32 steps a batch), SHIFT, and frag(tile, u, h, t, c):
//   the B register of column c, K-rows 32 u + 16 h + 4 t .. + 3 of the batch, from the
//   batch's shared tiles (plane 0's U * ROWS0 rows of 32 bytes, then plane 1's).
//
// What bounds it on an H100: at decode (M <= 64) the weight bytes, as for the exact
//   GEMVs (csrc/qmm_gemv.cuh). This version is simple, not fast: one warp a block, byte
//   reads of the stored tile from shared memory, no cp.async ring, no wgmma or TMA.
#pragma once
#include "common.cuh"

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

}  // namespace a8
