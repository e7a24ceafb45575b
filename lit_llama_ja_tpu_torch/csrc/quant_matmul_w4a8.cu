// Int4 dequant-matmul with int8 activations (W4A8) for Hopper (sm_90a):
// y = sum over k of xq[k] * (q[k] - z) * s, with xq the int8-rounded activation.
//
// Replaces: the int8-operand modes of the Pallas kernel
//   lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325 quant_matmul_int4 (unpack =
//   "int8dot_bias", "int8dot_bias_bc", "int8dot_fused", "int8dot"; kernel body
//   _qmm4_kernel :45, its W4A8 epilogues :166-221, the tile plan _plan_tiles :301 at
//   block_k 512), which the JAX function picks by itself at M <= 64. The four names
//   differ only in how the TPU unpacks a byte and in the f32 order of the epilogue;
//   all of them compute the same sum with the same xq.
//
// Numerics (the JAX kernel's, step by step in the plain version,
//   ops/cuda/quant_matmul.py::quant_matmul_int4_w4a8_ref): x is cast to bf16; for
//   each (row, activation group of `group` K elements, laid out by the wrapper's
//   w4a8_plan) rsx = 127 / max(amax, 1e-30) by IEEE division, xq = round half to even
//   of x * rsx. The weight is decoded in the int8dot_fused form: both nibbles of a byte
//   become 16 * (q - 8), in natural K order; so the int32 sum D over a
//   group is a multiple of 16 and D / 16 is exact, and the group folds into the f32
//   accumulator as (D / 16 - (sum of xq) * (z - 8)) * (s / rsx), with the group's
//   scale and zero rows.
//
// Layout (the JAX package's): qweight (K/2, N) uint8, byte r holds K-row 2r in the low
//   nibble (plain) and K-row 2r+1 in the high nibble stored (q - 8) & 0xF
//   ("hi-biased-v2"), so (byte & 0xF0) read as int8 is exactly 16 * (q_hi - 8) and
//   ((byte & 0x0F) << 4) ^ 0x80 is 16 * (q_lo - 8). scales, zeros (G, N) f32; group j
//   reads scale row j / rep.
//
// Three launches on the caller's stream:
//   1. w4a8_quantize: one block per (activation group, row) writes xq (Mpad, Kpad)
//      int8 (zero past K and on the pad rows), rsx and the group's level sum.
//   2. w4a8_mma: one warp a block, 32 output columns, up to 4 row tiles of 16, over
//      a range of activation groups (the split). mma.sync m16n8k32 s8 x s8 -> s32: A
//      is xq (16 rows x 32 K a tile, loaded straight from the row-major buffer), B the
//      weight decoded in registers from the bytes that the warp copies through shared
//      memory, 4 k32 steps (2 KB) a batch. A group that does not start or end on a
//      multiple of 32 K (60 and 780 at the 125M shapes) runs its edge steps with the A
//      bytes outside the group zeroed, so a step shared by two groups runs once for
//      each. The int32 sums fold into f32 at every group's end.
//   3. w4a8_merge (when the groups split): the splits' f32 partials summed in split
//      order, so two launches give equal bits.
//
// What bounds it on an H100: at decode (M <= 64) the weight bytes, 0.5 a weight,
//   as for the exact GEMV (csrc/qmm_gemv.cuh). This first version is simple, not fast:
//   one warp a block, byte reads of the decoded tile from shared memory, no cp.async
//   ring, no wgmma or TMA; those are later work.
#include "common.cuh"

namespace {

constexpr int COLS = 32;  // output columns a block
constexpr int U = 4;      // k32 steps a batch of weight loads
constexpr int QTHREADS = 128;

__device__ __forceinline__ void mma_s8_16832(int d[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four int8 weights of K-rows 4r .. 4r+3 of one column, from its bytes p0 (packed
// row 2r) and p1 (2r + 1), each 16 * (q - 8): the low nibble (plain q) moved up with its
// bit 3 flipped, the high nibble (stored (q - 8) & 0xF) as it is.
__device__ __forceinline__ uint32_t fused_quad(uint32_t p0, uint32_t p1) {
  const uint32_t t = p0 | (p1 << 16);
  return (((t & 0x000F000Fu) << 4) ^ 0x00800080u) | ((t & 0x00F000F0u) << 8);
}

// The bytes of the word at K-rows kb .. kb+3 that lie in [k0, k1), as a mask.
__device__ __forceinline__ uint32_t keep_bytes(int kb, int k0, int k1) {
  const int lo = min(max(k0 - kb, 0), 4), hi = min(max(k1 - kb, 0), 4);
  if (hi <= lo) return 0u;
  return static_cast<uint32_t>(((1ull << (8 * hi)) - 1) ^ ((1ull << (8 * lo)) - 1));
}

__global__ void __launch_bounds__(QTHREADS)
    w4a8_quantize(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ rsx, int* __restrict__ sx, int M, int K, int Kpad,
                  int group, int n_act) {
  const int j = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = j * group, k1 = k0 + group;
  int8_t* qrow = xq + static_cast<size_t>(m) * Kpad;
  __shared__ float red_f[QTHREADS / 32];
  __shared__ int red_i[QTHREADS / 32];
  if (j == n_act - 1)
    for (int k = K + tid; k < Kpad; k += QTHREADS) qrow[k] = 0;
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
  for (int k = k0 + tid; k < k1; k += QTHREADS) amax = fmaxf(amax, fabsf(__bfloat162float(xrow[k])));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red_f[warp] = amax;
  __syncthreads();
  amax = red_f[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, red_f[w]);
  const float r = __fdiv_rn(127.f, fmaxf(amax, 1e-30f));  // IEEE, as the JAX kernel
  int sum = 0;
  for (int k = k0 + tid; k < k1; k += QTHREADS) {
    const int q = __float2int_rn(__fmul_rn(__bfloat162float(xrow[k]), r));  // half to even
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

__device__ __forceinline__ void store_pair(void* out, bool f32, size_t idx, float v) {
  if (f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
}

// One block: output columns c0 .. c0+31, rows r0 .. r0 + 16 MT - 1 of x̂, activation
// groups [j0, j1) of split blockIdx.y. Lane (g, t) = (lane / 4, lane % 4) holds the
// m16n8k32 fragments: A rows g and g+8, K bytes 4t.. and 16+4t..; B column g, K rows
// 4t.. and 16+4t..; C rows g and g+8, columns 2t and 2t+1.
template <int MT>
__global__ void __launch_bounds__(32)
    w4a8_mma(const int8_t* __restrict__ xq, const float* __restrict__ rsx,
             const int* __restrict__ sx, const uint8_t* __restrict__ qw,
             const float* __restrict__ scales, const float* __restrict__ zeros,
             void* __restrict__ out, float* __restrict__ ws, int M, int Mpad, int K, int Kpad,
             int N, int group, int n_act, int rep, int ksplit, int out_f32, int vec) {
  __shared__ __align__(16) uint8_t wt[U][16][COLS];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * COLS, split = blockIdx.y, r0 = blockIdx.z * 16 * MT;
  const int Kq = K >> 1;
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
      // copy the batch's packed rows 16 s .. 16 s + 15 of the block's 32 columns: lane l
      // takes row l / 2, bytes 16 (l % 2) .. + 15; rows past K/2 and columns past N as 0
      uint4 v[U];
      const int col = c0 + (lane & 1) * 16;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = 16 * (sb + u) + (lane >> 1);
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (sb + u < s1 && row < Kq) {
          const uint8_t* src = qw + static_cast<size_t>(row) * N + col;
          if (vec) {
            if (col < N) v[u] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            uint8_t b[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) b[i] = col + i < N ? __ldg(src + i) : uint8_t(0);
            v[u] = make_uint4(b[0] | b[1] << 8 | b[2] << 16 | static_cast<uint32_t>(b[3]) << 24,
                              b[4] | b[5] << 8 | b[6] << 16 | static_cast<uint32_t>(b[7]) << 24,
                              b[8] | b[9] << 8 | b[10] << 16 | static_cast<uint32_t>(b[11]) << 24,
                              b[12] | b[13] << 8 | b[14] << 16 |
                                  static_cast<uint32_t>(b[15]) << 24);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < U; ++u)
        *reinterpret_cast<uint4*>(&wt[u][lane >> 1][(lane & 1) * 16]) = v[u];
      __syncwarp();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (sb + u >= s1) break;
        const int kb = 32 * (sb + u);
        uint32_t b[4][2];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int c = 8 * jn + g;
          b[jn][0] = fused_quad(wt[u][2 * t][c], wt[u][2 * t + 1][c]);
          b[jn][1] = fused_quad(wt[u][2 * t + 8][c], wt[u][2 * t + 9][c]);
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
    // fold group j: (D / 16 - S (z - 8)) * (s / rsx), columns past N read as s = 0
    const int srow = j / rep;
    float sc[4][2], zc[4][2];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * jn + 2 * t + e;
        sc[jn][e] = c < N ? __ldg(scales + static_cast<size_t>(srow) * N + c) : 0.f;
        zc[jn][e] = c < N ? __ldg(zeros + static_cast<size_t>(srow) * N + c) - 8.f : 0.f;
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
            const float dd = static_cast<float>(d[mt][jn][2 * h + e] >> 4);
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
            store_pair(out, out_f32, static_cast<size_t>(r) * N + c, v);
          else
            ws[(static_cast<size_t>(split) * Mpad + r) * N + c] = v;
        }
    }
}

// out = the splits' partials summed in split order.
__global__ void w4a8_merge(const float* __restrict__ ws, void* __restrict__ out, int M, int Mpad,
                           int N, int ksplit, int out_f32) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(M) * N) return;
  const size_t plane = static_cast<size_t>(Mpad) * N;
  float s = 0.f;
  for (int p = 0; p < ksplit; ++p) s = __fadd_rn(s, ws[p * plane + i]);
  store_pair(out, out_f32, i, s);
}

template <int MT>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const int8_t* xq, const float* rsx,
                       const int* sx, const uint8_t* qw, const float* s, const float* z,
                       void* out, float* ws, int M, int Mpad, int K, int Kpad, int N, int group,
                       int n_act, int rep, int ksplit, int out_f32, int vec) {
  w4a8_mma<MT><<<grid, 32, 0, st>>>(xq, rsx, sx, qw, s, z, out, ws, M, Mpad, K, Kpad, N, group,
                                    n_act, rep, ksplit, out_f32, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) bf16, qweight (K/2, N) u8, scales/zeros (G, N) f32 -> out (M, N), bf16 or
// (out_f32) f32. Scratch from the wrapper: xq (Mpad, Kpad) int8, rsx and sx (Mpad,
// n_act) f32 and int32, ws (ksplit, Mpad, N) f32 when ksplit > 1, with Mpad = M rounded
// up to 16 * mt and Kpad = K rounded up to 32. group * n_act == K; group j reads scale
// row j / rep. mt, ksplit, vec: the wrapper's w4a8_launch_plan.
int lljt_qmm4_w4a8(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, void* xq, void* rsx, void* sx, void* ws, int M, int K, int N,
                   int group, int n_act, int rep, int mt, int ksplit, int out_f32, int vec,
                   void* stream) {
  if (K % 2 || group <= 0 || group * n_act != K || mt < 1 || mt > 4 || ksplit < 1 ||
      ksplit > n_act || rep < 1 || (ksplit > 1 && ws == nullptr) || M <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kpad = (K + 31) / 32 * 32, Mpad = (M + 16 * mt - 1) / (16 * mt) * (16 * mt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* q8 = static_cast<int8_t*>(xq);
  auto* r = static_cast<float*>(rsx);
  auto* s8 = static_cast<int*>(sx);
  w4a8_quantize<<<dim3(n_act, Mpad), QTHREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                         q8, r, s8, M, K, Kpad, group, n_act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + COLS - 1) / COLS, ksplit, Mpad / (16 * mt));
  const auto* w = static_cast<const uint8_t*>(qweight);
  const auto* sp = static_cast<const float*>(scales);
  const auto* zp = static_cast<const float*>(zeros);
  auto* wsp = static_cast<float*>(ws);
  switch (mt) {
    case 1: err = launch_mma<1>(grid, st, q8, r, s8, w, sp, zp, out, wsp, M, Mpad, K, Kpad, N, group, n_act, rep, ksplit, out_f32, vec); break;
    case 2: err = launch_mma<2>(grid, st, q8, r, s8, w, sp, zp, out, wsp, M, Mpad, K, Kpad, N, group, n_act, rep, ksplit, out_f32, vec); break;
    case 3: err = launch_mma<3>(grid, st, q8, r, s8, w, sp, zp, out, wsp, M, Mpad, K, Kpad, N, group, n_act, rep, ksplit, out_f32, vec); break;
    default: err = launch_mma<4>(grid, st, q8, r, s8, w, sp, zp, out, wsp, M, Mpad, K, Kpad, N, group, n_act, rep, ksplit, out_f32, vec); break;
  }
  if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(M) * N;
  w4a8_merge<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(wsp, out, M, Mpad, N, ksplit,
                                                                     out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
