// The decode GEMV of K1 (int4), K3 (int8), K4 (int2) and K5 (int3) for Hopper (sm_90a):
// y = x @ dequant(W) for M <= 16 rows of x, bf16 x and y, f32 scales and zeros (G, N),
// w = (q - zero) * scale. Included by quant_matmul_int4.cu, quant_matmul_int8.cu and
// quant_matmul_sub4.cu, which define the decoders of their formats (Dec) and their C
// entry points.
//
// The weight has Kp >= K stored K-rows (Kp = K but for the padded int2/int3 packs) in
// one or two planes of N-byte rows (int3: the int2 plane and the high-bit plane), and
// K-row k reads scale row k / ceil(Kp / G). The pad rows K..Kp-1 add nothing: the fast
// route runs whole k16 steps below K, and the general route reads x as zero past K.
//
// What bounds it on an H100: the weight bytes, 1/4 to 1 byte a weight against 2 M flops
// (4096 x 4096 at M = 1: 8.4 MB of int4, 2.5 us at 3.35 TB/s), and a fixed cost a launch
// (the cluster's start and its reduction, x's first copy) that is larger than that.
//   * The products run on the tensor cores: mma.sync m16n8k16 bf16 -> f32 with the
//     weight as A (16 output columns x 16 K-rows) and x as B (16 K-rows x 8 rows of x;
//     a second product for rows 9-16). K and N are permuted inside a tile so that the
//     global loads are the fragments: lane (g, t) = (lane / 4, lane % 4) of a warp loads
//     16 bytes, columns 16g..16g+15 of the block's 128, of each stored row of K-rows
//     16s + 4t .. 16s + 4t + 3 in k16 step s (int4: 2 packed rows, a k-pair a byte;
//     int8: 4 rows; int2: 1 packed row, 4 K-rows a byte; int3: that row and the high-bit
//     plane's row, 8 K-rows a byte, of which the lane uses half). mma j takes columns
//     16g + 2j (A rows 0-7) and 16g + 2j + 1 (A rows 8-15); A's k-pairs 2t and 2t+8 are
//     K-rows 4t, 4t+1 and 4t+2, 4t+3. So a warp's load instruction covers four whole
//     128-byte lines (int3's high plane: two, each read by two lanes), the weights reach
//     the mma without a shared-memory round trip, and the B fragment of x is one 8-byte
//     load.
//   * The levels are decoded into A registers without an I2F (Dec::frag): int4 by the
//     bf16 magic number (0x4300 | q is 128 + q: one byte permute and one lop3 a k-pair,
//     the high nibble's bias folded into the lop3; int2 and int3 alike from the 2- or
//     3-bit fields of a byte); int8 as two nibble products into the same accumulator
//     (128 + lo and 256 + 16 hi, 2 integer instructions a level).
//     The offset that the magics leave (Dec::ZOFF) joins the zero point.
//   * The zero point is a rank-1 correction per scale group: y += s (acc - z' sum x),
//     where acc is the tensor-core sum and sum x comes from one more mma with A all ones
//     on the same B fragment, so it has acc's layout. x is staged in shared memory
//     once per chunk of k16 steps (zero past M and K), the block's first scale group
//     too, while the first weights are in flight.
//   * Split K in one launch: the K splits of a column tile are the blocks of one thread
//     block cluster (at most 8 from the plan). Each block sums its four warps' partials
//     in shared memory in warp order; then block r of the cluster sums its share of the
//     tile over all blocks' shared memory in rank order (distributed shared memory) and
//     writes bf16. No workspace, no second kernel, no counter: two launches give equal
//     bits, and the launch can be captured in a CUDA graph.
//   * Two routes, planned on the host (gemv_plan, ops/cuda/quant_matmul.py). The fast
//     route (gemv_fast), every 7B view's: 16-byte loads straight into registers, a batch
//     of U steps at a time, for N % 16 == 0, K % 16 == 0 and scale groups that no batch
//     straddles. It is kept small on purpose: the same work with 1,800 more instructions
//     that never run measured 30-53% slower (gemv_probe micro). The general route
//     (gemv_general), everything else: cp.async copies of 16, 8, 4 or 1 bytes into a
//     ring of each warp's, and a k16 step that straddles a scale group boundary (ragged
//     groups, any G <= K) runs once per group with x masked to the group's K-rows, so no
//     row is scaled by its neighbour's group.
#pragma once
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace qmmv {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 128;           // output columns a warp: 8 lane groups of 16
constexpr int CHUNK_STEPS = 128;    // most k16 steps of x staged in shared memory at a time
constexpr int RING_BYTES = 8192;    // a warp's ring of weight copies in flight
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr uint32_t ONES = 0x3F803F80u;  // bf16x2 (1, 1)

// bf16 a staged row of x for `steps` k16 steps: 16 steps + 16, which is 8 mod 32 banks
// in words, so the 8-byte B loads of a half-warp fall on distinct banks
__host__ __device__ constexpr int xrow(int steps) { return 16 * steps + 16; }

// Shared memory of one block: each warp's ring of weight copies (after the loop, the
// block's partial sums), each warp's y, the first group's scales and zeros, and x's
// staged chunk of `chunk` k16 steps.
template <int MT>
struct Smem {
  static constexpr int RING = WARPS * RING_BYTES;
  static constexpr int SLOT = MT * 8 * COLS;  // f32 of one warp's y (y_at)
  static constexpr int Y = WARPS * SLOT * 4;
  static constexpr int SZ = 2 * COLS * 4;  // f32 [2][COLS]
  static constexpr int bytes(int chunk) { return RING + Y + SZ + MT * 8 * xrow(chunk) * 2; }
  static_assert(RING >= 16 * COLS * 4, "the ring holds the block's partial sums");
};

// Shared memory of a block of the fast route: each warp's y, the first group's scales and
// zeros, x's staged chunk of CHUNK_STEPS / 2 k16 steps (then the block's partial sums).
template <int MT>
struct FastSmem {
  static constexpr int BYTES = WARPS * MT * 8 * COLS * 4 + 2 * COLS * 4 +
                               MT * 8 * xrow(CHUNK_STEPS / 2) * 2;
};

// 16 bytes streamed past L1: each weight byte is read once. Volatile, so that a batch's
// loads are issued together, ahead of the (volatile) mma of the batch.
__device__ __forceinline__ uint4 ld_stream16(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Columns col..col+15 of one stored row (row points at its column 0) into this lane's
// 16 bytes at dst, zero past N and where !ok: by cp.async (L2 only) of 16 bytes (VEC16:
// N % 16 == 0, so all 16 columns or none) or of lw = 8 or 4 bytes (N % lw == 0), or by
// byte loads (lw 1). `any` is a valid address for the copies that read nothing.
template <bool VEC16>
__device__ __forceinline__ void copy_cols(uint4* dst, const uint8_t* row, int col, int N,
                                          int lw, bool ok, const uint8_t* any) {
  if (VEC16) {
    const bool v = ok && col < N;
    cp_async16_zfill(dst, v ? row + col : any, v ? 16 : 0);
  } else if (lw == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool v = ok && col + 8 * h < N;
      cp_async_ca_zfill<8>(reinterpret_cast<uint8_t*>(dst) + 8 * h, v ? row + col + 8 * h : any,
                           v ? 8 : 0);
    }
  } else if (lw == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool v = ok && col + 4 * h < N;
      cp_async_ca_zfill<4>(reinterpret_cast<uint8_t*>(dst) + 4 * h, v ? row + col + 4 * h : any,
                           v ? 4 : 0);
    }
  } else {  // a word at a time, so that one register holds the bytes
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (ok && col + 4 * h + b < N)
          w |= static_cast<uint32_t>(__ldg(row + col + 4 * h + b)) << (8 * b);
      reinterpret_cast<uint32_t*>(dst)[h] = w;
    }
  }
}

// 16 f32 of a scale or zero row, columns col..col+15, zero past N; sw 16: float4 loads.
__device__ __forceinline__ void load_f16(const float* __restrict__ p, int col, int N, int sw,
                                         float out[16]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int c = col + 4 * h;
    if (sw == 16 && c < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + c));
      out[4 * h] = v.x; out[4 * h + 1] = v.y; out[4 * h + 2] = v.z; out[4 * h + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * h + e] = c + e < N ? __ldg(p + c + e) : 0.f;
    }
  }
}

// b with the bf16 halves whose K-row (r for the low half, r + 1 for the high) lies
// outside [k, e) cleared.
__device__ __forceinline__ uint32_t mask_rows(uint32_t b, int r, int k, int e) {
  const uint32_t lo = (r >= k && r < e) ? 0x0000FFFFu : 0u;
  const uint32_t hi = (r + 1 >= k && r + 1 < e) ? 0xFFFF0000u : 0u;
  return b & (lo | hi);
}

// Cluster barriers at cluster scope, written out: cooperative_groups' cluster.sync()
// compiles to a GPU-wide memory barrier (MEMBAR.ALL.GPU) and an L1 invalidation on
// each side. Arrive with release so that this block's shared-memory writes are seen by
// the cluster's reads after their wait (acquire); the last barrier only keeps a block's
// shared memory alive until the others have read it, so it orders nothing.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of both routes: the warps' partial sums y ([WARPS][MT * 8][COLS] at red) are
// summed in warp order into part ([m][column], rows m < M); then block r of the cluster
// sums its share of the tile over every block's part, in rank order (distributed shared
// memory), and writes bf16. The caller has passed a __syncthreads after its last write
// of red.
// A warp's y in shared memory, lane-major: accumulator i of mma j of product mt, which
// lane 4g + t holds (row 8 mt + 2t + (i & 1), column 16g + 2j + (i >> 1)), sits at
// ((8 mt + j) * 4 + i) * 32 + lane, so that the 32 lanes' adds of a flush fall on 32
// banks (row-major [m][column] put them on two: a 16-way conflict that cost about 5 us a
// launch in gemv_probe's no_final_flush variant).
__device__ __forceinline__ int y_at(int mt, int j, int i, int lane) {
  return ((8 * mt + j) * 4 + i) * 32 + lane;
}

// y_at of row m, column c
__device__ __forceinline__ int y_at_mc(int m, int c) {
  return y_at(m >> 3, (c & 15) >> 1, ((c & 1) << 1) | (m & 1), 4 * (c >> 4) + ((m & 7) >> 1));
}

template <int MT>
__device__ __forceinline__ void reduce_and_store(float* part, const float* red,
                                                 __nv_bfloat16* __restrict__ out, int M,
                                                 int N) {
  constexpr int SLOT = MT * 8 * COLS;
  const int E = M * COLS;
  for (int e = threadIdx.x; e < E; e += THREADS) {
    const int at = y_at_mc(e / COLS, e % COLS);
    float v = red[at];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w * SLOT + at];
    part[e] = v;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_release();
  cluster_wait();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = (E + C - 1) / C;
  const int e1 = min(E, (rank + 1) * share);
  for (int e = rank * share + threadIdx.x; e < e1; e += THREADS) {
    float v = 0.f;
    for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(part, q)[e];
    const int n = blockIdx.y * COLS + e % COLS;
    if (n < N) out[(size_t)(e / COLS) * N + n] = __float2bfloat16_rn(v);
  }
  cluster_arrive_relaxed();  // no block leaves while another reads its shared memory
  cluster_wait();
}

// y += s * (acc - (z + ZOFF) * sum x) for one scale group into a warp's y (yw), its
// accumulators then cleared; c0/c1 of a fragment are column 16g + 2j at rows 2t and
// 2t + 1, c2/c3 column 16g + 2j + 1.
template <class Dec, int MT>
__device__ __forceinline__ void flush_group(float* yw, float (&acc)[MT][8][4],
                                            float (&xsum)[MT][4], const float (&s)[16],
                                            const float (&z)[16], int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 2 * j + (i >> 1);
        yw[y_at(mt, j, i, lane)] += s[c] * (acc[mt][j][i] - (z[c] + Dec::ZOFF) * xsum[mt][i & 1]);
        acc[mt][j][i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) xsum[mt][i] = 0.f;
  }
}

// mma j of every part of Dec, and the row sums of x, for one k16 step
template <class Dec, int MT>
__device__ __forceinline__ void step_product(float (&acc)[MT][8][4], float (&xsum)[MT][4],
                                             const uint4 (&w)[Dec::LOADS],
                                             const uint32_t (&b)[MT][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int part = 0; part < Dec::PARTS; ++part) {
      uint32_t a[4];
      Dec::frag(w, j, part, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][j], a, b[mt][0], b[mt][1]);
    }
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(xsum[mt], ones, b[mt][0], b[mt][1]);
}

// The fast route, the decode path's: N % 16 == 0 with 16-byte aligned rows, K % 16 ==
// 0, and scale groups of a multiple of 16 U K-rows (or one), so that no batch of U steps
// reaches two groups. One block: 128 output columns x the k16 steps of split blockIdx.x
// (a whole number of batches), warp w taking part w of each chunk in batches of U steps
// loaded into registers, 16 bytes a lane a load, each batch issued before the block
// waits on x. Kept small: a larger kernel measured slower (gemv_probe).
template <class Dec, int MT>
__global__ void __launch_bounds__(THREADS)
gemv_fast(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
          const uint8_t* __restrict__ qh, const float* __restrict__ scales,
          const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out, int M, int K,
          int Kp, int N, int G, int steps_per_split) {
  constexpr int U = Dec::U;
  constexpr int XR = xrow(CHUNK_STEPS / 2);
  constexpr int SLOT = MT * 8 * COLS;
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem);                  // [WARPS][SLOT]
  float* sz0 = red + WARPS * SLOT;                              // [2][COLS]
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(sz0 + 2 * COLS);  // [MT * 8][XR]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s_begin = blockIdx.x * steps_per_split;
  const int s_end = min(K >> 4, s_begin + steps_per_split);
  const int col = blockIdx.y * COLS + 16 * g;
  const int gsz = (Kp + G - 1) / G;
  const int grp0 = 16 * s_begin / gsz;
  float* yw = red + warp * SLOT;

  float acc[MT][8][4], xsum[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) xsum[mt][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  }
  for (int e = lane; e < SLOT; e += 32) yw[e] = 0.f;
  int grp = -1, gnext = 0;
  auto flush = [&]() {
    float s[16], z[16];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 sv = grp == grp0 ? *reinterpret_cast<const float4*>(sz0 + 16 * g + 4 * h)
                                    : __ldg(reinterpret_cast<const float4*>(
                                          scales + (size_t)grp * N + col + 4 * h));
      const float4 zv = grp == grp0
                            ? *reinterpret_cast<const float4*>(sz0 + COLS + 16 * g + 4 * h)
                            : __ldg(reinterpret_cast<const float4*>(
                                  zeros + (size_t)grp * N + col + 4 * h));
      s[4 * h] = sv.x; s[4 * h + 1] = sv.y; s[4 * h + 2] = sv.z; s[4 * h + 3] = sv.w;
      z[4 * h] = zv.x; z[4 * h + 1] = zv.y; z[4 * h + 2] = zv.z; z[4 * h + 3] = zv.w;
    }
    flush_group<Dec, MT>(yw, acc, xsum, s, z, lane);
  };
  auto load_batch = [&](uint4 (&w)[U][Dec::LOADS], int s0, int we) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < Dec::LOADS; ++i) {
        const int r = Dec::row(s0 + u, t, i);
        const uint8_t* plane = Dec::plane(i) ? qh : qw;
        w[u][i] = s0 + u < we && col < N ? ld_stream16(plane + (size_t)r * N + col)
                                         : make_uint4(0, 0, 0, 0);
      }
  };

  for (int cs = s_begin; cs < s_end; cs += CHUNK_STEPS / 2) {
    const int ce = min(s_end, cs + CHUNK_STEPS / 2);
    const int per = (ce - cs + WARPS * U - 1) / (WARPS * U) * U;  // whole batches
    const int wb = min(ce, cs + warp * per), we = min(ce, wb + per);
    uint4 w[U][Dec::LOADS];
    load_batch(w, wb, we);
    // x's K-rows of steps cs..ce-1, zero past M (and once, the first group's scales and
    // zeros), while the batch is in flight
    __syncthreads();
    const int per_row = 2 * (ce - cs);
    for (int idx = threadIdx.x; idx < MT * 8 * per_row; idx += THREADS) {
      const int m = idx / per_row, c = 8 * (idx % per_row);
      *reinterpret_cast<uint4*>(xsm + m * XR + c) =
          m < M ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + 16 * cs + c))
                : make_uint4(0, 0, 0, 0);
    }
    if (cs == s_begin && threadIdx.x < 2 * COLS / 4) {
      const int c = 4 * (threadIdx.x % (COLS / 4)), n = blockIdx.y * COLS + c;
      const float* src = (threadIdx.x < COLS / 4 ? scales : zeros) + (size_t)grp0 * N + n;
      *reinterpret_cast<float4*>(sz0 + 4 * threadIdx.x) =
          n < N ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int s0 = wb; s0 < we; s0 += U) {
      if (s0 > wb) load_batch(w, s0, we);
      if (16 * s0 >= gnext) {  // a batch never reaches two groups; this one starts one
        if (grp >= 0) flush();
        grp = 16 * s0 / gsz;
        gnext = (grp + 1) * gsz;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < we) {
          uint32_t b[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint2 v = *reinterpret_cast<const uint2*>(xsm + (8 * mt + g) * XR +
                                                           16 * (s0 + u - cs) + 4 * t);
            b[mt][0] = v.x;
            b[mt][1] = v.y;
          }
          step_product<Dec, MT>(acc, xsum, w[u], b);
        }
    }
  }
  if (grp >= 0) flush();
  __syncthreads();
  reduce_and_store<MT>(reinterpret_cast<float*>(xsm), red, out, M, N);
}

// The general route (any N, base, K and scale groups): one block, 128 output columns
// (blockIdx.y) x the k16 steps of split blockIdx.x, the block's rank in a cluster of
// gridDim.x blocks; warp w takes part w of each chunk's steps, copied by cp.async into
// a ring of its own. MT n8 products (rows 1-8, 9-16). Dec: LOADS
// 16-byte copies a lane per k16 step, row(s, t, i) the stored row of copy i in plane
// plane(i) (0: qw, 1: qh), rows(Kp, i) that plane's stored rows, PARTS products a
// fragment, frag(w, j, part, a) mma j's A fragment, ZOFF the decoded level minus the
// true one.
template <class Dec, int MT, bool VEC16>
__global__ void __launch_bounds__(THREADS, 2)
gemv_general(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
             const uint8_t* __restrict__ qh, const float* __restrict__ scales,
             const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out, int M, int K,
             int Kp, int N, int G, int steps_per_split, int lw, int xw, int sw) {
  // k16 steps in a warp's ring: at most 8 groups of copies in flight
  constexpr int RING_STEPS = RING_BYTES / (Dec::LOADS * 32 * 16);
  constexpr int R = RING_STEPS < 8 ? RING_STEPS : 8;
  using SM = Smem<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // [R][LOADS][32 lanes] of this warp; a lane reads back only the 16 bytes it copied
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * (RING_BYTES / 16) + lane;
  float* red = reinterpret_cast<float*>(smem + SM::RING);  // [WARPS][SLOT]: each warp's y
  float* sz0 = red + WARPS * SM::SLOT;  // [2][COLS]: scales, zeros of the first group
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(smem + SM::RING + SM::Y + SM::SZ);
  float* yw = red + warp * SM::SLOT;    // this warp's y

  const int g = lane >> 2, t = lane & 3;
  const int S = (K + 15) >> 4;
  const int s_begin = blockIdx.x * steps_per_split;
  const int s_end = min(S, s_begin + steps_per_split);
  const int chunk = min(steps_per_split, CHUNK_STEPS), XR = xrow(chunk);
  const int col = blockIdx.y * COLS + 16 * g;  // the lane's 16 columns
  const int gsz = (Kp + G - 1) / G;  // K-rows a scale group
  const int grp0 = 16 * s_begin / gsz;  // the block's first group, staged in sz0

  float acc[MT][8][4], xsum[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) xsum[mt][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  }
  int grp = -1, gnext = 0;  // the group being summed (-1: none yet) and where it ends

  auto flush = [&]() {
    float s[16], z[16];
    if (grp == grp0) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        s[c] = sz0[16 * g + c];
        z[c] = sz0[COLS + 16 * g + c];
      }
    } else {
      load_f16(scales + (size_t)grp * N, col, N, sw, s);
      load_f16(zeros + (size_t)grp * N, col, N, sw, z);
    }
    flush_group<Dec, MT>(yw, acc, xsum, s, z, lane);
  };
  auto product = [&](const uint4 (&w)[Dec::LOADS], const uint32_t (&b)[MT][2]) {
    step_product<Dec, MT>(acc, xsum, w, b);
  };

  // step s's copies into its ring slot as one cp.async group (an empty one past `we`)
  auto issue = [&](int s, int we) {
    if (s < we)
#pragma unroll
      for (int i = 0; i < Dec::LOADS; ++i) {
        const int r = Dec::row(s, t, i);
        copy_cols<VEC16>(ring + ((s % R) * Dec::LOADS + i) * 32,
                         (Dec::plane(i) ? qh : qw) + (size_t)r * N, col, N, lw,
                         r < Dec::rows(Kp, i), qw);
      }
    cp_async_commit();
  };

  for (int e = lane; e < SM::SLOT; e += 32) yw[e] = 0.f;  // only this warp touches it
  for (int cs = s_begin; cs < s_end; cs += chunk) {
    const int ce = min(s_end, cs + chunk);
    const int per = (ce - cs + WARPS - 1) / WARPS;
    const int wb = min(ce, cs + warp * per), we = min(ce, wb + per);
    __syncthreads();  // the chunk before is no longer read

    // one cp.async group: x's K-rows of steps cs..ce-1, zero past M and K (and once,
    // the scales and zeros of the block's first group); then the ring's first R steps,
    // so that x arrives while the weights are in flight
    const int k_lo = 16 * cs, width = 16 * (ce - cs);
    if (xw == 16) {
      const int per_row = width / 8;
      for (int idx = threadIdx.x; idx < MT * 8 * per_row; idx += THREADS) {
        const int m = idx / per_row, c = 8 * (idx % per_row), k = k_lo + c;
        const bool v = m < M && k < K;
        cp_async16_zfill(xsm + m * XR + c, v ? x + (size_t)m * K + k : x, v ? 16 : 0);
      }
    }
    if (cs == s_begin)
      for (int idx = threadIdx.x; idx < 2 * COLS; idx += THREADS) {
        const int n = blockIdx.y * COLS + idx % COLS;
        const float* src = (idx < COLS ? scales : zeros) + (size_t)grp0 * N + n;
        cp_async_ca_zfill<4>(sz0 + idx, n < N ? src : scales, n < N ? 4 : 0);
      }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < R; ++i) issue(wb + i, we);
    if (xw != 16)  // rows of 2-byte alignment: plain loads
      for (int idx = threadIdx.x; idx < MT * 8 * width; idx += THREADS) {
        const int m = idx / width, c = idx % width, k = k_lo + c;
        xsm[m * XR + c] = (m < M && k < K) ? x[(size_t)m * K + k] : __float2bfloat16_rn(0.f);
      }
    if (grp < 0 && wb < we) {  // the group of the warp's first K-row
      grp = 16 * wb / gsz;
      gnext = (grp + 1) * gsz;
    }
    cp_async_wait<R>();  // this thread's copies of x
    __syncthreads();

    for (int s = wb; s < we; ++s) {
      cp_async_wait<R - 1>();  // step s's group has landed
      uint4 w[Dec::LOADS];
#pragma unroll
      for (int i = 0; i < Dec::LOADS; ++i) w[i] = ring[((s % R) * Dec::LOADS + i) * 32];
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 v = *reinterpret_cast<const uint2*>(xsm + (8 * mt + g) * XR +
                                                       16 * (s - cs) + 4 * t);
        b[mt][0] = v.x;
        b[mt][1] = v.y;
      }
      const int k0 = 16 * s, kend = min(k0 + 16, K);
      if (k0 < gnext && kend <= gnext) {
        product(w, b);  // the step lies in one scale group; rows past K meet zeros of x
      } else {
        // once per scale group that the step reaches, with x masked to the group's
        // rows; each group is flushed when the next one starts
        const int r = k0 + 4 * t;
        for (int k = k0; k < kend;) {
          if (k >= gnext) {
            flush();
            grp = k / gsz;
            gnext = (grp + 1) * gsz;
          }
          const int e = min(kend, gnext);
          uint32_t bm[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            bm[mt][0] = mask_rows(b[mt][0], r, k, e);
            bm[mt][1] = mask_rows(b[mt][1], r + 2, k, e);
          }
          product(w, bm);
          k = e;
        }
      }
      issue(s + R, we);  // into the slot just read, after its values were used
    }
    cp_async_wait<0>();  // only empty groups are left
  }
  if (grp >= 0) flush();

  __syncthreads();
  reduce_and_store<MT>(reinterpret_cast<float*>(smem), red, out, M, N);
}

// The cluster launch of one kernel: ksplit blocks a cluster, one cluster a column tile.
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int smem_bytes, int ksplit, int N,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ksplit, (N + COLS - 1) / COLS, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The opt-in of a kernel to dynamic shared memory above 48 KB, once a device.
template <class Kernel>
cudaError_t opt_in(Kernel kernel, int smem_bytes, bool* done) {
  constexpr int MAX_DEVICES = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <class Dec, int MT, bool VEC16>
cudaError_t launch_general(const __nv_bfloat16* x, const uint8_t* qw, const uint8_t* qh,
                           const float* s, const float* z, __nv_bfloat16* out, int M, int K,
                           int Kp, int N, int G, int ksplit, int steps, int lw, int xw, int sw,
                           cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = opt_in(gemv_general<Dec, MT, VEC16>, Smem<MT>::bytes(CHUNK_STEPS), done);
  if (err != cudaSuccess) return err;
  return launch_cluster(gemv_general<Dec, MT, VEC16>,
                        Smem<MT>::bytes(steps < CHUNK_STEPS ? steps : CHUNK_STEPS), ksplit, N,
                        stream, x, qw, qh, s, z, out, M, K, Kp, N, G, steps, lw, xw, sw);
}

template <class Dec, int MT>
cudaError_t launch_fast(const __nv_bfloat16* x, const uint8_t* qw, const uint8_t* qh,
                        const float* s, const float* z, __nv_bfloat16* out, int M, int K, int Kp,
                        int N, int G, int ksplit, int steps, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = opt_in(gemv_fast<Dec, MT>, FastSmem<MT>::BYTES, done);
  if (err != cudaSuccess) return err;
  return launch_cluster(gemv_fast<Dec, MT>, FastSmem<MT>::BYTES, ksplit, N, stream, x, qw, qh,
                        s, z, out, M, K, Kp, N, G, steps);
}

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// x (M, K) bf16 with 1 <= M <= 16, qweight (Dec::rows(Kp, 0), N) and for a second plane
// qweight_hi (Dec::rows(Kp, 1), N), scales/zeros (G, N) f32 -> out (M, N) bf16; Kp >= K
// the stored K-rows. ksplit (1..8): the blocks of a cluster, each over `steps` k16 steps
// (ksplit * steps covers K); fast: the fast route (gemv_fast), else the general one;
// lw, xw, sw: the general route's load widths. All from the wrapper's plan; a plan that
// the shapes or the pointers cannot take is refused.
template <class Dec>
cudaError_t launch(const void* x, const void* qweight, const void* qweight_hi,
                   const void* scales, const void* zeros, void* out, int M, int K, int Kp, int N,
                   int G, int ksplit, int steps, int fast, int lw, int xw, int sw,
                   void* stream) {
  const int S = (K + 15) / 16;
  const bool split_ok = ksplit >= 1 && ksplit <= MAX_CLUSTER && steps >= 1 &&
                        (long long)ksplit * steps >= S && (ksplit - 1) * steps < S;
  const bool w_ok = lw == 1 || ((lw == 4 || lw == 8 || lw == 16) && N % lw == 0 &&
                                aligned_to(qweight, lw) && aligned_to(qweight_hi, lw));
  const bool x_ok = xw == 2 || (xw == 16 && K % 8 == 0 && aligned_to(x, 16));
  const bool s_ok =
      sw == 4 || (sw == 16 && N % 4 == 0 && aligned_to(scales, 16) && aligned_to(zeros, 16));
  const int gsz = (Kp + G - 1) / G;
  const bool fast_ok = lw == 16 && xw == 16 && sw == 16 && K % 16 == 0 && steps % Dec::U == 0 &&
                       (G == 1 || gsz % (16 * Dec::U) == 0);
  if (M < 1 || M > 16 || K < 1 || Kp < K || N < 1 || G < 1 || G > Kp || !split_ok || !w_ok ||
      !x_ok || !s_ok || (fast && !fast_ok))
    return cudaErrorInvalidValue;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qw = static_cast<const uint8_t*>(qweight);
  auto qh = static_cast<const uint8_t*>(qweight_hi);
  auto s = static_cast<const float*>(scales);
  auto z = static_cast<const float*>(zeros);
  auto o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (fast)
    return M <= 8 ? launch_fast<Dec, 1>(xb, qw, qh, s, z, o, M, K, Kp, N, G, ksplit, steps, st)
                  : launch_fast<Dec, 2>(xb, qw, qh, s, z, o, M, K, Kp, N, G, ksplit, steps, st);
  auto run = [&](auto mt, auto vec16) {
    return launch_general<Dec, decltype(mt)::value, decltype(vec16)::value>(
        xb, qw, qh, s, z, o, M, K, Kp, N, G, ksplit, steps, lw, xw, sw, st);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  if (M <= 8) return lw == 16 ? run(One{}, std::true_type{}) : run(One{}, std::false_type{});
  return lw == 16 ? run(Two{}, std::true_type{}) : run(Two{}, std::false_type{});
}

}  // namespace qmmv
