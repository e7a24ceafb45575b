// Device helpers shared by the flash-attention kernels K2 (flash_attention_fwd.cu) and
// K6 (flash_attention_bwd.cu).
//
// Tiles of a (T, hd) bf16 slice sit in shared memory as rows of HDP + 8 elements
// (HDP: hd rounded up to 64, 80 or 128). A row is then an odd number of 16-byte units
// long (9, 11 or 17), so the eight rows that one 8x8 matrix of ldmatrix reads fall in
// eight distinct 16-byte bank groups: the padding, not a swizzle, keeps every
// ldmatrix and every cp.async store free of bank conflicts.
#pragma once
#include "common.cuh"

namespace flash {

constexpr int KV_ROWS = 64;  // rows of each streamed k/v tile (K2 and the dq kernel)

// Block order: with HEADS_FASTEST the grid is (B * nh, tiles) and the scheduler hands
// out one tile index for every head before the next; otherwise (tiles, B * nh), every
// tile of one head before the next head. Either way the tiles that walk the most
// k/v (or q) tiles come first within a head.
constexpr bool HEADS_FASTEST = true;
__device__ __forceinline__ int block_head() { return HEADS_FASTEST ? blockIdx.x : blockIdx.y; }
__device__ __forceinline__ int block_tile() { return HEADS_FASTEST ? blockIdx.y : blockIdx.x; }
__device__ __forceinline__ int block_tiles() { return HEADS_FASTEST ? gridDim.y : gridDim.x; }
inline dim3 grid_of(int heads, int tiles) {
  return HEADS_FASTEST ? dim3(heads, tiles) : dim3(tiles, heads);
}

// Depth of each cp.async ring: K2's k and v tiles, and the tiles of both K6 kernels.
template <int HDP>
__host__ __device__ constexpr int fwd_stages() { return 2; }
template <int HDP>
__host__ __device__ constexpr int bwd_stages() { return 2; }
constexpr float LOG2E = 1.4426950408889634f;

template <int HDP>
struct Tile {
  static constexpr int LD = HDP + 8;  // elements per shared row
  static constexpr int KQ = HDP / 16;  // k16 steps over the head dim
  static constexpr int NO = HDP / 8;   // n8 tiles over the head dim
};

// Rows [row0, row0 + ROWS) of one (batch, head) slice with token stride stride_t into a
// (ROWS, HDP + 8) shared tile by the NT threads of the block, W bytes a copy: a copy
// that starts at a column c below hd reads min(W, 2 (hd - c)) bytes and zero-fills the
// rest; rows past T and columns from hd on are zero-filled. So every row must start on
// W bytes, whatever hd is. The pad columns HDP .. HDP + 7 are never written.
template <int HDP, int ROWS, int NT, int W>
__device__ __forceinline__ void copy_rows_w(uint16_t* dst, const uint16_t* __restrict__ src,
                                            long long stride_t, int row0, int T, int hd) {
  constexpr int LD = HDP + 8, EPC = W / 2, CH = HDP / EPC;
  // Thread t copies chunks t, t + NT, ...: each step moves DR rows and DC columns on,
  // so a step costs additions, not a division and a 64-bit product. The loop stays
  // rolled: unrolled, the compiler keeps every step's offsets in registers for the
  // whole kernel, once per width.
  constexpr int DR = NT / CH, DC = (NT % CH) * EPC;
  int r = threadIdx.x / CH, c = (threadIdx.x % CH) * EPC;
  const uint16_t* row = src + (row0 + r) * stride_t;
  uint32_t s = smem_addr(dst + r * LD + c);
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const bool ok = row0 + r < T && c < hd;
    const uint16_t* g = ok ? row + c : src;
    const int nb = ok ? min(W, 2 * (hd - c)) : 0;
    if constexpr (W == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g), "r"(nb));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(g), "n"(W),
                   "r"(nb));
    r += DR;
    c += DC;
    row += DR * stride_t;
    s += (DR * LD + DC) * 2;
    if (DC != 0 && c >= HDP) {
      c -= HDP;
      ++r;
      row += stride_t;
      s += (LD - HDP) * 2;
    }
  }
}

template <int HDP, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(uint16_t* dst, const uint16_t* __restrict__ src,
                                          long long stride_t, int row0, int T, int hd,
                                          int width) {
  if (width == 16) copy_rows_w<HDP, ROWS, NT, 16>(dst, src, stride_t, row0, T, hd);
  else if (width == 8) copy_rows_w<HDP, ROWS, NT, 8>(dst, src, stride_t, row0, T, hd);
  else copy_rows_w<HDP, ROWS, NT, 4>(dst, src, stride_t, row0, T, hd);
}

// ROWS f32 of a contiguous row vector from row0 into shared memory, zero past T.
template <int ROWS, int NT>
__device__ __forceinline__ void copy_vec(float* dst, const float* __restrict__ src, int row0,
                                         int T) {
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool ok = row0 + i < T;
    cp_async_ca_zfill<4>(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

// ldmatrix.x4 lane addresses into a row-major (rows, LD) shared tile t.
// The A fragment (m16n8k16) of rows r0 .. r0 + 15, columns c0 .. c0 + 15.
template <int LD>
__device__ __forceinline__ uint32_t a_addr(const uint16_t* t, int r0, int c0, int lane) {
  return smem_addr(t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// The B fragments of the n8 tiles n0 and n0 + 8 for the k16 step at k0, from a tile
// stored [n][k] (load without .trans): r[0], r[1] are b0, b1 of n0; r[2], r[3] of n0 + 8.
template <int LD>
__device__ __forceinline__ uint32_t b_nk_addr(const uint16_t* t, int n0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return smem_addr(t + (n0 + (i >> 1) * 8 + r) * LD + k0 + (i & 1) * 8);
}

// The same two B fragments from a tile stored [k][n] (load with .trans).
template <int LD>
__device__ __forceinline__ uint32_t b_kn_addr(const uint16_t* t, int k0, int n0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return smem_addr(t + (k0 + (i & 1) * 8 + r) * LD + n0 + (i >> 1) * 8);
}

// The A fragment of the k16 step kk of a product whose A is a warp's 16-row block of
// score accumulators (n8 tile j in s[j]), rounded to bf16: the accumulator layout of
// m16n8k16 is the A layout, so it never leaves registers.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], float (*s)[4], int kk) {
  a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// acc[j] += a * B for the NO n8 tiles of the head dim, B [k][n] in shared memory at
// rows k0 .. k0 + 15 (ldmatrix.x4.trans, two n8 tiles a load).
template <int LD, int NO>
__device__ __forceinline__ void mma_a_bkn(float (*acc)[4], const uint32_t a[4],
                                          const uint16_t* t, int k0, int lane) {
#pragma unroll
  for (int jp = 0; jp < NO / 2; ++jp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, b_kn_addr<LD>(t, k0, jp * 16, lane));
    mma_bf16_16816(acc[2 * jp], a, b[0], b[1]);
    mma_bf16_16816(acc[2 * jp + 1], a, b[2], b[3]);
  }
}

// Store a warp's 16 x HDP f32 accumulator rows (row_a, row_b = row_a + 8) as bf16 into a
// contiguous (T, hd) slice, each multiplied by its row's factor.
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float (*acc)[4], int row_a,
                                           int T, int hd, int tq, float mul_a = 1.f,
                                           float mul_b = 1.f) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * tq;
    if (c >= hd) continue;  // hd is even, so c < hd implies c + 1 < hd
    if (row_a < T)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row_a * hd + c) =
          __floats2bfloat162_rn(acc[j][0] * mul_a, acc[j][1] * mul_a);
    if (row_b < T)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row_b * hd + c) =
          __floats2bfloat162_rn(acc[j][2] * mul_b, acc[j][3] * mul_b);
  }
}

// Raise a kernel's dynamic shared memory limit to what it takes, before its launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
