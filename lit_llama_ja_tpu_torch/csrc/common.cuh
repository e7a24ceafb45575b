// Helpers shared by the port's CUDA kernels (included by each csrc/*.cu).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// c += a * b on the tensor cores: a 16x16 bf16 A fragment, a 16x8 bf16 B fragment,
// a 16x8 f32 accumulator, in the register layouts PTX fixes for m16n8k16.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed into one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies from device to shared memory (sm_80+). The zero-filling forms
// read src_bytes (0 or the copy's size here) and fill the rest of the copy with
// zeros; with src_bytes 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

// 4 or 8 bytes (the .cg form takes only 16)
template <int BYTES>
__device__ __forceinline__ void cp_async_ca_zfill(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the 16-byte rows of
// matrix i, and lane t receives row t/4, elements 2(t%4) and 2(t%4)+1 of each (with
// .trans: column t/4, rows 2(t%4) and 2(t%4)+1), the m16n8k16 fragment layouts.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice of a (T, hd) bf16 matrix with
// token stride stride_t into a (ROWS, HDP + 8) shared tile, zero-filled past T and
// past hd, by the NT threads of the block. vec: hd, the strides and the base are
// 8-element aligned (16-byte loads); otherwise 2-element (4-byte) loads.
template <int HDP, int ROWS, int NT>
__device__ __forceinline__ void load_rows(uint16_t (*dst)[HDP + 8], const uint16_t* __restrict__ src,
                                          long long stride_t, int row0, int T, int hd, bool vec) {
  if (vec) {
    constexpr int CH = HDP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < T && c < hd)
        v = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * stride_t + c));
      *reinterpret_cast<uint4*>(&dst[r][c]) = v;
    }
  } else {
    constexpr int CH = HDP / 2;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 2;
      uint32_t v = 0;
      if (row0 + r < T && c < hd)
        v = __ldg(reinterpret_cast<const uint32_t*>(src + (row0 + r) * stride_t + c));
      *reinterpret_cast<uint32_t*>(&dst[r][c]) = v;
    }
  }
}

// Every library exports this, so that the Python wrapper can name a launch error.
extern "C" const char* lljt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
