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

// Every library exports this, so that the Python wrapper can name a launch error.
extern "C" const char* lljt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
