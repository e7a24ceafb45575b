// Int2 and int3 dequant-matmuls for Hopper (sm_90a): y = x @ dequant(W), bf16 x and y.
//
// Replaces: the Pallas kernels lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447
//   quant_matmul_int2 (K4) and :323 quant_matmul_int3 (K5), which share the body
//   _qmm_sub4_kernel :81, with the numerics of their exact unpack="bf16" path, i.e.
//   x @ dequantize_with_k(...). The TPU kernel splits the activations into bit planes
//   and masks without shifts because its compiler had no sub-32-bit shifts; CUDA has
//   them, so each level is decoded directly from its byte.
//
// Layout (the JAX package's): Kp = sub4_pad_rows(K, groupsize) >= K stored rows.
//   int2: qweight (Kp/4, N) u8, byte r holds K-row 4r+j at bits 2j, field 3 stored
//     (q - 2) & 3. int3: the low two bits as int2 in qweight plus qweight_hi (Kp/8, N)
//     u8, bit i of byte r the high bit of K-row 8r+i: q = q2 + 4 * hi.
//   scales, zeros (G, N) f32 over the padded rows: K-row k uses group k / ceil(Kp/G).
//   Rows K..Kp-1 hold level 0, which dequantizes to -zero*scale: the kernels never
//   multiply them (the GEMV stops at K, the GEMM reads x as zero past K).
//
// Bound on an H100: decode by the weight bytes, 1/4 (int2) or 3/8 (int3) byte per
//   weight plus the grouped scales and zeros (the 7B step: int2 1.66 GB, 0.50 ms;
//   int3 2.49 GB, 0.74 ms at 3.35 TB/s); prefill by tensor-core flops. The kernels
//   are the generic ones of qmm_generic.cuh; this file defines the two decoders. A
//   GEMV unit is one packed row (int2: 4 K-rows) or two int2 rows and one bit-plane
//   row (int3: 8 K-rows).
#include "qmm_generic.cuh"

namespace {

// level of field f (0..3) of a packed int2 byte; field 3 is stored (q - 2) & 3
__device__ __forceinline__ uint32_t int2_field(uint32_t byte, int f) {
  return ((byte >> (2 * f)) & 0x3u) ^ (f == 3 ? 0x2u : 0x0u);
}

struct Int2Fmt {
  static constexpr int U = 4;
  static constexpr int UNROLL = 8;
  struct Unit {
    uint32_t w;
  };
  struct Pair {
    uint2 b;
    int f;  // field of the even K-row (0 or 2)
  };

  static __device__ __forceinline__ void load_unit(Unit& u, const uint8_t* __restrict__ qw,
                                                   const uint8_t* __restrict__, int unit, int n0,
                                                   int N, int, bool vec) {
    u.w = qmm::load4(qw + (size_t)unit * N, n0, N, vec);
  }
  static __device__ __forceinline__ float level(const Unit& u, int row, int c) {
    return (float)int2_field((u.w >> (8 * c)) & 0xFFu, row);
  }

  static __device__ __forceinline__ void load_pair(Pair& p, const uint8_t* __restrict__ qw,
                                                   const uint8_t* __restrict__, int k, int n,
                                                   int K, int N, bool nvec) {
    p.f = k & 3;
    p.b = k < K ? qmm::load8(qw + (size_t)(k >> 2) * N, n, N, nvec) : make_uint2(0, 0);
  }
  static __device__ __forceinline__ float pair_level(const Pair& p, int j, int e) {
    return (float)int2_field(qmm::byte_of(p.b, j), p.f + e);
  }
};

struct Int3Fmt {
  static constexpr int U = 8;
  static constexpr int UNROLL = 4;
  struct Unit {
    uint32_t lo[2], hi;
  };
  struct Pair {
    uint2 lo, hi;
    int f;  // int2 field of the even K-row (0 or 2)
    int h;  // its bit in the high plane (0, 2, 4 or 6)
  };

  static __device__ __forceinline__ void load_unit(Unit& u, const uint8_t* __restrict__ qw,
                                                   const uint8_t* __restrict__ qh, int unit,
                                                   int n0, int N, int, bool vec) {
    u.lo[0] = qmm::load4(qw + (size_t)(2 * unit) * N, n0, N, vec);
    u.lo[1] = qmm::load4(qw + (size_t)(2 * unit + 1) * N, n0, N, vec);
    u.hi = qmm::load4(qh + (size_t)unit * N, n0, N, vec);
  }
  static __device__ __forceinline__ float level(const Unit& u, int row, int c) {
    const uint32_t q2 = int2_field((u.lo[row >> 2] >> (8 * c)) & 0xFFu, row & 3);
    const uint32_t hb = (u.hi >> (8 * c + row)) & 0x1u;
    return (float)(q2 + 4 * hb);
  }

  static __device__ __forceinline__ void load_pair(Pair& p, const uint8_t* __restrict__ qw,
                                                   const uint8_t* __restrict__ qh, int k, int n,
                                                   int K, int N, bool nvec) {
    p.f = k & 3;
    p.h = k & 7;
    if (k < K) {
      p.lo = qmm::load8(qw + (size_t)(k >> 2) * N, n, N, nvec);
      p.hi = qmm::load8(qh + (size_t)(k >> 3) * N, n, N, nvec);
    } else {
      p.lo = p.hi = make_uint2(0, 0);
    }
  }
  static __device__ __forceinline__ float pair_level(const Pair& p, int j, int e) {
    const uint32_t q2 = int2_field(qmm::byte_of(p.lo, j), p.f + e);
    const uint32_t hb = (qmm::byte_of(p.hi, j) >> (p.h + e)) & 0x1u;
    return (float)(q2 + 4 * hb);
  }
};

}  // namespace

extern "C" {

// x (M, K) bf16; qweight (Kp/4, N) u8; qweight_hi (Kp/8, N) u8 for bits 3 (ignored for
// bits 2); scales/zeros (G, N) f32 -> out (M, N) bf16. ws is (ksplit, M, N) f32 scratch
// when ksplit > 1; units = GEMV units (4 K-rows for int2, 8 for int3) per split.
int lljt_qmm_sub4_gemv(const void* x, const void* qweight, const void* qweight_hi,
                       const void* scales, const void* zeros, void* out, void* ws, int M, int K,
                       int Kp, int N, int G, int bits, int ksplit, int units, void* stream) {
  cudaError_t err;
  if (bits == 2)
    err = qmm::launch_gemv<Int2Fmt>(x, qweight, nullptr, scales, zeros, out, ws, M, K, Kp, N,
                                    G, ksplit, units, stream);
  else if (bits == 3)
    err = qmm::launch_gemv<Int3Fmt>(x, qweight, qweight_hi, scales, zeros, out, ws, M, K, Kp,
                                    N, G, ksplit, units, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

int lljt_qmm_sub4_gemm(const void* x, const void* qweight, const void* qweight_hi,
                       const void* scales, const void* zeros, void* out, int M, int K, int Kp,
                       int N, int G, int bits, void* stream) {
  cudaError_t err;
  if (bits == 2)
    err = qmm::launch_gemm<Int2Fmt>(x, qweight, nullptr, scales, zeros, out, M, K, Kp, N, G,
                                    stream);
  else if (bits == 3)
    err = qmm::launch_gemm<Int3Fmt>(x, qweight, qweight_hi, scales, zeros, out, M, K, Kp, N, G,
                                    stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
