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

// field f of each of the four bytes of a word, one level a byte
__device__ __forceinline__ uint32_t int2_fields(uint32_t word, int f) {
  return ((word >> (2 * f)) & 0x03030303u) ^ (f == 3 ? 0x02020202u : 0u);
}

struct Int2Fmt {
  static constexpr int U = 4;
  static constexpr int UNROLL = 8;
  static constexpr int RPB0 = 4, RPB1 = 0;  // four K-rows per packed row; no second plane
  struct Unit {
    uint32_t w;
  };

  static __device__ __forceinline__ void load_unit(Unit& u, const uint8_t* __restrict__ qw,
                                                   const uint8_t* __restrict__, int unit, int n0,
                                                   int N, int, bool vec) {
    u.w = qmm::load4(qw + (size_t)unit * N, n0, N, vec);
  }
  static __device__ __forceinline__ float level(const Unit& u, int row, int c) {
    return (float)int2_field((u.w >> (8 * c)) & 0xFFu, row);
  }

  // the GEMM's decode: K-row r of a k-tile in shared memory, columns c..c+7; the
  // fields of four columns are cut from a word at once
  template <int BN>
  static __device__ __forceinline__ void tile_levels(const uint8_t* w, int r, int c, float q[8]) {
    const uint2 b = *reinterpret_cast<const uint2*>(w + (r >> 2) * BN + c);
    qmm::byte_levels(make_uint2(int2_fields(b.x, r & 3), int2_fields(b.y, r & 3)), 8388608.f, q);
  }
};

struct Int3Fmt {
  static constexpr int U = 8;
  static constexpr int UNROLL = 4;
  static constexpr int RPB0 = 4, RPB1 = 8;  // int2 plane: 4 K-rows a row; high bits: 8
  struct Unit {
    uint32_t lo[2], hi;
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

  // the GEMM's decode: K-row r of a k-tile in shared memory (the int2 plane's BK / 4
  // rows, then the high-bit plane's BK / 8), columns c..c+7, four columns a word
  template <int BN>
  static __device__ __forceinline__ void tile_levels(const uint8_t* w, int r, int c, float q[8]) {
    const uint2 lo = *reinterpret_cast<const uint2*>(w + (r >> 2) * BN + c);
    const uint2 hi = *reinterpret_cast<const uint2*>(w + (qmm::BK / 4 + (r >> 3)) * BN + c);
    const int f = r & 3, h = r & 7;
    qmm::byte_levels(make_uint2(int2_fields(lo.x, f) | (((hi.x >> h) & 0x01010101u) << 2),
                                int2_fields(lo.y, f) | (((hi.y >> h) & 0x01010101u) << 2)),
                     8388608.f, q);
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

// bn, xw, ww, sw: the tile width and copy widths of the wrapper's GEMM plan.
int lljt_qmm_sub4_gemm(const void* x, const void* qweight, const void* qweight_hi,
                       const void* scales, const void* zeros, void* out, int M, int K, int Kp,
                       int N, int G, int bits, int bn, int xw, int ww, int sw, void* stream) {
  cudaError_t err;
  if (bits == 2)
    err = qmm::launch_gemm<Int2Fmt>(x, qweight, nullptr, scales, zeros, out, M, K, Kp, N, G, bn,
                                    xw, ww, sw, stream);
  else if (bits == 3)
    err = qmm::launch_gemm<Int3Fmt>(x, qweight, qweight_hi, scales, zeros, out, M, K, Kp, N, G,
                                    bn, xw, ww, sw, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
