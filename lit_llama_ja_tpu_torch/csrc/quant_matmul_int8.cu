// Int8 dequant-matmul for Hopper (sm_90a): y = x @ dequant(W), bf16 x and y.
//
// Replaces: the Pallas kernel lit_llama_ja_tpu/ops/pallas/quant_matmul.py:451
//   quant_matmul_int8 (kernel body _qmm8_kernel :242), with the numerics of its exact
//   unpack="bf16" path, i.e. x @ dequantize_with_k(...).
//
// Layout (the JAX package's): qweight (K, N), int8 for symmetric absmax packs (zeros
//   0) or uint8 for asymmetric levels ({gptq,rtn}.int8); scales, zeros (G, N) f32,
//   K-row k uses group k / ceil(K/G); w = (q - z) * s.
//
// Bound on an H100: decode by the weight bytes, 1 byte per weight (the 7B step's 161
//   linears: 6.6 GB, 1.97 ms at 3.35 TB/s); prefill by tensor-core flops. The kernels
//   are the generic ones of qmm_generic.cuh; this file defines the int8 decoder. A
//   GEMV unit is 4 K-rows, so a lane keeps 8 coalesced 4-byte words in flight.
#include "qmm_generic.cuh"

namespace {

template <bool SIGNED>
__device__ __forceinline__ float int8_level(uint32_t word, int c) {
  const uint32_t byte = (word >> (8 * c)) & 0xFFu;
  return SIGNED ? (float)(int)(int8_t)byte : (float)byte;
}

template <bool SIGNED>
struct Int8Fmt {
  static constexpr int U = 4;
  static constexpr int UNROLL = 2;
  static constexpr int RPB0 = 1, RPB1 = 0;  // one K-row per stored row; no second plane
  struct Unit {
    uint32_t w[4];
  };

  static __device__ __forceinline__ void load_unit(Unit& u, const uint8_t* __restrict__ qw,
                                                   const uint8_t* __restrict__, int unit, int n0,
                                                   int N, int K, bool vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * unit + i;
      u.w[i] = k < K ? qmm::load4(qw + (size_t)k * N, n0, N, vec) : 0u;
    }
  }
  static __device__ __forceinline__ float level(const Unit& u, int row, int c) {
    return int8_level<SIGNED>(u.w[row], c);
  }

  // the GEMM's decode: K-row r of a k-tile in shared memory, columns c..c+7; a signed
  // byte is offset by 128 (its top bit flipped) and the 128 taken off again
  template <int BN>
  static __device__ __forceinline__ void tile_levels(const uint8_t* w, int r, int c, float q[8]) {
    uint2 b = *reinterpret_cast<const uint2*>(w + r * BN + c);
    if (SIGNED) b = make_uint2(b.x ^ 0x80808080u, b.y ^ 0x80808080u);
    qmm::byte_levels(b, SIGNED ? 8388736.f : 8388608.f, q);  // 2^23 (+ 128)
  }
};

}  // namespace

extern "C" {

// x (M, K) bf16, qweight (K, N) int8 (is_signed) or uint8, scales/zeros (G, N) f32
// -> out (M, N) bf16. ws is (ksplit, M, N) f32 scratch when ksplit > 1; units = 4-row
// units per split.
int lljt_qmm8_gemv(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, void* ws, int M, int K, int N, int G, int is_signed, int ksplit,
                   int units, void* stream) {
  cudaError_t err =
      is_signed ? qmm::launch_gemv<Int8Fmt<true>>(x, qweight, nullptr, scales, zeros, out, ws,
                                                  M, K, K, N, G, ksplit, units, stream)
                : qmm::launch_gemv<Int8Fmt<false>>(x, qweight, nullptr, scales, zeros, out, ws,
                                                   M, K, K, N, G, ksplit, units, stream);
  return static_cast<int>(err);
}

// bn, xw, ww, sw: the tile width and copy widths of the wrapper's GEMM plan.
int lljt_qmm8_gemm(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, int M, int K, int N, int G, int is_signed, int bn, int xw, int ww,
                   int sw, void* stream) {
  cudaError_t err =
      is_signed ? qmm::launch_gemm<Int8Fmt<true>>(x, qweight, nullptr, scales, zeros, out, M, K,
                                                  K, N, G, bn, xw, ww, sw, stream)
                : qmm::launch_gemm<Int8Fmt<false>>(x, qweight, nullptr, scales, zeros, out, M,
                                                   K, K, N, G, bn, xw, ww, sw, stream);
  return static_cast<int>(err);
}

}  // extern "C"
