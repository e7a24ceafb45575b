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
//   linears: 6.6 GB, 1.97 ms at 3.35 TB/s); prefill by tensor-core flops. Decode runs the
//   tensor-core GEMV of qmm_gemv.cuh through the decoder Int8Gemv below, prefill the
//   GEMM of qmm_generic.cuh through Int8Fmt.
#include "qmm_generic.cuh"
#include "qmm_gemv.cuh"

namespace {

// The GEMV's decoder. Lane (g, t) loads rows 16s + 4t .. 16s + 4t + 3 of k16 step s,
// columns 16g..16g+15. A level (a byte b = 16 hi + lo) decodes without an I2F into two
// bf16 A fragments that add up in the same accumulator: one byte permute puts b of two
// K-rows under the two halves of a word, then one lop3 gives {128 + lo} (bf16 128.0 is
// 0x4300, ulp 1) and a shift and one lop3 give {256 + 16 hi} (bf16 256.0 is 0x4380, ulp
// 2, hi at mantissa bits 3-6); the two products sum x * (b + 384). A signed byte has its
// top bit flipped in the same lop3, so it decodes to q + 128 + 384 (ZOFF).
template <bool SIGNED>
struct Int8Gemv {
  static constexpr int LOADS = 4;  // rows a lane loads per k16 step
  static constexpr int U = 2;      // k16 steps a batch of loads (the fast route)
  static constexpr int PARTS = 2;  // products a fragment: the low and the high nibbles
  static constexpr float ZOFF = SIGNED ? 512.f : 384.f;
  static __device__ __forceinline__ int rows(int Kp, int) { return Kp; }
  static __device__ __forceinline__ int row(int s, int t, int i) { return 16 * s + 4 * t + i; }
  static __host__ __device__ constexpr int plane(int) { return 0; }  // one plane

  // bf16x2 of byte p of rows a (low half) and b (high half): part 0 the low nibbles,
  // 128 + lo; part 1 the high nibbles, 256 + 16 hi (signed: hi with its bit 3 flipped)
  static __device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b, int p, int part) {
    const uint32_t v = __byte_perm(a, b, ((4 + p) << 8) | p);
    if (part == 0) return (v & 0x000F000Fu) | 0x43004300u;
    return ((v >> 1) & 0x00780078u) ^ (SIGNED ? 0x43C043C0u : 0x43804380u);
  }

  // mma j's A fragment of one part: columns 16g + 2j (a0, a2) and 16g + 2j + 1 (a1,
  // a3); K-rows 4t, 4t + 1 (a0, a1) and 4t + 2, 4t + 3 (a2, a3) of the step
  static __device__ __forceinline__ void frag(const uint4 (&w)[LOADS], int j, int part,
                                              uint32_t a[4]) {
    const int q = j >> 1, p = 2 * (j & 1);
    const uint32_t r0 = qmmv::word(w[0], q), r1 = qmmv::word(w[1], q);
    const uint32_t r2 = qmmv::word(w[2], q), r3 = qmmv::word(w[3], q);
    a[0] = pair(r0, r1, p, part);
    a[1] = pair(r0, r1, p + 1, part);
    a[2] = pair(r2, r3, p, part);
    a[3] = pair(r2, r3, p + 1, part);
  }
};

template <bool SIGNED>
struct Int8Fmt {
  static constexpr int RPB0 = 1, RPB1 = 0;  // one K-row per stored row; no second plane

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

// x (M, K) bf16 (M <= 16), qweight (K, N) int8 (is_signed) or uint8, scales/zeros (G, N)
// f32 -> out (M, N) bf16. ksplit, steps, lw, xw, sw: the wrapper's GEMV plan.
int lljt_qmm8_gemv(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, int M, int K, int N, int G, int is_signed, int ksplit, int steps,
                   int fast, int lw, int xw, int sw, void* stream) {
  cudaError_t err =
      is_signed ? qmmv::launch<Int8Gemv<true>>(x, qweight, nullptr, scales, zeros, out, M, K, K,
                                               N, G, ksplit, steps, fast, lw, xw, sw, stream)
                : qmmv::launch<Int8Gemv<false>>(x, qweight, nullptr, scales, zeros, out, M, K, K,
                                                N, G, ksplit, steps, fast, lw, xw, sw, stream);
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
