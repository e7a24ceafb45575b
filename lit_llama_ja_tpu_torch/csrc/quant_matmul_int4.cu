// Int4 dequant-matmul for Hopper (sm_90a): y = x @ dequant(W), bf16 x and y.
//
// Replaces: the Pallas kernel lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325
//   quant_matmul_int4 (kernel body _qmm4_kernel :45, tiling _plan_tiles :301), with
//   the numerics of its exact unpack="bf16" path, i.e. x @ dequantize_with_k(...).
//
// Layout (the JAX package's, unchanged): qweight (K/2, N) uint8, byte r holds K-row
//   2r in the low nibble (plain) and K-row 2r+1 in the high nibble stored (q-8)&0xF
//   ("hi-biased-v2"); scales, zeros (G, N) f32, K-row k uses group k / ceil(K/G),
//   as lit_llama_ja_tpu/quant/linear.py:475 _expand_tiles does; w = (q - z) * s.
//
// What bounds it on an H100, and what the design does about it:
//   * Decode (M <= 16) is bound by the weight bytes: 0.5 byte per weight against
//     about 2*M flops. It runs the tensor-core GEMV of qmm_gemv.cuh (see its note)
//     through the decoder Int4Gemv below: a byte is a k-pair of one column, which is
//     what one 32-bit register of an mma A fragment holds, so a k-pair decodes in one
//     byte permute and one lop3.
//   * Prefill (M > 16) is bound by tensor-core flops: 2*M*K*N against K*N/2 weight
//     bytes. It runs the one GEMM of qmm_generic.cuh (see its note) through the
//     decoder Int4Fmt below: a k-tile's 32 packed rows are copied as stored, and
//     K-row r reads the low (r even) or high (r odd) nibble of packed row r/2.
#include "qmm_generic.cuh"
#include "qmm_gemv.cuh"

namespace {

// The GEMV's decoder. Lane (g, t) loads packed rows 8s + 2t and 8s + 2t + 1 of k16
// step s (K-rows 16s + 4t .. 16s + 4t + 3), columns 16g..16g+15.
struct Int4Gemv {
  static constexpr int LOADS = 2;      // packed rows a lane loads per k16 step
  static constexpr int U = 4;          // k16 steps a batch of loads (the fast route)
  static constexpr int PARTS = 1;      // products a fragment
  static constexpr float ZOFF = 128.f;  // a level decodes to 128 + q
  static __device__ __forceinline__ int rows(int Kp, int) { return Kp >> 1; }
  static __device__ __forceinline__ int row(int s, int t, int i) { return 8 * s + 2 * t + i; }
  static __host__ __device__ constexpr int plane(int) { return 0; }  // one plane

  // bf16x2 {128 + q(K-row 2r), 128 + q(K-row 2r + 1)} of byte p of w: a byte permute
  // puts the low nibble under bf16 128.0 (0x4300) in the low half and the high nibble
  // in the high half; the lop3 masks both and flips the high nibble's bit 3, which
  // undoes its (q - 8) & 0xF.
  static __device__ __forceinline__ uint32_t pair(uint32_t w, int p) {
    return (__byte_perm(w, w >> 4, ((4 + p) << 8) | p) & 0x000F000Fu) ^ 0x43084300u;
  }

  // mma j's A fragment: columns 16g + 2j (a0, a2) and 16g + 2j + 1 (a1, a3), K-rows of
  // packed row 8s + 2t (a0, a1) and 8s + 2t + 1 (a2, a3)
  static __device__ __forceinline__ void frag(const uint4 (&w)[LOADS], int j, int,
                                              uint32_t a[4]) {
    const uint32_t w0 = qmmv::word(w[0], j >> 1), w1 = qmmv::word(w[1], j >> 1);
    const int p = 2 * (j & 1);
    a[0] = pair(w0, p);
    a[1] = pair(w0, p + 1);
    a[2] = pair(w1, p);
    a[3] = pair(w1, p + 1);
  }
};

// The GEMM's decoder: K-row r of a k-tile in shared memory (the tile's BK / 2 packed
// rows as stored), columns c..c+7, four columns a word.
struct Int4Fmt {
  static constexpr int RPB0 = 2, RPB1 = 0;  // two K-rows per packed row; no second plane
  template <int BN>
  static __device__ __forceinline__ void tile_levels(const uint8_t* w, int r, int c, float q[8]) {
    const uint2 b = *reinterpret_cast<const uint2*>(w + (r >> 1) * BN + c);
    const int shift = 4 * (r & 1);
    const uint32_t flip = (r & 1) ? 0x08080808u : 0u;  // the high nibble's (q - 8) & 0xF
    qmm::byte_levels(make_uint2(((b.x >> shift) & 0x0F0F0F0Fu) ^ flip,
                                ((b.y >> shift) & 0x0F0F0F0Fu) ^ flip),
                     8388608.f, q);  // 2^23
  }
};

}  // namespace

extern "C" {

// x (M, K) bf16 (M <= 16), qweight (K/2, N) u8, scales/zeros (G, N) f32 -> out (M, N)
// bf16. ksplit, steps, lw, xw, sw: the wrapper's GEMV plan.
int lljt_qmm4_gemv(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, int M, int K, int N, int G, int ksplit, int steps, int fast,
                   int lw, int xw, int sw, void* stream) {
  if (K % 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(qmmv::launch<Int4Gemv>(x, qweight, nullptr, scales, zeros, out, M, K,
                                                 K, N, G, ksplit, steps, fast, lw, xw, sw,
                                                 stream));
}

// bn, xw, ww, sw: the tile width and copy widths of the wrapper's GEMM plan.
int lljt_qmm4_gemm(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, int M, int K, int N, int G, int bn, int xw, int ww, int sw,
                   void* stream) {
  return static_cast<int>(qmm::launch_gemm<Int4Fmt>(x, qweight, nullptr, scales, zeros, out, M,
                                                    K, K, N, G, bn, xw, ww, sw, stream));
}

}  // extern "C"
