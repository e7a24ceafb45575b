// Int2 and int3 dequant-matmuls with int8 activations (W2A8, W3A8) for Hopper (sm_90a):
// y = sum over k of xq[k] * (q[k] - z) * s, with xq the int8-rounded activation.
//
// Replaces the int8-operand modes of the Pallas kernel that the JAX functions pick by
//   themselves on their chip:
//   * lljt_qmm_sub4_a8: lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447
//     quant_matmul_int2 and :323 quant_matmul_int3 with unpack="int8dot", "int8dot_bc"
//     or "int8dot_fused" (kernel body _qmm_sub4_kernel :81, its A8 epilogues :198-257,
//     tiles from _common_tiling :297; JAX's choice at M <= 64 for int3 and for
//     whole-column int2 packs). The three names differ only in how the TPU casts the
//     planes and in the f32 order of the epilogue; each sums the same exact integers.
//
// The kernels are the A8 kernels of qmm_a8.cuh (numerics, routes, bound) with the
// decoders below; plain version ops/cuda/quant_matmul_sub4.py::quant_matmul_sub4_a8_ref,
// activation groups from the wrapper's sub4_a8_plan. At M <= 16 (decode) the weight
// bytes bound them: the decode route (a8_gemv, lljt_qmm_sub4_a8_gemv) loads each lane's
// own A fragments by 16-byte loads into registers, several warps and batches in flight,
// rounds x inside the launch and sums the K splits of a cluster over distributed shared
// memory: one launch, no scratch. Above 16 rows the three launches of a8_quantize,
// a8_mma, a8_merge. The int8 decoders are in quant_matmul_a8.cu, a source of their own so
// that the two compile side by side.
//
// Layouts (the JAX package's):
//   * int2: qweight (Kp/4, N) uint8, byte r holds K-rows 4r + j at bits 2j, field 3
//     stored (q - 2) & 3. One byte is one B register: its fields spread into four bytes,
//     field 3's bias undone by an XOR.
//   * int3: the int2 qweight of the low two bits and qweight_hi (Kp/8, N) uint8, bit i
//     of byte r the high bit of K-row 8r + i; a register's four high bits (one nibble)
//     spread into bit 2 of its bytes: q = q2 + 4 hi.
//   scales, zeros (G, N) f32; group j reads scale row j / rep. Kp >= K stored rows
//   (sub4_pad_rows), whose pad rows hold level 0 and meet x = 0.
#include "qmm_a8.cuh"

namespace {

// The four 2-bit fields of an int2 byte as four bytes, field 3's (q - 2) & 3 undone.
__device__ __forceinline__ uint32_t spread2(uint32_t b) {
  return ((b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u) ^ 0x02000000u;
}

// byte b of a word, alone
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int b) { return (w >> (8 * b)) & 0xFFu; }

// The four high bits of a nibble moved to bit 2 of four bytes.
__device__ __forceinline__ uint32_t high4(uint32_t n) {
  return ((n | (n << 7) | (n << 14) | (n << 21)) & 0x01010101u) << 2;
}

struct Int2A8 {
  static constexpr int PLANES = 1, ROWS0 = 8, ROWS1 = 0, U = 8, SHIFT = 0;
  static constexpr int GLOADS = 2, GU = 2;  // decode: packed rows 8s + 2t, 8s + 2t + 1
  static __device__ __forceinline__ int grow(int s, int t, int i) { return 8 * s + 2 * t + i; }
  static __device__ __forceinline__ bool gplane(int) { return false; }

  // decode: a column's byte of load 0 is K-rows 8t .. 8t + 3, of load 1 8t + 4 .. 8t + 7
  static __device__ __forceinline__ void gfrag(const uint4 (&w)[GLOADS], int j, uint32_t a[4]) {
    const int p = 2 * (j & 1);
    const uint32_t v0 = qmmv::word(w[0], j >> 1), v1 = qmmv::word(w[1], j >> 1);
    a[0] = spread2(byte_of(v0, p));
    a[1] = spread2(byte_of(v0, p + 1));
    a[2] = spread2(byte_of(v1, p));
    a[3] = spread2(byte_of(v1, p + 1));
  }

  static __device__ __forceinline__ uint32_t frag(const uint8_t* tile, int u, int h, int t,
                                                  int c) {
    return spread2(tile[(8 * u + 4 * h + t) * a8::COLS + c]);
  }
};

struct Int3A8 {
  static constexpr int PLANES = 2, ROWS0 = 8, ROWS1 = 4, U = 8, SHIFT = 0;
  // decode: Int2A8's two loads and the bit-plane row 4s + t, whose byte holds the high
  // bits of a column's K-rows 8t .. 8t + 7 (low nibble: the first four)
  static constexpr int GLOADS = 3, GU = 1;
  static __device__ __forceinline__ int grow(int s, int t, int i) {
    return i < 2 ? 8 * s + 2 * t + i : 4 * s + t;
  }
  static __device__ __forceinline__ bool gplane(int i) { return i == 2; }

  static __device__ __forceinline__ void gfrag(const uint4 (&w)[GLOADS], int j, uint32_t a[4]) {
    const int p = 2 * (j & 1);
    const uint32_t v0 = qmmv::word(w[0], j >> 1), v1 = qmmv::word(w[1], j >> 1);
    const uint32_t h = qmmv::word(w[2], j >> 1);
    const uint32_t h0 = byte_of(h, p), h1 = byte_of(h, p + 1);
    a[0] = spread2(byte_of(v0, p)) | high4(h0 & 0xFu);
    a[1] = spread2(byte_of(v0, p + 1)) | high4(h1 & 0xFu);
    a[2] = spread2(byte_of(v1, p)) | high4(h0 >> 4);
    a[3] = spread2(byte_of(v1, p + 1)) | high4(h1 >> 4);
  }

  // K-rows 32 u + 16 h + 4 t .. + 3: int2 byte 8 u + 4 h + t, and the nibble 4 (t % 2)
  // of bit-plane byte 4 u + 2 h + t / 2, each bit moved to bit 2 of its byte
  static __device__ __forceinline__ uint32_t frag(const uint8_t* tile, int u, int h, int t,
                                                  int c) {
    const uint8_t* hi = tile + U * ROWS0 * a8::COLS;
    const uint32_t n = (hi[(4 * u + 2 * h + (t >> 1)) * a8::COLS + c] >> (4 * (t & 1))) & 0xFu;
    const uint32_t h4 = ((n | (n << 7) | (n << 14) | (n << 21)) & 0x01010101u) << 2;
    return spread2(tile[(8 * u + 4 * h + t) * a8::COLS + c]) | h4;
  }
};

}  // namespace

extern "C" {

// x (M, K) bf16, qweight (Kp/4, N) u8 and, for bits 3, qweight_hi (Kp/8, N) u8;
// scales/zeros (G, N) f32 -> out (M, N), bf16 or (out_f32) f32. Scratch as
// lljt_qmm8_w8a8's (quant_matmul_a8.cu), with Kpad = group * n_act rounded up to 32.
// K <= group * n_act <= Kp: the groups cover every K-row (stored rows past them are not
// read).
int lljt_qmm_sub4_a8(const void* x, const void* qweight, const void* qweight_hi,
                     const void* scales, const void* zeros, void* out, void* xq, void* rsx,
                     void* sx, void* ws, int M, int K, int Kp, int N, int group, int n_act,
                     int rep, int mt, int ksplit, int out_f32, int vec, int bits,
                     void* stream) {
  if (Kp % 8 || group <= 0 || static_cast<long long>(group) * n_act > Kp ||
      !(bits == 2 || (bits == 3 && qweight_hi != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const a8::Args a{x, static_cast<const uint8_t*>(qweight),
                   static_cast<const uint8_t*>(qweight_hi), Kp / 4, Kp / 8,
                   static_cast<const float*>(scales), static_cast<const float*>(zeros), 0.f,
                   out, xq, rsx, sx, ws, M, K, N, group, n_act, rep, mt, ksplit, out_f32, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 2 ? a8::launch<Int2A8>(a, st) : a8::launch<Int3A8>(a, st);
}

// The decode route of lljt_qmm_sub4_a8: K <= group * n_act <= Kp.
int lljt_qmm_sub4_a8_gemv(const void* x, const void* qweight, const void* qweight_hi,
                          const void* scales, const void* zeros, void* out, void* levels, int M,
                          int K, int Kp, int N, int group, int n_act, int rep, int ksplit,
                          int steps, int lw, int out_f32, int bits, void* stream) {
  if (Kp % 8 || group <= 0 || static_cast<long long>(group) * n_act > Kp ||
      !(bits == 2 || (bits == 3 && qweight_hi != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const a8::GemvArgs a{x, static_cast<const uint8_t*>(qweight),
                       bits == 3 ? static_cast<const uint8_t*>(qweight_hi) : nullptr, Kp / 4,
                       Kp / 8, static_cast<const float*>(scales),
                       static_cast<const float*>(zeros), 0.f, out, levels, M, K, N, group,
                       n_act, rep, ksplit, steps, lw, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 2 ? a8::launch_gemv<Int2A8>(a, st) : a8::launch_gemv<Int3A8>(a, st);
}

}  // extern "C"
