// Int8, int2 and int3 dequant-matmuls with int8 activations (W8A8, W2A8, W3A8) for
// Hopper (sm_90a): y = sum over k of xq[k] * (q[k] - z) * s, with xq the int8-rounded
// activation.
//
// Replaces the int8-operand modes of two Pallas kernels, which the JAX functions pick by
//   themselves on their chip:
//   * lljt_qmm8_w8a8: lit_llama_ja_tpu/ops/pallas/quant_matmul.py:451 quant_matmul_int8
//     with unpack="int8dot" (kernel body _qmm8_kernel :242, its W8A8 epilogue :259-287,
//     tiles from _plan_tiles :301 at block_k 256 for M <= 64 and 2048 above; the JAX
//     package's llm.int8-dyn bulk product takes it at every M, quant/linear.py:544-550).
//   * lljt_qmm_sub4_a8: lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447
//     quant_matmul_int2 and :323 quant_matmul_int3 with unpack="int8dot", "int8dot_bc"
//     or "int8dot_fused" (kernel body _qmm_sub4_kernel :81, its A8 epilogues :198-257,
//     tiles from _common_tiling :297; JAX's choice at M <= 64 for int3 and for
//     whole-column int2 packs). The three names differ only in how the TPU casts the
//     planes and in the f32 order of the epilogue; each sums the same exact integers.
//
// The kernel is the A8 kernel of qmm_a8.cuh (numerics, launches, bound) with the
// decoders below; plain versions ops/cuda/quant_matmul.py::quant_matmul_int8_w8a8_ref and
// ops/cuda/quant_matmul_sub4.py::quant_matmul_sub4_a8_ref, activation groups from the
// wrappers' w8a8_plan and sub4_a8_plan.
//
// Layouts (the JAX package's):
//   * int8: qweight (K, N) int8 (symmetric, zeros 0) or uint8 (asymmetric levels). A
//     k32 step reads 32 rows N bytes apart, so the four K-rows of a B register are
//     gathered from the shared tile; uint8 levels become s8 by an XOR with 0x80 (q - 128,
//     zshift 128).
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

template <bool SIGNED>
struct Int8A8 {
  static constexpr int PLANES = 1, ROWS0 = 32, ROWS1 = 0, U = 2, SHIFT = 0;

  static __device__ __forceinline__ uint32_t frag(const uint8_t* tile, int u, int h, int t,
                                                  int c) {
    const uint8_t* p = tile + (32 * u + 16 * h + 4 * t) * a8::COLS + c;
    const uint32_t v = p[0] | (p[a8::COLS] << 8) | (p[2 * a8::COLS] << 16) |
                       (static_cast<uint32_t>(p[3 * a8::COLS]) << 24);
    return SIGNED ? v : v ^ 0x80808080u;
  }
};

// The four 2-bit fields of an int2 byte as four bytes, field 3's (q - 2) & 3 undone.
__device__ __forceinline__ uint32_t spread2(uint32_t b) {
  return ((b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u) ^ 0x02000000u;
}

struct Int2A8 {
  static constexpr int PLANES = 1, ROWS0 = 8, ROWS1 = 0, U = 8, SHIFT = 0;

  static __device__ __forceinline__ uint32_t frag(const uint8_t* tile, int u, int h, int t,
                                                  int c) {
    return spread2(tile[(8 * u + 4 * h + t) * a8::COLS + c]);
  }
};

struct Int3A8 {
  static constexpr int PLANES = 2, ROWS0 = 8, ROWS1 = 4, U = 8, SHIFT = 0;

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

// x (M, K) bf16, qweight (K, N) int8 (is_signed) or uint8, scales/zeros (G, N) f32 ->
// out (M, N), bf16 or (out_f32) f32. Scratch from the wrapper: xq (Mpad, Kpad) int8, rsx
// and sx (Mpad, n_act) f32 and int32, ws (ksplit, Mpad, N) f32 when ksplit > 1, with
// Mpad = M rounded up to 16 * mt and Kpad = K rounded up to 32. group * n_act == K;
// group j reads scale row j / rep. mt, ksplit, vec: the wrapper's a8_launch_plan.
int lljt_qmm8_w8a8(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, void* xq, void* rsx, void* sx, void* ws, int M, int K, int N,
                   int group, int n_act, int rep, int mt, int ksplit, int out_f32, int vec,
                   int is_signed, void* stream) {
  if (group <= 0 || group * n_act != K) return static_cast<int>(cudaErrorInvalidValue);
  const a8::Args a{x, static_cast<const uint8_t*>(qweight), nullptr, K, 0,
                   static_cast<const float*>(scales), static_cast<const float*>(zeros),
                   is_signed ? 0.f : 128.f, out, xq, rsx, sx, ws, M, K, N, group, n_act, rep,
                   mt, ksplit, out_f32, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_signed ? a8::launch<Int8A8<true>>(a, st) : a8::launch<Int8A8<false>>(a, st);
}

// x (M, K) bf16, qweight (Kp/4, N) u8 and, for bits 3, qweight_hi (Kp/8, N) u8;
// scales/zeros (G, N) f32 -> out (M, N), bf16 or (out_f32) f32. Scratch as
// lljt_qmm8_w8a8's, with Kpad = group * n_act rounded up to 32. K <= group * n_act <= Kp:
// the groups cover every K-row (stored rows past them are not read).
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

}  // extern "C"
