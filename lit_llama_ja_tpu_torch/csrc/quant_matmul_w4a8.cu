// Int4 dequant-matmul with int8 activations (W4A8) for Hopper (sm_90a):
// y = sum over k of xq[k] * (q[k] - z) * s, with xq the int8-rounded activation.
//
// Replaces: the int8-operand modes of the Pallas kernel
//   lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325 quant_matmul_int4 (unpack =
//   "int8dot_bias", "int8dot_bias_bc", "int8dot_fused", "int8dot"; kernel body
//   _qmm4_kernel :45, its W4A8 epilogues :166-221, the tile plan _plan_tiles :301 at
//   block_k 512 for M <= 64 and 1024 above), which the JAX function picks by itself at
//   M <= 64. The four names differ only in how the TPU unpacks a byte and in the f32
//   order of the epilogue; all of them compute the same sum with the same xq.
//
// The kernels are the A8 kernels of qmm_a8.cuh (numerics, routes, bound) with the int4
//   decoder below; plain version ops/cuda/quant_matmul.py::quant_matmul_int4_w4a8_ref,
//   activation groups from the wrapper's w4a8_plan. At M <= 16 (decode) the weight bytes
//   bound it: the decode route (a8_gemv, lljt_qmm4_w4a8_gemv) loads each lane's own A
//   fragments by 16-byte loads into registers, several warps and batches in flight,
//   rounds x inside the launch and sums the K splits of a cluster over distributed
//   shared memory: one launch, no scratch. Above 16 rows the three launches of
//   a8_quantize, a8_mma, a8_merge.
//
// Layout (the JAX package's): qweight (K/2, N) uint8, byte r holds K-row 2r in the low
//   nibble (plain) and K-row 2r+1 in the high nibble stored (q - 8) & 0xF
//   ("hi-biased-v2"), so (byte & 0xF0) read as int8 is exactly 16 * (q_hi - 8) and
//   ((byte & 0x0F) << 4) ^ 0x80 is 16 * (q_lo - 8). scales, zeros (G, N) f32; group j
//   reads scale row j / rep.
#include "qmm_a8.cuh"

namespace {

// The int4 decoder of the A8 kernel (qmm_a8.cuh): packed rows 16 a k32 step, each byte
// two K-rows; both nibbles become 16 * (q - 8) (the int8dot_fused form), so D / 16 is
// the group's sum in levels and zshift is 8.
struct Int4A8 {
  static constexpr int PLANES = 1, ROWS0 = 16, ROWS1 = 0, U = 4, SHIFT = 4;

  // The four int8 weights of K-rows 4r .. 4r+3 of one column, from its bytes p0 (packed
  // row 2r) and p1 (2r + 1), each 16 * (q - 8): the low nibble (plain q) moved up with
  // its bit 3 flipped, the high nibble (stored (q - 8) & 0xF) as it is.
  static __device__ __forceinline__ uint32_t fused_quad(uint32_t p0, uint32_t p1) {
    const uint32_t t = p0 | (p1 << 16);
    return (((t & 0x000F000Fu) << 4) ^ 0x00800080u) | ((t & 0x00F000F0u) << 8);
  }

  static __device__ __forceinline__ uint32_t frag(const uint8_t* tile, int u, int h, int t,
                                                  int c) {
    const uint8_t* p = tile + (16 * u + 8 * h + 2 * t) * a8::COLS + c;
    return fused_quad(p[0], p[a8::COLS]);
  }

  // decode: packed rows 16s + 4t + i, i.e. K-rows 8t + 2i and 8t + 2i + 1 of step s
  static constexpr int GLOADS = 4, GU = 1;
  static __device__ __forceinline__ int grow(int s, int t, int i) { return 16 * s + 4 * t + i; }
  static __device__ __forceinline__ bool gplane(int) { return false; }

  // mma j's A fragment: columns 2j (a0, a2) and 2j + 1 (a1, a3) of the lane's 16, bytes p
  // and p + 1 of word j / 2 of each load (p = 2 (j % 2)); K-rows 8t .. 8t + 3 from loads
  // 0 and 1 (a0, a1), 8t + 4 .. 8t + 7 from loads 2 and 3 (a2, a3). One byte permute puts
  // the two rows' bytes where fused_quad reads them (bytes 0 and 2).
  static __device__ __forceinline__ void gfrag(const uint4 (&w)[GLOADS], int j, uint32_t a[4]) {
    const int wd = j >> 1, p = 2 * (j & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r0 = qmmv::word(w[2 * h], wd), r1 = qmmv::word(w[2 * h + 1], wd);
      a[2 * h] = fused_word(__byte_perm(r0, r1, p | (p + 4) << 8));
      a[2 * h + 1] = fused_word(__byte_perm(r0, r1, (p + 1) | (p + 5) << 8));
    }
  }

  // fused_quad of the bytes 0 and 2 of t (the others ignored)
  static __device__ __forceinline__ uint32_t fused_word(uint32_t t) {
    return (((t & 0x000F000Fu) << 4) ^ 0x00800080u) | ((t & 0x00F000F0u) << 8);
  }
};

}  // namespace

extern "C" {

// x (M, K) bf16, qweight (K/2, N) u8, scales/zeros (G, N) f32 -> out (M, N), bf16 or
// (out_f32) f32. Scratch from the wrapper: xq (Mpad, Kpad) int8, rsx and sx (Mpad,
// n_act) f32 and int32, ws (ksplit, Mpad, N) f32 when ksplit > 1, with Mpad = M rounded
// up to 16 * mt and Kpad = K rounded up to 32. group * n_act == K; group j reads scale
// row j / rep. mt, ksplit, vec: the wrapper's a8_launch_plan.
int lljt_qmm4_w4a8(const void* x, const void* qweight, const void* scales, const void* zeros,
                   void* out, void* xq, void* rsx, void* sx, void* ws, int M, int K, int N,
                   int group, int n_act, int rep, int mt, int ksplit, int out_f32, int vec,
                   void* stream) {
  if (K % 2 || group <= 0 || group * n_act != K) return static_cast<int>(cudaErrorInvalidValue);
  const a8::Args a{x, static_cast<const uint8_t*>(qweight), nullptr, K / 2, 0,
                   static_cast<const float*>(scales), static_cast<const float*>(zeros), 8.f,
                   out, xq, rsx, sx, ws, M, K, N, group, n_act, rep, mt, ksplit, out_f32, vec};
  return a8::launch<Int4A8>(a, static_cast<cudaStream_t>(stream));
}

// The decode route (M <= 16) of lljt_qmm4_w4a8: one launch, out (M, N) the only buffer
// written (levels: null, or the rounding check's x̂, rsx and sums, see a8::GemvArgs).
// ksplit, steps, lw: the wrapper's a8_gemv_plan. group * n_act == K.
int lljt_qmm4_w4a8_gemv(const void* x, const void* qweight, const void* scales,
                        const void* zeros, void* out, void* levels, int M, int K, int N,
                        int group, int n_act, int rep, int ksplit, int steps, int lw,
                        int out_f32, void* stream) {
  if (K % 2 || group <= 0 || group * n_act != K) return static_cast<int>(cudaErrorInvalidValue);
  const a8::GemvArgs a{x, static_cast<const uint8_t*>(qweight), nullptr, K / 2, 0,
                       static_cast<const float*>(scales), static_cast<const float*>(zeros), 8.f,
                       out, levels, M, K, N, group, n_act, rep, ksplit, steps, lw, out_f32};
  return a8::launch_gemv<Int4A8>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
