// Int8 dequant-matmul with int8 activations (W8A8) for Hopper (sm_90a): y = sum over k
// of xq[k] * (q[k] - z) * s, with xq the int8-rounded activation.
//
// Replaces the int8-operand mode of a Pallas kernel, which the JAX functions pick by
//   themselves on their chip:
//   * lljt_qmm8_w8a8: lit_llama_ja_tpu/ops/pallas/quant_matmul.py:451 quant_matmul_int8
//     with unpack="int8dot" (kernel body _qmm8_kernel :242, its W8A8 epilogue :259-287,
//     tiles from _plan_tiles :301 at block_k 256 for M <= 64 and 2048 above; the JAX
//     package's llm.int8-dyn bulk product takes it at every M, quant/linear.py:544-550).
//
// The kernels are the A8 kernels of qmm_a8.cuh (numerics, routes, bound) with the
// decoder below; plain version ops/cuda/quant_matmul.py::quant_matmul_int8_w8a8_ref,
// activation groups from the wrapper's w8a8_plan. At M <= 16 (decode) the weight bytes
// bound them: the decode route (a8_gemv, lljt_qmm8_w8a8_gemv) loads each lane's own A
// fragments by 16-byte loads into registers, several warps and batches in flight, rounds
// x inside the launch and sums the K splits of a cluster over distributed shared memory:
// one launch, no scratch. Above 16 rows the three launches of a8_quantize, a8_mma,
// a8_merge. The int2 and int3 decoders (W2A8, W3A8) are in quant_matmul_sub4_a8.cu, a
// source of their own so that the two compile side by side.
//
// Layout (the JAX package's): qweight (K, N) int8 (symmetric, zeros 0) or uint8
//   (asymmetric levels). A k32 step reads 32 rows N bytes apart, so the four K-rows of a
//   register are gathered: from the shared tile (above 16 rows), or by a 4x4 byte
//   transpose of four 16-byte loads' words (decode); uint8 levels become s8 by an XOR
//   with 0x80 (q - 128, zshift 128). scales, zeros (G, N) f32; group j reads scale row
//   j / rep.
#include "qmm_a8.cuh"

namespace {

template <bool SIGNED>
struct Int8A8 {
  static constexpr int PLANES = 1, ROWS0 = 32, ROWS1 = 0, U = 2, SHIFT = 0;
  static constexpr int GLOADS = 8, GU = 1;  // decode: K-rows 8t .. 8t + 7, a row a load
  static __device__ __forceinline__ int grow(int s, int t, int i) { return 32 * s + 8 * t + i; }
  static __device__ __forceinline__ bool gplane(int) { return false; }

  // decode: mma j's A fragment, columns 2j (a0, a2) and 2j + 1 (a1, a3) of the lane's 16,
  // which are bytes p and p + 1 of word j / 2 of each load, p = 2 (j % 2); K-rows 8t ..
  // 8t + 3 (a0, a1: loads 0-3) and 8t + 4 .. 8t + 7 (a2, a3: loads 4-7). A byte permute
  // pairs two loads' bytes, a second one pairs the pairs.
  static __device__ __forceinline__ void gfrag(const uint4 (&w)[GLOADS], int j, uint32_t a[4]) {
    const int wd = j >> 1, p = 2 * (j & 1);
    const uint32_t sel = p | (p + 4) << 4 | (p + 1) << 8 | (p + 5) << 12;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t lo = __byte_perm(qmmv::word(w[4 * h], wd), qmmv::word(w[4 * h + 1], wd), sel);
      const uint32_t hi =
          __byte_perm(qmmv::word(w[4 * h + 2], wd), qmmv::word(w[4 * h + 3], wd), sel);
      a[2 * h] = __byte_perm(lo, hi, 0x5410);
      a[2 * h + 1] = __byte_perm(lo, hi, 0x7632);
      if (!SIGNED) {
        a[2 * h] ^= 0x80808080u;
        a[2 * h + 1] ^= 0x80808080u;
      }
    }
  }

  static __device__ __forceinline__ uint32_t frag(const uint8_t* tile, int u, int h, int t,
                                                  int c) {
    const uint8_t* p = tile + (32 * u + 16 * h + 4 * t) * a8::COLS + c;
    const uint32_t v = p[0] | (p[a8::COLS] << 8) | (p[2 * a8::COLS] << 16) |
                       (static_cast<uint32_t>(p[3 * a8::COLS]) << 24);
    return SIGNED ? v : v ^ 0x80808080u;
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

// The decode route (M <= 16) of lljt_qmm8_w8a8: one launch, out (M, N) the only buffer
// written (levels: null, or the rounding check's x̂, rsx and sums, see a8::GemvArgs).
// ksplit, steps, lw: the wrapper's a8_gemv_plan. group * n_act == K.
int lljt_qmm8_w8a8_gemv(const void* x, const void* qweight, const void* scales,
                        const void* zeros, void* out, void* levels, int M, int K, int N,
                        int group, int n_act, int rep, int ksplit, int steps, int lw,
                        int out_f32, int is_signed, void* stream) {
  if (group <= 0 || group * n_act != K) return static_cast<int>(cudaErrorInvalidValue);
  const a8::GemvArgs a{x, static_cast<const uint8_t*>(qweight), nullptr, K, 0,
                       static_cast<const float*>(scales), static_cast<const float*>(zeros),
                       is_signed ? 0.f : 128.f, out, levels, M, K, N, group, n_act, rep, ksplit,
                       steps, lw, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_signed ? a8::launch_gemv<Int8A8<true>>(a, st) : a8::launch_gemv<Int8A8<false>>(a, st);
}

}  // extern "C"
