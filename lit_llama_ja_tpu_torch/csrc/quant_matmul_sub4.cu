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
//   Rows K..Kp-1 hold level 0, which dequantizes to -zero*scale: they contribute
//   nothing (the GEMV's fast route stops at K; its general route and the GEMM read x
//   as zero past K).
//
// Bound on an H100: decode by the weight bytes, 1/4 (int2) or 3/8 (int3) byte per
//   weight plus the grouped scales and zeros (the 7B step: int2 1.66 GB, 0.50 ms;
//   int3 2.49 GB, 0.74 ms at 3.35 TB/s); prefill by tensor-core flops. Decode (M <= 16)
//   runs the tensor-core GEMV of qmm_gemv.cuh through the decoders Int2Gemv and
//   Int3Gemv below; prefill the GEMM of qmm_generic.cuh through Int2Fmt and Int3Fmt.
#include "qmm_generic.cuh"
#include "qmm_gemv.cuh"

namespace {

// field f of each of the four bytes of a word, one level a byte
__device__ __forceinline__ uint32_t int2_fields(uint32_t word, int f) {
  return ((word >> (2 * f)) & 0x03030303u) ^ (f == 3 ? 0x02020202u : 0u);
}

// bf16x2 {128 + level of a's byte p, 128 + level of b's byte p} for words whose bytes
// hold a level in their low bits (mask: 0x00030003 for 2 bits, 0x00070007 for 3): a
// byte permute puts the two bytes under bf16 128.0 (0x4300), the lop3 masks them and
// sets the exponent; flip undoes field 3's (q - 2) & 3 in the high half.
__device__ __forceinline__ uint32_t level_pair(uint32_t a, uint32_t b, int p, uint32_t mask,
                                               bool flip) {
  return (__byte_perm(a, b, ((4 + p) << 8) | p) & mask) ^ (flip ? 0x43024300u : 0x43004300u);
}

// The GEMV's int2 decoder. Lane (g, t) loads packed row 4s + t of k16 step s (K-rows
// 16s + 4t .. 16s + 4t + 3, fields 0-3 of each byte), columns 16g..16g+15: one 16-byte
// load is the A fragments of the step's 8 mma. A level decodes without an I2F: the
// word's 2-, 4- and 6-bit shifts (once a word), then a byte permute and a lop3 a k-pair.
struct Int2Gemv {
  static constexpr int LOADS = 1;       // packed rows a lane loads per k16 step
  static constexpr int U = 4;           // k16 steps a batch of loads (the fast route)
  static constexpr int PARTS = 1;       // products a fragment
  static constexpr float ZOFF = 128.f;  // a level decodes to 128 + q
  static __device__ __forceinline__ int rows(int Kp, int) { return Kp >> 2; }
  static __device__ __forceinline__ int row(int s, int t, int) { return 4 * s + t; }
  static __host__ __device__ constexpr int plane(int) { return 0; }

  // mma j's A fragment: columns 16g + 2j (byte 2j of the load: a0, a2) and 16g + 2j + 1
  // (byte 2j + 1: a1, a3), K-rows 4t, 4t + 1 (fields 0, 1: a0, a1) and 4t + 2, 4t + 3
  // (fields 2, 3: a2, a3)
  static __device__ __forceinline__ void frag(const uint4 (&w)[LOADS], int j, int,
                                              uint32_t a[4]) {
    const uint32_t v = qmmv::word(w[0], j >> 1);
    const int p = 2 * (j & 1);
    a[0] = level_pair(v, v >> 2, p, 0x00030003u, false);
    a[1] = level_pair(v, v >> 2, p + 1, 0x00030003u, false);
    a[2] = level_pair(v >> 4, v >> 6, p, 0x00030003u, true);
    a[3] = level_pair(v >> 4, v >> 6, p + 1, 0x00030003u, true);
  }
};

// The GEMV's int3 decoder: Int2Gemv's load and the high-bit plane's row 2s + (t >> 1),
// whose bits 4(t & 1) .. 4(t & 1) + 3 of a column byte are the high bits of the lane's
// K-rows 16s + 4t .. 16s + 4t + 3 (lanes t = 0 and 1, and 2 and 3, load the same 16
// bytes, served by the same sectors). Each high bit is put at bit 2 of its field's
// byte (one lop3 a field and word) before the same permute and lop3 as int2.
struct Int3Gemv {
  static constexpr int LOADS = 2;  // the int2 plane's row, the high-bit plane's row
  static constexpr int U = 4;
  static constexpr int PARTS = 1;
  static constexpr float ZOFF = 128.f;
  static __device__ __forceinline__ int rows(int Kp, int i) { return i ? Kp >> 3 : Kp >> 2; }
  static __device__ __forceinline__ int row(int s, int t, int i) {
    return i ? 2 * s + (t >> 1) : 4 * s + t;
  }
  static __host__ __device__ constexpr int plane(int i) { return i; }

  static __device__ __forceinline__ void frag(const uint4 (&w)[LOADS], int j, int,
                                              uint32_t a[4]) {
    constexpr uint32_t LO = 0x03030303u;  // the int2 field of each byte; bit 2: the high bit
    const uint32_t v = qmmv::word(w[0], j >> 1);
    const uint32_t h = qmmv::word(w[1], j >> 1) >> ((threadIdx.x & 1) << 2);
    const uint32_t c0 = (v & LO) | ((h << 2) & ~LO);
    const uint32_t c1 = ((v >> 2) & LO) | ((h << 1) & ~LO);
    const uint32_t c2 = ((v >> 4) & LO) | (h & ~LO);
    const uint32_t c3 = ((v >> 6) & LO) | ((h >> 1) & ~LO);
    const int p = 2 * (j & 1);
    a[0] = level_pair(c0, c1, p, 0x00070007u, false);
    a[1] = level_pair(c0, c1, p + 1, 0x00070007u, false);
    a[2] = level_pair(c2, c3, p, 0x00070007u, true);
    a[3] = level_pair(c2, c3, p + 1, 0x00070007u, true);
  }
};

// The GEMM's decoders: K-row r of a k-tile in shared memory, columns c..c+7; the fields
// of four columns are cut from a word at once.
struct Int2Fmt {
  static constexpr int RPB0 = 4, RPB1 = 0;  // four K-rows per packed row; no second plane

  template <int BN>
  static __device__ __forceinline__ void tile_levels(const uint8_t* w, int r, int c, float q[8]) {
    const uint2 b = *reinterpret_cast<const uint2*>(w + (r >> 2) * BN + c);
    qmm::byte_levels(make_uint2(int2_fields(b.x, r & 3), int2_fields(b.y, r & 3)), 8388608.f, q);
  }
};

// The int2 plane's BK / 4 rows of a k-tile, then the high-bit plane's BK / 8.
struct Int3Fmt {
  static constexpr int RPB0 = 4, RPB1 = 8;  // int2 plane: 4 K-rows a row; high bits: 8

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

// x (M, K) bf16 (M <= 16); qweight (Kp/4, N) u8; qweight_hi (Kp/8, N) u8 for bits 3
// (ignored for bits 2); scales/zeros (G, N) f32 -> out (M, N) bf16. ksplit, steps, fast,
// lw, xw, sw: the wrapper's GEMV plan.
int lljt_qmm_sub4_gemv(const void* x, const void* qweight, const void* qweight_hi,
                       const void* scales, const void* zeros, void* out, int M, int K, int Kp,
                       int N, int G, int bits, int ksplit, int steps, int fast, int lw, int xw,
                       int sw, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (bits == 2)
    err = qmmv::launch<Int2Gemv>(x, qweight, nullptr, scales, zeros, out, M, K, Kp, N, G,
                                 ksplit, steps, fast, lw, xw, sw, stream);
  else if (bits == 3 && qweight_hi != nullptr)
    err = qmmv::launch<Int3Gemv>(x, qweight, qweight_hi, scales, zeros, out, M, K, Kp, N, G,
                                 ksplit, steps, fast, lw, xw, sw, stream);
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
