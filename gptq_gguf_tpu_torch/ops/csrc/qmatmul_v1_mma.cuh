// Tensor-core tiles of the v1 dequant-matmul kernel, for Hopper (sm_90a):
// the v1 format's policy for the shared prefill mainloop of qmatmul_mma.cuh
// and for the decode mainloop of qmatmul_decode_mma.cuh, included by
// qmatmul_v1.cu.
//
// Replaces, with a bf16 x on vec-4 weights, at M >= 9 rows
// (qmatmul.MMA_MIN_ROWS; the prefill tiles, V1Mma<PB, GS>) and from
// qmatmul.DECODE_MMA_MIN_ROWS["v1"] to 8 rows (the decode tile,
// V1Mma<PB, GS, kDecodePitch>): gptq_gguf_tpu/ops/qmatmul.py::_kernel
// :157, the f32 kernel
//   y (M, d_out) f32 = f32(x) @ (q * scale_t - offset_t)
// (every projection and the lm_head of a v1 forward; serving passes a
// bf16 x). It computes the same function as a group dot, without
// dequantizing:
//   y = sum_g scale_t[g] * (x_g @ q_g)  -  xsum @ offset_t
// with q_g group g's raw unsigned codes (< 64) and xsum the f32 group sums
// of x. A bf16 x and the codes are exact in bf16, so every mma.sync
// product is exact and its sums are f32; scale_t multiplies each group's
// f32 partial (the prefill tiles: a group's partial; the decode tile: each
// k16 slice's, F::GROUP_DOT there) and offset_t rides the xsum term (Q3_K
// and Q6_K carry their signed shift inside offset_t, so they need nothing
// else). The result differs from the JAX kernel's only in the order and
// the grouping of the f32 sums (the JAX kernel rounds each weight q * s -
// o once; here s * (x . q) and xsum * o are rounded apart). A bf16 weight
// would round the function, and an f32 x would have to be rounded to bf16
// (the decode mainloop's stage_x rounds one): an f32 x, M below the decode
// tile's rows and vec-1 weights stay on v1_kernel (the wrapper's route,
// qmatmul.dequant_matmul_v1; the entry point refuses an f32 x on either
// tile).
//
// What bounds it: operations from M ~ 300 up (bf16 tensor cores: one
// Llama-3-8B forward at M = 1024 is 1.54e13 flop, 15.5 ms at 989 TFLOP/s),
// bytes below (f32 planes: Q4_K 0.75 bytes a weight, Q6_K 1.5; one B=8
// decode step reads 6,084,337,664 B, 1.816 ms at 3.35 TB/s). The CUDA-core
// tile it replaces at these shapes ran every weight through M f32 FMAs at
// ~30 TFLOP/s (67 at most), and at decode kept one 32-bit load per thread
// in flight per weight row.
//
// Per 64-row step (the mainloops' quarter supergroup) it stages the code
// bytes (32 rows of nibble pairs or 64 byte rows, PITCH bytes apart) and
// the step's GPK rows of scale_t and of offset_t (f32, 16-byte cp.async
// copies: vec 4 means d_out % 4 == 0 and 16-byte-aligned planes). For the
// prefill tiles each thread turns 4 columns of 8 code rows into bf16 codes
// in the weight tile (no scale), and the mainloop (F::GROUP_DOT) reads the
// scale and offset rows where they were staged. For the decode tile rows
// copies the step's scale_t rows into the mainloop's group-row buffer (its
// GROUP_DOT branch reads them there, one step ahead), frags builds the raw
// codes straight into the A fragments as GroupDotMma's do, and the offset
// rows are read where they were staged (offsets). v1's nibble order is
// v2's (byte k of a supergroup holds row k in its low nibble and row k +
// 128 in its high one), so the mainloops' row maps k_in_sg and
// decode_slice fit it as they are. A Q6_K decode stage is 14,592 B (64 code
// rows at the pitch, 4 f32 rows each of scale_t and offset_t, x and its
// group sums): a ring of 3 stages, as v4's Q6_K.

#pragma once

#include "qmatmul_decode_mma.cuh"
#include "qmatmul_mma.cuh"

namespace {

// The arguments of one v1 launch (v1_kernel's and the tiles').
struct V1Args {
  const void* x;
  int x_bf16;
  const uint8_t* qs;
  const float* scale_t;
  const float* offset_t;
  float* dst;
  int M, d_in, d_out, sg_per_split, splits;
  cudaStream_t stream;
};

// PITCH: bytes from one staged code row to the next (kDecodePitch for the
// decode tile)
template <int PB_, int GS_, int PITCH = kMmaBN>
struct V1Mma {
  using Args = V1Args;
  static constexpr int PB = PB_;
  static constexpr int GS = GS_;
  static constexpr int GPK = kMmaKT / GS;  // groups per step
  static constexpr int GPSG = kQK / GS;    // groups per supergroup
  static constexpr int CODE_ROWS = kMmaKT / PB;
  // plane offsets in a stage: codes, scale_t [GPK][kMmaBN] f32, offset_t alike
  static constexpr int SC_OFF = CODE_ROWS * PITCH;
  static constexpr int OFF_OFF = SC_OFF + GPK * kMmaBN * 4;
  static constexpr int PLANE_BYTES = OFF_OFF + GPK * kMmaBN * 4;
  static constexpr int O2_BYTES = 0;  // the group rows are read where they were staged
  static constexpr bool XSUM = true;
  static constexpr bool GROUP_DOT = true;
  static constexpr bool GROUP_SUM = false;
  static constexpr bool SPLIT_HALVES = false;

  __device__ __forceinline__ static bool has_off(const Args&) { return true; }

  template <int P>
  __device__ __forceinline__ static const float* scales(const char* st, const float*) {
    return reinterpret_cast<const float*>(st + (P + SC_OFF));
  }

  template <int P>
  __device__ __forceinline__ static const float* offsets(const char* st, const float*) {
    return reinterpret_cast<const float*>(st + (P + OFF_OFF));
  }

  // the step's planes into the stage st (from its byte P)
  template <int P>
  __device__ __forceinline__ static void issue(const Args& a, char* st, int sg, int q, int n0,
                                               int cols_left, bool w16) {
    char* p = st + P;
    const size_t ldo = static_cast<size_t>(a.d_out);
    const uint8_t* qsrc = a.qs + (static_cast<size_t>(sg) * (kQK / PB) + CODE_ROWS * q) * ldo + n0;
    stage_rows<kMmaBN, PITCH>(p, CODE_ROWS, cols_left, w16, [&](int r) { return qsrc + r * ldo; });
    // row lg of an f32 per-group plane: the group of the step's rows lg * GS..
    auto group_row = [&](const float* plane) {
      return [=](int lg) {
        const size_t g = sg * GPSG + k_in_sg<PB>(lg * GS, q) / GS;
        return reinterpret_cast<const uint8_t*>(plane + g * ldo + n0);
      };
    };
    // f32 rows start 16-byte aligned (d_out % 4 == 0)
    stage_rows<4 * kMmaBN>(p + SC_OFF, GPK, 4 * cols_left, true, group_row(a.scale_t));
    stage_rows<4 * kMmaBN>(p + OFF_OFF, GPK, 4 * cols_left, true, group_row(a.offset_t));
  }

  // the step's raw codes into the bf16 tile
  template <int P>
  __device__ __forceinline__ static void build(const Args&, const char* st, __nv_bfloat16* ws,
                                               float*) {
    build_codes<PB, PITCH>(st + P, ws);
  }

  // the decode tile's f32 group rows of the step: its staged scale_t rows
  // [GPK][kMmaBN] into sc, where the decode mainloop's group dot reads a
  // slice's scale (the offset_t rows stay where they were staged: offsets)
  template <int P>
  __device__ __forceinline__ static void rows(const Args&, const char* st, float* sc, float*) {
    const float4* src = reinterpret_cast<const float4*>(st + (P + SC_OFF));
    for (int i = threadIdx.x; i < GPK * kMmaBN / 4; i += kMmaThreads)
      reinterpret_cast<float4*>(sc)[i] = src[i];
  }

  // the decode tile's bf16 A fragments (decode_frags in
  // qmatmul_decode_mma.cuh) of K half kh: the raw codes, exact in bf16
  template <int P>
  __device__ __forceinline__ static void frags(const Args&, const char* st, const float*,
                                               const float*, int c0, int kh, int t,
                                               uint32_t (&af)[2][2][4]) {
    auto slice = [](int, int) { return 0u; };
    auto wt = [](int, int, float mq) { return mq - 8388608.f; };  // 2^23 + q - 2^23
    decode_frags<PB, PITCH>(st + P + c0, kh, t, slice, wt, af);
  }
};

}  // namespace
