// Tensor-core prefill tiles of the v1 dequant-matmul kernel, for Hopper
// (sm_90a): the v1 format's policy for the shared mainloop of
// qmatmul_mma.cuh, included by qmatmul_v1.cu.
//
// Replaces, at M >= 9 rows (qmatmul.MMA_MIN_ROWS) with a bf16 x on vec-4
// weights: gptq_gguf_tpu/ops/qmatmul.py::_kernel :157, the f32 kernel
//   y (M, d_out) f32 = f32(x) @ (q * scale_t - offset_t)
// (every projection and the lm_head of a v1 forward; serving's prefill
// projections pass a bf16 x). It computes the same function as a group
// dot, without dequantizing:
//   y = sum_g scale_t[g] * (x_g @ q_g)  -  xsum @ offset_t
// with q_g group g's raw unsigned codes (< 64) and xsum the f32 group sums
// of x. A bf16 x and the codes are exact in bf16, so every mma.sync
// product is exact and its sums are f32; scale_t multiplies each group's
// f32 partial and offset_t rides the xsum term (Q3_K and Q6_K carry their
// signed shift inside offset_t, so they need nothing else). The result
// differs from the JAX kernel's only in the order and the grouping of the
// f32 sums (the JAX kernel rounds each weight q * s - o once; here
// s * (x . q) and xsum * o are rounded apart). A bf16 weight would round
// the function, and an f32 x would have to be rounded to bf16: an f32 x,
// M <= 8 and vec-1 weights stay on v1_kernel (the wrapper's route,
// qmatmul.dequant_matmul_v1; the entry point refuses an f32 x here).
//
// What bounds it: operations from M ~ 300 up (bf16 tensor cores: one
// Llama-3-8B forward at M = 1024 is 1.54e13 flop, 15.5 ms at 989 TFLOP/s),
// bytes below (f32 planes: Q4_K 0.75 bytes a weight, Q6_K 1.5). The
// CUDA-core tile it replaces at these shapes ran every weight through M
// f32 FMAs at ~30 TFLOP/s (67 at most).
//
// Per 64-row step (the mainloop's quarter supergroup) it stages the code
// bytes (32 rows of nibble pairs or 64 byte rows) and the step's GPK rows
// of scale_t and of offset_t (f32, 16-byte cp.async copies: vec 4 means
// d_out % 4 == 0 and 16-byte-aligned planes); each thread turns 4 columns
// of 8 code rows into bf16 codes in the weight tile (no scale), and the
// mainloop (F::GROUP_DOT) reads the scale and offset rows where they were
// staged. v1's nibble order is v2's (byte k of a supergroup holds row k
// in its low nibble and row k + 128 in its high one), so the mainloop's
// row map k_in_sg fits it as it is.

#pragma once

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

template <int PB_, int GS_>
struct V1Mma {
  using Args = V1Args;
  static constexpr int PB = PB_;
  static constexpr int GS = GS_;
  static constexpr int GPK = kMmaKT / GS;  // groups per step
  static constexpr int GPSG = kQK / GS;    // groups per supergroup
  static constexpr int CODE_ROWS = kMmaKT / PB;
  // plane offsets in a stage: codes, scale_t [GPK][kMmaBN] f32, offset_t alike
  static constexpr int SC_OFF = CODE_ROWS * kMmaBN;
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
    stage_rows(p, CODE_ROWS, cols_left, w16, [&](int r) { return qsrc + r * ldo; });
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
    build_codes<PB>(st + P, ws);
  }
};

}  // namespace
