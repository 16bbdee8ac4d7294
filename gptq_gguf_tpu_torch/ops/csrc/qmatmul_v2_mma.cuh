// Tensor-core prefill tiles of the per-weight v2 dequant-matmul kernels, for
// Hopper (sm_90a): the v2 format's policy for the shared mainloop of
// qmatmul_mma.cuh. The same function as the CUDA-core template in
// qmatmul_v2_weight.cuh, for bf16 operands at M >= 9 rows (every call past
// the decode tiles; qmatmul.MMA_MIN_ROWS):
//   y (M, d_out) f32 = bf16(x) @ w  [ - xsum @ off2 ]   (f32 sums)
// with w the build's bf16 weight from the same group_affine / weight
// functions (so bit for bit the decode kernel's, and the JAX bodies'), and
// xsum the f32 group sums of the un-rounded x.
//
// Replaces, at M >= 9 with bf16 operands: gptq_gguf_tpu/ops/qmatmul.py::
// _kernel_v2g :605 (the default variant), _kernel_v2 :377, _kernel_v3 :429,
// _kernel_v2f :496 and _kernel_v2h :551. Instantiated by qmatmul_v2g.cu
// (v2g), qmatmul_v2.cu (v2, v2f) and qmatmul_v3.cu (v3, v2h). v2s (its
// nibble halves summed apart), f32 operands (TF32 would change the
// products), M <= 8 (the decode tiles) and weights the wrapper gives one
// column per thread (vec 1: d_out % 4 != 0 or planes not 16-byte aligned;
// no Llama-3-8B weight is one) stay on the CUDA-core kernel.
//
// Per 64-row step it stages the code bytes, the step's sc_q / mn_q rows and
// the supergroup's d_sg / dmin_sg row; each thread builds 4 columns of 8
// weight rows (one group's constants), and for v2g / v3 the step's off2
// rows into the block's scratch for the xsum term.

#pragma once

#include "qmatmul_mma.cuh"
#include "qmatmul_v2_weight.cuh"

namespace {

template <int BUILD, int PB_, int GS_, bool HAS_MIN>
struct V2Mma {
  using Args = V2Args;
  static constexpr int PB = PB_;
  static constexpr int GS = GS_;
  static constexpr int GPK = kMmaKT / GS;  // groups per step
  static constexpr int GPSG = kQK / GS;    // groups per supergroup
  static constexpr int CODE_ROWS = kMmaKT / PB;
  static constexpr bool XSUM = corrects(BUILD);
  // plane offsets in a stage
  static constexpr int SC_OFF = CODE_ROWS * kMmaBN;
  static constexpr int MN_OFF = SC_OFF + GPK * kMmaBN;
  static constexpr int D_OFF = MN_OFF + GPK * kMmaBN;
  static constexpr int DMIN_OFF = D_OFF + kMmaBN * 4;
  static constexpr int PLANE_BYTES = DMIN_OFF + kMmaBN * 4;
  static constexpr int O2_BYTES = GPK * kMmaBN * 4;  // off2 [GPK][kMmaBN] f32

  __device__ __forceinline__ static bool has_off(const Args&) { return true; }

  template <int P>
  __device__ __forceinline__ static const float* offsets(const char*, const float* o2s) {
    return o2s;
  }

  // the step's planes into the stage st (from its byte P)
  template <int P>
  __device__ __forceinline__ static void issue(const Args& a, char* st, int sg, int q, int n0,
                                               int cols_left, bool w16) {
    const size_t ldo = static_cast<size_t>(a.d_out);
    const uint8_t* qsrc = a.qs + (static_cast<size_t>(sg) * (kQK / PB) + CODE_ROWS * q) * ldo + n0;
    stage_rows(st + P, CODE_ROWS, cols_left, w16, [&](int r) { return qsrc + r * ldo; });
    auto group_row = [&](const uint8_t* plane) {
      return [=](int lg) {
        const int g = sg * GPSG + k_in_sg<PB>(lg * GS, q) / GS;
        return plane + static_cast<size_t>(g) * ldo + n0;
      };
    };
    stage_rows(st + (P + SC_OFF), GPK, cols_left, w16, group_row(a.sc_q));
    if (HAS_MIN) stage_rows(st + (P + MN_OFF), GPK, cols_left, w16, group_row(a.mn_q));
    for (int i = threadIdx.x; i < (HAS_MIN ? 64 : 32); i += kMmaThreads) {
      const int j = i % 32;
      const float* plane = i < 32 ? a.d_sg : a.dmin_sg;
      const float* src = plane + static_cast<size_t>(sg) * a.d_rep * ldo + n0;
      const bool in = 4 * j < cols_left;
      cp_async16(st + (i < 32 ? P + D_OFF : P + DMIN_OFF) + 16 * j, in ? src + 4 * j : src, in);
    }
  }

  // the step's weights into the bf16 tile and (v2g, v3) its off2 rows
  template <int P>
  __device__ __forceinline__ static void build(const Args& a, const char* st, __nv_bfloat16* ws,
                                               float* o2s) {
    const float* dsg = reinterpret_cast<const float*>(st + (P + D_OFF));
    const float* dmn = reinterpret_cast<const float*>(st + (P + DMIN_OFF));
    const int n = 4 * (threadIdx.x % 32);  // 4 columns per thread
    const int slice = threadIdx.x / 32;     // 8 row slices
    float d[4], dmin[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[c] = dsg[n + c];
      dmin[c] = HAS_MIN ? dmn[n + c] : 0.f;
    }
    auto affine = [&](int lg, Affine (&f)[4]) {
      const uint32_t scw = *reinterpret_cast<const uint32_t*>(st + (P + SC_OFF) + lg * kMmaBN + n);
      const uint32_t mnw =
          HAS_MIN ? *reinterpret_cast<const uint32_t*>(st + (P + MN_OFF) + lg * kMmaBN + n) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = d[c] * scale_code<!HAS_MIN>(scw, c);
        const float o2 = HAS_MIN ? dmin[c] * static_cast<float>((mnw >> (8 * c)) & 0xFFu)
                                 : s * a.shift;
        f[c] = group_affine<BUILD, true, HAS_MIN>(s, o2, a.shift);
      }
    };
    if constexpr (PB == 2) {  // 32 code rows: 4 per slice, one group each half
      Affine f_lo[4], f_hi[4];
      affine(4 * slice / GS, f_lo);
      affine((32 + 4 * slice) / GS, f_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * slice + i;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(st + P + r * kMmaBN + n);
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = weight<BUILD, true, HAS_MIN>(f_lo[c], (w >> (8 * c)) & 0xFu);
          hi[c] = weight<BUILD, true, HAS_MIN>(f_hi[c], (w >> (8 * c + 4)) & 0xFu);
        }
        store_w4(ws, r, n, lo);
        store_w4(ws, 32 + r, n, hi);
      }
    } else {  // 64 code rows: 8 per slice, one group
      Affine f[4];
      affine(8 * slice / GS, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * slice + i;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(st + P + r * kMmaBN + n);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = weight<BUILD, true, HAS_MIN>(f[c], (w >> (8 * c)) & 0xFFu);
        store_w4(ws, r, n, v);
      }
    }
    if constexpr (XSUM) {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(st);
      for (int i = threadIdx.x; i < GPK * kMmaBN; i += kMmaThreads) {  // [lg][col]
        const int col = i % kMmaBN;
        o2s[i] = HAS_MIN ? dmn[col] * static_cast<float>(b[P + MN_OFF + i])
                         : dsg[col] * scale_code<true>(b[P + SC_OFF + i], 0) * a.shift;
      }
    }
  }
};

// the tensor-core tiles of one v2 build, bm rows per block (32, 64 or 128);
// false for another bm (declared in qmatmul_v2_weight.cuh)
template <int BUILD, int PB, int GS, bool HAS_MIN>
bool launch_mma(const V2Args& a, int bm) {
  return launch_mma_tiles<V2Mma<BUILD, PB, GS, HAS_MIN>>(a, bm);
}

}  // namespace
