// Tensor-core tiles of the per-weight v2 dequant-matmul kernels, for Hopper
// (sm_90a): the v2 format's policy for the shared prefill mainloop of
// qmatmul_mma.cuh and the decode mainloop of qmatmul_decode_mma.cuh. The
// same function as the CUDA-core template in qmatmul_v2_weight.cuh, for
// bf16 operands at M >= 9 rows (qmatmul.MMA_MIN_ROWS) and, for v2g, v2h
// and v2s, at their decode rows (qmatmul.DECODE_MMA_MIN_ROWS up to 8) on
// the decode tile:
//   y (M, d_out) f32 = bf16(x) @ w  [ - xsum @ off2 ]   (f32 sums)
// with w the build's bf16 weight from the same group_affine / weight
// functions (so bit for bit the decode kernel's, and the JAX bodies'), and
// xsum the f32 group sums of the un-rounded x.
//
// Replaces, at M >= 9 with bf16 operands: gptq_gguf_tpu/ops/qmatmul.py::
// _kernel_v2g :605 (the default variant), _kernel_v2 :377, _kernel_v3 :429,
// _kernel_v2f :496, _kernel_v2h :551 and _kernel_v2s :660. Instantiated by
// qmatmul_v2g.cu (v2g, v2s), qmatmul_v2.cu (v2, v2f) and qmatmul_v3.cu (v3,
// v2h). v2s builds v2g's weights and sums each step's high-nibble products
// apart before they meet the low-nibble ones (the mainloop's
// F::SPLIT_HALVES; JAX's x_lo @ w_lo + x_hi @ w_hi per K tile). The
// decode tile replaces _kernel_v2g :605, _kernel_v2h :551 and _kernel_v2s
// :660 at their decode rows (launch_decode_mma); v2h's weight,
// bf16(bf16(bf16(scale) * q) - bf16(off2)), comes from packed bf16
// arithmetic there (frags_v2h), bit for bit group_affine / weight_q's on
// the CUDA cores, and it has no xsum term (its offset is in the weight);
// v2s builds v2g's fragments (the same FMA) and the decode mainloop sums
// a warp's high-nibble slice of each step apart before it meets the
// accumulator (F::SPLIT_HALVES there too). The
// other builds' decode steps, f32 operands (TF32 would change the
// products) and weights the wrapper gives one column per thread (vec 1:
// d_out % 4 != 0 or planes not 16-byte aligned; no Llama-3-8B weight is
// one) stay on the CUDA-core kernel.
//
// Per 64-row step it stages the code bytes, the step's sc_q / mn_q rows and
// the supergroup's d_sg / dmin_sg row (issue). For the prefill tiles each
// thread builds 4 columns of 8 weight rows (one group's constants) into the
// bf16 k-major tile, and for v2g / v2s / v3 the step's off2 rows into the
// block's scratch for the xsum term (build); for the decode tile the step's
// f32 scale and off2 rows go to shared memory (rows) and each thread
// builds its A fragments from them in registers (frags).

#pragma once

#include "qmatmul_decode_mma.cuh"
#include "qmatmul_mma.cuh"
#include "qmatmul_v2_weight.cuh"

namespace {

// PITCH: bytes from one staged code row to the next (the decode tile pads
// them; qmatmul_decode_mma.cuh)
template <int BUILD, int PB_, int GS_, bool HAS_MIN, int PITCH = kMmaBN>
struct V2Mma {
  using Args = V2Args;
  static constexpr int PB = PB_;
  static constexpr int GS = GS_;
  static constexpr int GPK = kMmaKT / GS;  // groups per step
  static constexpr int GPSG = kQK / GS;    // groups per supergroup
  static constexpr int CODE_ROWS = kMmaKT / PB;
  static constexpr bool XSUM = corrects(BUILD);
  static constexpr bool GROUP_DOT = false;
  static constexpr bool GROUP_SUM = false;
  static constexpr bool SPLIT_HALVES = BUILD == kV2s;
  // plane offsets in a stage
  static constexpr int SC_OFF = CODE_ROWS * PITCH;
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
    stage_rows<kMmaBN, PITCH>(st + P, CODE_ROWS, cols_left, w16,
                              [&](int r) { return qsrc + r * ldo; });
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
        const uint32_t w = *reinterpret_cast<const uint32_t*>(st + P + r * PITCH + n);
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
        const uint32_t w = *reinterpret_cast<const uint32_t*>(st + P + r * PITCH + n);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = weight<BUILD, true, HAS_MIN>(f[c], (w >> (8 * c)) & 0xFFu);
        store_w4(ws, r, n, v);
      }
    }
    if constexpr (XSUM) rows<P, false, true>(a, st, nullptr, o2s);
  }

  // the step's f32 group rows [GPK][kMmaBN]: the scales into sc (SC) and
  // the offsets off2 into o2 (O2), as build forms them
  template <int P, bool SC = true, bool O2 = true>
  __device__ __forceinline__ static void rows(const Args& a, const char* st, float* sc, float* o2) {
    const float* dsg = reinterpret_cast<const float*>(st + (P + D_OFF));
    const float* dmn = reinterpret_cast<const float*>(st + (P + DMIN_OFF));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(st);
    for (int i = threadIdx.x; i < GPK * kMmaBN; i += kMmaThreads) {  // [lg][col]
      const int col = i % kMmaBN;
      if constexpr (SC) sc[i] = dsg[col] * scale_code<!HAS_MIN>(b[P + SC_OFF + i], 0);
      if constexpr (O2)
        o2[i] = HAS_MIN ? dmn[col] * static_cast<float>(b[P + MN_OFF + i])
                        : dsg[col] * scale_code<true>(b[P + SC_OFF + i], 0) * a.shift;
    }
  }

  // the decode tile's bf16 A fragments (decode_frags in
  // qmatmul_decode_mma.cuh) of K half kh from the staged codes; sc / o2
  // are the step's group rows (rows<P>), the weights those of group_affine
  // / weight as in build
  template <int P>
  __device__ __forceinline__ static void frags(const Args& a, const char* st, const float* sc,
                                               const float* o2, int c0, int kh, int t,
                                               uint32_t (&af)[2][2][4]) {
    if constexpr (BUILD == kV2h) {
      frags_v2h<P>(st, sc, o2, c0, kh, t, af);
      return;
    }
    Affine f[4];
    float nb[4];
    auto slice = [&](int, int sl) {
      const int lg = 16 * sl / GS;
      const float4 s4 = *reinterpret_cast<const float4*>(sc + lg * kMmaBN + c0);
      const float4 o4 = *reinterpret_cast<const float4*>(o2 + lg * kMmaBN + c0);
      f[0] = group_affine<BUILD, true, HAS_MIN>(s4.x, o4.x, a.shift);
      f[1] = group_affine<BUILD, true, HAS_MIN>(s4.y, o4.y, a.shift);
      f[2] = group_affine<BUILD, true, HAS_MIN>(s4.z, o4.z, a.shift);
      f[3] = group_affine<BUILD, true, HAS_MIN>(s4.w, o4.w, a.shift);
#pragma unroll
      for (int c = 0; c < 4; ++c) nb[c] = -f[c].s * 8388608.f;
      return 0u;
    };
    // v2g / v2s: s * q = fma(s, 2^23 + q, -s 2^23), exact (s * q has at
    // most 24 significant bits and the FMA rounds once), one operation
    auto wt = [&](int, int c, float mq) {
      if constexpr (BUILD == kV2g || BUILD == kV2s) return fmaf(f[c].s, mq, nb[c]);
      else return weight_q<BUILD, true, HAS_MIN>(f[c], mq - 8388608.f);
    };
    decode_frags<PB, PITCH>(st + P + c0, kh, t, slice, wt, af);
  }

  // v2h's A fragments in packed bf16 arithmetic: per pair of weights one
  // byte permute and one mask make bf16(128 + q) of two codes, one bf16x2
  // FMA s (128 + q) - 128 s gives bf16(s * q) (the exact s * q, one
  // rounding) and one bf16x2 subtraction bf16(bf16(s * q) - o): the
  // weights of group_affine / weight_q in f32 bit for bit, since the f32
  // subtraction of two bf16 values is exact where their exponents differ
  // by 16 or less and, where they differ by more, leaves the larger one's
  // bf16 rounding unchanged either way. s = bf16(scale), o = bf16(off2)
  template <int P>
  __device__ __forceinline__ static void frags_v2h(const char* st, const float* sc,
                                                   const float* o2, int c0, int kh, int t,
                                                   uint32_t (&af)[2][2][4]) {
    uint32_t s2[4], ns2[4], o2w[4];  // bf16x2 of s, -128 s and o
    auto slice = [&](int, int sl) {
      const int lg = 16 * sl / GS;
      const float4 s4 = *reinterpret_cast<const float4*>(sc + lg * kMmaBN + c0);
      const float4 o4 = *reinterpret_cast<const float4*>(o2 + lg * kMmaBN + c0);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, ov[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = bf16_round(sv[c]);
        s2[c] = bf16x2_bits(s, s);
        ns2[c] = bf16x2_bits(-128.f * s, -128.f * s);
        o2w[c] = bf16x2_bits(ov[c], ov[c]);
      }
      return 0u;
    };
    auto bf2 = [](const uint32_t& u) { return *reinterpret_cast<const __nv_bfloat162*>(&u); };
    auto pair = [&](int, int c, uint32_t ma, uint32_t mb) {
      const uint32_t m = (__byte_perm(ma, mb, c | (c + 4) << 8) & 0x00FF00FFu) | 0x43004300u;
      const __nv_bfloat162 w = __hsub2(__hfma2(bf2(s2[c]), bf2(m), bf2(ns2[c])), bf2(o2w[c]));
      return *reinterpret_cast<const uint32_t*>(&w);
    };
    decode_frags<PB, PITCH, true>(st + P + c0, kh, t, slice, pair, af);
  }
};

// the tensor-core tiles of one v2 build, bm rows per block (32, 64 or 128);
// false for another bm (declared in qmatmul_v2_weight.cuh)
template <int BUILD, int PB, int GS, bool HAS_MIN>
bool launch_mma(const V2Args& a, int bm) {
  return launch_mma_tiles<V2Mma<BUILD, PB, GS, HAS_MIN>>(a, bm);
}

// the tensor-core decode tile (qmatmul_decode_mma.cuh) of build v2g, v2h
// or v2s, M <= 8 rows (declared in qmatmul_v2_weight.cuh)
template <int BUILD, int PB, int GS, bool HAS_MIN>
bool launch_decode_mma(const V2Args& a) {
  launch_decode_mma_tile<V2Mma<BUILD, PB, GS, HAS_MIN, kDecodePitch>>(a);
  return true;
}

}  // namespace
