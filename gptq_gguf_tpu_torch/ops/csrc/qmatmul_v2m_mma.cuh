// Tensor-core prefill tiles of the group-dot v2 kernels v2m, v2t and v2p,
// for Hopper (sm_90a): their policies for the shared mainloop of
// qmatmul_mma.cuh; and the tensor-core decode tiles of v2p and v2t
// (GroupDotMma's frags, for the decode mainloop of qmatmul_decode_mma.cuh:
// bf16 operands from the variant's qmatmul.DECODE_MMA_MIN_ROWS to 8 rows
// on vec-4 weights; v2t in its group-sum form).
// The same function as the CUDA-core bodies of qmatmul_v2m.cu, for bf16
// operands at M >= 9 rows (every call past the decode tiles;
// qmatmul.MMA_MIN_ROWS) on vec-4 weights:
//   y (M, d_out) f32 = sum_g scale_g * (bf16(x_g) @ q_g)  -  xsum @ off2
// with q_g group g's raw unsigned codes (< 64, exact in bf16), scale_g and
// off2 as _folded_planes_v2 forms them in f32, and xsum the f32 group sums
// of the un-rounded x.
//
// Replaces, at those shapes: gptq_gguf_tpu/ops/qmatmul.py::_kernel_v2m :729
// (gs 32: Q4_K, Q5_K), _kernel_v2t :789 (gs 32, GroupSumMma) and
// _kernel_v2p :844 (gs 16: Q2_K, Q3_K, Q6_K, the lm_head among them). f32
// operands (TF32 would round x), vec-1 weights and M <= 8 (v2p, v2t:
// below their decode tile's rows; v2m: every such M) stay on the
// CUDA-core bodies.
//
// Per 64-row step it stages v2g's planes (V2Mma<kV2g>::issue: the code
// bytes, the step's sc_q / mn_q rows, the supergroup's d_sg / dmin_sg row);
// each thread turns 4 columns of 8 code rows into bf16 codes, with no scale
// (nibble codes in V2Mma's row map: a step holds two gs-32 groups, or two
// gs-16 pairs, of low nibbles and their high-nibble mirrors), and the block
// writes the step's f32 scale rows (d_sg * sc) and off2 rows into its
// scratch. The mainloop (F::GROUP_DOT) runs each group's products into a
// partial sum and adds partial * scale to the accumulator. v2p's JAX body
// adds a pair of gs-16 partials, s_e p_e + s_o p_o, before the accumulator;
// here each partial goes in by its own FMA: the same terms, another order
// of the f32 sums, as everywhere in these tiles. v2t's JAX body sums its
// scaled partials, sum(parts * scale), before the output: GroupSumMma
// (F::GROUP_SUM) sums a step's two groups' scaled partials first and adds
// that sum to the accumulator once.

#pragma once

#include "qmatmul_v2_mma.cuh"

namespace {

// PITCH: bytes from one staged code row to the next (kDecodePitch for the
// decode tile)
template <int PB_, int GS_, bool HAS_MIN, int PITCH = kMmaBN>
struct GroupDotMma : V2Mma<kV2g, PB_, GS_, HAS_MIN, PITCH> {  // v2g's planes, off2 and xsum term
  using V2 = V2Mma<kV2g, PB_, GS_, HAS_MIN, PITCH>;
  static constexpr bool GROUP_DOT = true;
  static constexpr int O2_BYTES = 2 * V2::GPK * kMmaBN * 4;  // off2, then scale: [GPK][kMmaBN] f32

  template <int P>
  __device__ __forceinline__ static const float* scales(const char*, const float* o2s) {
    return o2s + V2::GPK * kMmaBN;
  }

  // the step's raw codes into the bf16 tile, its off2 and scale rows into o2s
  template <int P>
  __device__ __forceinline__ static void build(const V2Args& a, const char* st, __nv_bfloat16* ws,
                                               float* o2s) {
    build_codes<PB_, PITCH>(st + P, ws);
    const float* dsg = reinterpret_cast<const float*>(st + (P + V2::D_OFF));
    const float* dmn = reinterpret_cast<const float*>(st + (P + V2::DMIN_OFF));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(st);
    for (int i = threadIdx.x; i < V2::GPK * kMmaBN; i += kMmaThreads) {  // [lg][col]
      const int col = i % kMmaBN;
      const float s = dsg[col] * scale_code<!HAS_MIN>(b[P + V2::SC_OFF + i], 0);
      o2s[i] = HAS_MIN ? dmn[col] * static_cast<float>(b[P + V2::MN_OFF + i]) : s * a.shift;
      o2s[V2::GPK * kMmaBN + i] = s;
    }
  }

  // the decode tile's bf16 A fragments (decode_frags in
  // qmatmul_decode_mma.cuh) of K half kh: the raw codes, exact in bf16 (the
  // step's scale and off2 rows, V2Mma::rows, are the mainloop's: F::GROUP_DOT)
  template <int P>
  __device__ __forceinline__ static void frags(const V2Args&, const char* st, const float*,
                                               const float*, int c0, int kh, int t,
                                               uint32_t (&af)[2][2][4]) {
    auto slice = [](int, int) { return 0u; };
    auto wt = [](int, int, float mq) { return mq - 8388608.f; };  // 2^23 + q - 2^23
    decode_frags<PB_, PITCH>(st + P + c0, kh, t, slice, wt, af);
  }
};

// v2t: v2m's planes and codes at gs 32, each step's scaled partials summed
// before the accumulator (in the decode tile, kDecodePitch: a warp's two
// slices of a step, GroupDotMma's frags and V2Mma<kV2g>'s rows)
template <int PB_, bool HAS_MIN, int PITCH = kMmaBN>
struct GroupSumMma : GroupDotMma<PB_, 32, HAS_MIN, PITCH> {
  static constexpr bool GROUP_SUM = true;
};

}  // namespace
