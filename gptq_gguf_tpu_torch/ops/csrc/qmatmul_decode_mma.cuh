// Tensor-core decode mainloop of the dequant-matmul kernels, for Hopper
// (sm_90a): decode_mma_kernel<F>, 1 to 8 rows of x, generic over a format
// policy F of the prefill mainloop of qmatmul_mma.cuh (Args, PB, GS,
// PLANE_BYTES, XSUM, has_off, issue<P>, offsets<P>) that also provides
// rows<P> (a step's f32 group rows) and frags<P> (A fragments in
// registers, from the same weight helpers as its build<P>, laid out by
// decode_frags below). Instantiated with:
//   V2Mma<kV2g, PB, GS, HAS_MIN, kDecodePitch> (qmatmul_v2_mma.cuh, built
//       by qmatmul_v2g.cu) for Q4_K, Q2_K, Q3_K, Q5_K and Q6_K weights, bf16
//       operands; V2Mma<kV2s, ...> (the same files) for the 4-bit three
//       (Q4_K, Q2_K, Q3_K): v2g's weights in the split-halves form
//       (F::SPLIT_HALVES) below; V2Mma<kV2h, ...> and V2Mma<kV3, ...>
//       (built by qmatmul_v3.cu) for the five: v2h's weights, no xsum
//       term, and v3's, with it; and V2Mma<kV2, ...> and V2Mma<kV2f, ...>
//       (built by qmatmul_v2.cu) for the five: v2's weights, no xsum
//       term, which are v2f's too;
//   V4Mma<PB, GS, I8, kDecodePitch> (qmatmul_v4.cu): the v4 bodies pb2,
//       pb2_i8 and pb1, f32 or bf16 scales, f32 or bf16 x;
//   V1Mma<PB, GS, kDecodePitch> (qmatmul_v1_mma.cuh, built by
//       qmatmul_v1.cu): v1 with a bf16 x, in the group-dot form
//       (F::GROUP_DOT) below, v1's f32 scale_t rows copied into the group
//       rows and its offset_t rows read where they were staged;
//   GroupDotMma<PB, GS, HAS_MIN, kDecodePitch> (qmatmul_v2m_mma.cuh, built
//       by qmatmul_v2m.cu): v2m (gs 32: Q4_K, Q5_K) and v2p (gs 16: Q2_K,
//       Q3_K, Q6_K, the lm_head under v2m), bf16 operands, in the
//       group-dot form (F::GROUP_DOT) below;
//   GroupSumMma<PB, HAS_MIN, kDecodePitch> (the same files): v2t (gs 32:
//       Q4_K, Q5_K), bf16 operands, in the group-sum form (F::GROUP_SUM).
//
// Replaces (it takes every M of 1-8), from each variant's row threshold
// (qmatmul.DECODE_MMA_MIN_ROWS[variant]) up to qmatmul.MMA_MIN_ROWS - 1:
// gptq_gguf_tpu/ops/qmatmul.py::_kernel_v2g :605 (bf16 operands), the
// default variant, which carries every projection and the lm_head of a
// decode step (129 calls per Llama-3-8B step at B = 8), _kernel_v2h :551,
// _kernel_v3 :429, _kernel_v2 :377 and _kernel_v2f :496 (the 129 calls of
// each under its GG_PALLAS_V2_VARIANT), _kernel_v2t :789 and
// _kernel_v2s :660 (their 128 projections; the head runs v2g), _kernel_v2m
// :729 (its 128 projections) and _kernel_v2p :844 (the head under v2m);
// at M = 1-8
// (qmatmul.DECODE_MMA_MIN_ROWS["v4"] up): gptq_gguf_tpu/ops/qmv4.py::_kernel_v4_pb2
// :264, _kernel_v4_pb2_i8 :305 and _kernel_v4_pb1 :346 (128 Q4_K calls and
// the Q6_K head of a v4 step); with a bf16 x at M = 1-8
// (qmatmul.DECODE_MMA_MIN_ROWS["v1"] up): gptq_gguf_tpu/ops/qmatmul.py::
// _kernel :157 (the 129 calls of a v1 step):
//   y (M, d_out) f32 = bf16(x) @ w - xsum @ off   (f32 sums)
// with w the format's bf16 weight from the same helpers as its CUDA-core
// decode tiles and its prefill tiles, so bit for bit theirs and the JAX
// bodies'; only the order of the f32 sums differs.
//
// What bounds it: bytes. One Llama-3-8B B=8 step reads 4,773,330,944 B in
// v2 (planes, x, y; 1.425 ms at 3.35 TB/s) and 6,084,337,664 B in v4 with
// f32 scales (1.816 ms), against 1.2e11 flop, which the tensor cores take
// in 0.12 ms. The CUDA-core tiles it replaces ran every weight through M
// f32 FMAs beside its dequantization (9.09 ms per step in v2, 10.55 in v4:
// issue- and latency-bound, 16% of the memory rate) and kept one 32-bit
// load per thread in flight per weight row.
//
// Design:
//   * roles swapped on mma.sync.m16n8k16 (bf16 -> f32): the weight is A
//     (16 output columns x 16 k), x is B (its <= 8 rows fill n8 exactly;
//     k contiguous, by ldmatrix.x4); rows past M are zero-filled and not
//     stored, columns past d_out are not stored;
//   * a block is 8 warps on 128 columns (the prefill loop's 64-row steps,
//     a quarter supergroup, and its staged planes: F::issue, stage_x); warp
//     w owns 32 columns (w % 4) and half the step's code rows (w / 4); the
//     two halves' sums meet once, at the end, in a fixed order;
//   * the A fragments are built in registers straight from the staged codes
//     (F::frags), no weight tile and no second barrier: a thread's 4
//     columns are rows g, g + 8 of two m16 tiles, its k slots 2t, 2t + 1,
//     2t + 8, 2t + 9 four code rows, so one 32-bit shared load gives a row's
//     4 columns (with 4-bit codes, the low nibbles for one slice and the
//     high ones for another); a byte permute makes each code a float
//     (byte_magic), one FMA with the group scale and one packed
//     conversion per two weights make the bf16 pair (decode_frags lays the
//     fragments out; the policy gives each weight; v2h's and v3's weights
//     are bf16 arithmetic, so their policy forms each pair in packed bf16
//     operations, and v2's forms each weight from 128 + q (byte_128):
//     decode_frags' PAIRS). Staged code rows are
//     padded by 16 bytes (kDecodePitch), so the four k-slot lanes load from
//     distinct banks;
//   * a step's f32 group rows ([GPK][128], F::rows: v2's scale and off2
//     rows from its byte codes, v4's scales rounded to bf16) and its x
//     group sums are made one step ahead, into one of two buffers, so one
//     barrier per step orders everything; v4's f32 offc rows are read
//     where they were staged (F::offsets);
//   * bytes in flight: a cp.async ring of up to kDecodeStages stages
//     (16-byte .cg copies of the codes, the step's sc_q / mn_q rows, the
//     supergroup's d_sg / dmin_sg row and x; v4: the codes, the step's
//     scale and offc rows and x); four blocks per SM (64 registers a
//     thread; shared memory caps the ring at 6 stages for v2's Q4_K
//     (7,360 B a stage, 4,608 of them device-memory planes), 5 for Q2_K /
//     Q3_K, 4 for Q5_K, 3 for Q6_K; for v4, 6 for Q4_K (7,872 B), 4 for
//     Q2_K / Q3_K (9,984 B), 3 for Q5_K (12,480 B) and Q6_K (14,592 B)).
//     Q4_K keeps up to 4 steps =
//     18 KB of planes in flight per block, 74 KB per SM, over the ~30 KB
//     that 3.35 TB/s at ~1 us of latency needs (Little's law);
//   * split-K: the wrapper splits the supergroups so that the grid holds
//     at most qmatmul.DECODE_MMA_BLOCKS_PER_SM blocks per SM
//     (qmatmul._decode_mma_plan); a split's partials go to the scratch
//     buffer and reduce_splits_kernel adds them in a fixed order
//     (finish_launch): no float atomics, two calls bit-equal;
//   * xsum @ off is subtracted in f32 on the CUDA cores from the C
//     fragments after each step's products (the first K half's warps, GPK
//     FMAs per fragment value): a thread's C fragment holds its columns
//     c0 + 2i, c0 + 2i + 1 and x rows 2t, 2t + 1;
//   * an f32 x with bf16 operands is rounded as it is staged and its group
//     sums are taken on the way (stage_x); a bf16 x's from the staged tile
//     (sum_x);
//   * group dot (F::GROUP_DOT; v2p and v1 at gs 16): F::frags builds the
//     raw codes (exact in bf16) and F::rows the step's f32 scale (and, for
//     v2p, off2) rows; each
//     k16 slice of the warp's K half (at gs 16 one group) runs into a fresh
//     C fragment, which one FMA per fragment value adds to the accumulator
//     times the slice's group scale of that column: y = sum_g scale_g
//     (bf16(x_g) @ q_g) - xsum @ off2, the JAX body's terms (_kernel_v2p
//     :844; v1's _kernel :157 with scale_t and offset_t, its weight q *
//     scale_t - offset_t split in two) in another order of the f32 sums;
//   * group sum (F::GROUP_SUM, a group dot; v2t, gs 32): the warp's two
//     scaled slice partials of a step go into a step sum, s = p0 s0 +
//     p1 s1, which is added to the accumulator once: JAX's sum(parts *
//     scale) before the output (_kernel_v2t :830) within the warp's K
//     half, the two halves meeting at the end. At gs 32 decode_slice puts
//     a warp's low-nibble slice in the step's group 0 and its high-nibble
//     slice in group 1 (4-bit codes), or both byte-code slices in group
//     kh. v2m and v1 (gs 32) take the plain group-dot form on the same map: each
//     slice's partial into the accumulator by its own FMAs, JAX's
//     sum_g scale_g p_g (_kernel_v2m :729) with each group's dot in two
//     halves;
//   * split halves (F::SPLIT_HALVES; v2s, 4-bit codes): a warp's slice 0 of
//     a step (the low nibbles) goes straight into the accumulator and its
//     slice 1 (the high nibbles, 128 rows up) into a fresh C fragment,
//     added once after the step's products: JAX's x_lo @ w_lo + x_hi @
//     w_hi (_kernel_v2s :660) per step and K half, one zero-C mma.sync
//     pair and 8 adds a warp and step more than v2g.
//     Each branch is compiled only for such a policy, so the other
//     instances keep their code.
// ptxas (sm_90a, -O3): 64 registers in every v2g instance, no spills but 4
// bytes of spill stores and 4 of loads in the Q3_K one; v2p's: 64
// registers, 4 bytes of spill stores and 4 of loads at Q6_K, none at Q2_K
// / Q3_K; v2h's: 64 registers (63 at Q3_K), no spills; v2t's and v2m's:
// 64, no spills; v2s's: 64, 4 bytes of spill stores and 4 of loads at Q3_K
// (as v2g's), none at Q4_K / Q2_K; v3's: 55-64, v2's and v2f's: 62-64,
// v1's: 64, no spills (printed by tools/time_v2_kernels.py,
// tools/ptxas_diff.py and chip_smoke.py phase 1).

#pragma once

#include "qmatmul_mma.cuh"

namespace {

constexpr int kDecodeRows = 8;  // x rows per block: the n8 of mma.sync
// blocks per SM the tile is declared for (64 registers a thread) and its
// deepest ring (3, 4 or 6 stages moved no timed step by more than 1.5%)
constexpr int kDecodeBlocks = 4;
constexpr int kDecodeStages = 6;
// bytes between staged code rows: 16 past a row of 128 columns, so the four
// lanes of a fragment's k slots (rows 2 apart) load from distinct banks
constexpr int kDecodePitch = kMmaBN + 16;
// shared memory of one block: the SM's 228 KB over the blocks, less the
// 1 KB the card reserves for each
constexpr int kDecodeSmem = 233472 / kDecodeBlocks - 1024;

// shared-memory layout of one block: S stages as the prefill loop's
// (x tile, the format's planes, xsum), two buffers of a step's f32 group
// rows (scales, then offsets: [GPK][kMmaBN] each), and the second K
// half's sums [4 column groups][32 lanes][8]
template <class F, int S>
struct DecodeTile {
  using M = MmaTile<F, kDecodeRows, S>;
  static constexpr int GPK = M::GPK;
  static constexpr int STAGE = M::STAGE;
  static constexpr int ROWS = 2 * GPK * kMmaBN;  // floats of one buffer
  static constexpr int R_OFF = S * STAGE;
  static constexpr int RED_OFF = R_OFF + 2 * ROWS * 4;
  static constexpr int BYTES = RED_OFF + 4 * 32 * 8 * 4;
  static_assert(STAGE % 16 == 0 && R_OFF % 16 == 0 && RED_OFF % 16 == 0, "alignment");
};

// the decode tile's k16 slice j (0, 1) of K half kh (0, 1): 4-bit codes
// take the low nibbles of code rows 16 kh.. (slice kh) and their high
// nibbles (slice 2 + kh), byte codes the rows 32 kh.. (slices 2 kh, 2 kh + 1)
template <int PB>
__device__ __forceinline__ int decode_slice(int kh, int j) {
  return PB == 2 ? kh + 2 * j : 2 * kh + j;
}

// The decode tile's bf16 A fragments: two m16 tiles by the two k16 slices
// j of K half kh, built from the staged codes straight into registers. The
// thread's columns c0..c0 + 3 are rows g, g + 8 of tile 0 and of tile 1;
// its k slots 2t, 2t + 1, 2t + 8, 2t + 9 of a slice are code rows r0,
// r0 + 1, r0 + 8, r0 + 9, so one 32-bit load gives a row's 4 columns (and,
// with 4-bit codes, both slices: slice 1 the high nibbles). q is the
// thread's first column in the step's first staged code row, PITCH bytes
// a row. The policy gives the weights: slice(j, sl) once per slice (its
// group rows into the policy's registers) returns a mask the slice's code
// bytes are XOR-ed with, and wt(j, c, mq) the f32 weight of column c0 + c
// from mq = 2^23 + that code byte (byte_magic), before the bf16 rounding;
// or, with PAIRS, wt(j, c, ma, mb) the bf16 pair of column c0 + c from
// byte c of the code words ma (low half) and mb (high half), for a policy
// whose weights are bf16 arithmetic.
template <int PB, int PITCH, bool PAIRS = false, class Slice, class Weight>
__device__ __forceinline__ void decode_frags(const char* q, int kh, int t, Slice slice,
                                             Weight wt, uint32_t (&af)[2][2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int sl = decode_slice<PB>(kh, j);
    const uint32_t flip = slice(j, sl);
    const int r0 = (PB == 2 ? 16 * kh : 16 * sl) + 2 * t;
    const uint32_t w[4] = {*reinterpret_cast<const uint32_t*>(q + r0 * PITCH),
                           *reinterpret_cast<const uint32_t*>(q + (r0 + 1) * PITCH),
                           *reinterpret_cast<const uint32_t*>(q + (r0 + 8) * PITCH),
                           *reinterpret_cast<const uint32_t*>(q + (r0 + 9) * PITCH)};
    uint32_t m[4];  // the codes as bytes (4-bit: slice 1 the high nibbles)
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = (PB == 2 ? (w[k] >> (4 * j)) & 0x0F0F0F0Fu : w[k]) ^ flip;
    if constexpr (PAIRS) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        af[j][i][0] = wt(j, 2 * i, m[0], m[1]);
        af[j][i][1] = wt(j, 2 * i + 1, m[0], m[1]);
        af[j][i][2] = wt(j, 2 * i, m[2], m[3]);
        af[j][i][3] = wt(j, 2 * i + 1, m[2], m[3]);
      }
    } else {
      auto v = [&](int c, int k) { return wt(j, c, byte_magic(m[k], c)); };
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        af[j][i][0] = bf16x2_bits(v(2 * i, 0), v(2 * i, 1));
        af[j][i][1] = bf16x2_bits(v(2 * i + 1, 0), v(2 * i + 1, 1));
        af[j][i][2] = bf16x2_bits(v(2 * i, 2), v(2 * i, 3));
        af[j][i][3] = bf16x2_bits(v(2 * i + 1, 2), v(2 * i + 1, 3));
      }
    }
  }
}

// F's ring depth: kDecodeStages, or as many stages as fit in kDecodeSmem
template <class F>
__host__ __device__ constexpr int decode_stages() {
  using T1 = DecodeTile<F, 1>;
  constexpr int fit = (kDecodeSmem - (T1::BYTES - T1::STAGE)) / T1::STAGE;
  return fit < kDecodeStages ? fit : kDecodeStages;
}

// PROBE is 0 in every kernel of a path; 1 and 2 are the timing probes of
// qmatmul_v2g_probe.cu (wrong results): 1 takes raw code words as A, no
// dequantization, 2 also stages no planes
template <class F, int PROBE = 0>
__global__ void __launch_bounds__(kMmaThreads, kDecodeBlocks)
    decode_mma_kernel(typename F::Args a) {
  constexpr int S = decode_stages<F>();
  using T = DecodeTile<F, S>;
  constexpr int GPK = T::GPK;
  constexpr int QUARTERS = kQK / kMmaKT;
  static_assert(S >= 3, "a ring of at least three stages (group rows one step ahead)");
  static_assert(!F::SPLIT_HALVES || (F::PB == 2 && !F::GROUP_DOT), "split halves: 4-bit weights");
  static_assert(!F::GROUP_SUM || F::GROUP_DOT, "a group sum is a group dot");
  extern __shared__ __align__(16) char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = warp % 4, kh = warp / 4;          // column group, K half
  const int c0 = 32 * cw + 4 * (lane / 4), t4 = lane % 4;
  const int n0 = blockIdx.x * kMmaBN;
  const int n_sg = a.d_in / kQK;
  const int sg_begin = blockIdx.z * a.sg_per_split;
  const int steps = (min(n_sg, sg_begin + a.sg_per_split) - sg_begin) * QUARTERS;
  const size_t ldo = static_cast<size_t>(a.d_out);
  const int cols_left = a.d_out - n0;
  const bool w16 = a.d_out % 16 == 0;
  auto stage = [&](int t) { return smem + (t % S) * T::STAGE; };
  auto rows_of = [&](int t) {
    return reinterpret_cast<float*>(smem + T::R_OFF) + (t % 2) * T::ROWS;
  };

  // step t's x tile and raw planes into its stage
  auto issue = [&](int t) {
    char* st = stage(t);
    const int sg = sg_begin + t / QUARTERS, q = t % QUARTERS;
    stage_x<F, kDecodeRows>(a, reinterpret_cast<__nv_bfloat16*>(st + T::M::X_OFF),
                            reinterpret_cast<float*>(st + T::M::G_OFF), 0, sg, q);
    if constexpr (PROBE != 2) F::template issue<T::M::P_OFF>(a, st, sg, q, n0, cols_left, w16);
  };

  // step t's f32 group rows (one step ahead of its products) and, for a
  // bf16 x, its group sums
  auto prepare = [&](int t) {
    char* st = stage(t);
    float* r = rows_of(t);
    F::template rows<T::M::P_OFF>(a, st, r, r + GPK * kMmaBN);
    sum_x<F, kDecodeRows, T::M::X_OFF, T::M::G_OFF>(a, st);
  };

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  // step t's products of this warp's 32 columns and K half
  auto product = [&](int t) {
    const char* st = stage(t);
    const float* r = rows_of(t);
    uint32_t af[2][2][4];
    if constexpr (PROBE != 0) {  // four raw code words as A
      const char* q = st + T::M::P_OFF + c0 + (16 * kh + 2 * t4) * kDecodePitch;
      const uint32_t w[4] = {*reinterpret_cast<const uint32_t*>(q),
                             *reinterpret_cast<const uint32_t*>(q + kDecodePitch),
                             *reinterpret_cast<const uint32_t*>(q + 8 * kDecodePitch),
                             *reinterpret_cast<const uint32_t*>(q + 9 * kDecodePitch)};
#pragma unroll
      for (int e = 0; e < 16; ++e) af[e / 8][e / 4 % 2][e % 4] = w[e % 4] + e / 4;
    } else {
      F::template frags<T::M::P_OFF>(a, st, r, r + GPK * kMmaBN, c0, kh, t4, af);
    }
    uint32_t bx[4];  // x rows 0-7 at the two slices' k: b0, b1 of slice 0, then of slice 1
    ldsm_x4(bx, reinterpret_cast<const __nv_bfloat16*>(st + T::M::X_OFF) + (lane % 8) * kAStride +
                    16 * decode_slice<F::PB>(kh, lane / 16) + 8 * ((lane / 8) % 2));
    if constexpr (F::GROUP_DOT) {  // each slice's partial times its group's scale
      float sum[2][4];               // group sum: the step's scaled partials
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16_first(p[i], af[j][i], bx[2 * j], bx[2 * j + 1]);
        const int lg = 16 * decode_slice<F::PB>(kh, j) / F::GS;  // the slice's group
        const float4 s4 = *reinterpret_cast<const float4*>(r + lg * kMmaBN + c0);
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
        // tile i's C values e: column c0 + 2i + e / 2
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float se = sc[2 * i + e / 2];
            if constexpr (F::GROUP_SUM)
              sum[i][e] = j == 0 ? p[i][e] * se : fmaf(p[i][e], se, sum[i][e]);
            else
              acc[i][e] = fmaf(p[i][e], se, acc[i][e]);
          }
      }
      if constexpr (F::GROUP_SUM) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += sum[i][e];
      }
    } else if constexpr (F::SPLIT_HALVES) {  // the low nibbles into acc, the high ones apart
      float p[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i], af[0][i], bx[0], bx[1]);
        mma_bf16_first(p[i], af[1][i], bx[2], bx[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += p[i][e];
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i], af[j][i], bx[2 * j], bx[2 * j + 1]);
    }
    if constexpr (F::XSUM) {
      if (F::has_off(a) && kh == 0) {  // the step's every group, once per column
        const float* xg = reinterpret_cast<const float*>(st + T::M::G_OFF);
        const float* off = F::template offsets<T::M::P_OFF>(st, r + GPK * kMmaBN);
#pragma unroll
        for (int lg = 0; lg < GPK; ++lg) {
          const float x0 = xg[2 * t4 * GPK + lg], x1 = xg[(2 * t4 + 1) * GPK + lg];
          const float4 o = *reinterpret_cast<const float4*>(off + lg * kMmaBN + c0);
          const float oc[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[i][0] = fmaf(-x0, oc[2 * i], acc[i][0]);
            acc[i][1] = fmaf(-x1, oc[2 * i], acc[i][1]);
            acc[i][2] = fmaf(-x0, oc[2 * i + 1], acc[i][2]);
            acc[i][3] = fmaf(-x1, oc[2 * i + 1], acc[i][3]);
          }
        }
      }
    }
  };

  for (int t = 0; t < S - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // step 0's copies (this thread's) have landed
  __syncthreads();
  prepare(0);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<S - 3>();  // step t + 1's copies (this thread's) have landed
    __syncthreads();         // ... everyone's; step t's rows are ready; step t - 1 is consumed
    if (t + S - 1 < steps) issue(t + S - 1);
    cp_async_commit();
    if (t + 1 < steps) prepare(t + 1);
    product(t);
  }

  // the second K half's sums meet the first's in a fixed order
  float* red = reinterpret_cast<float*>(smem + T::RED_OFF) + (cw * 32 + lane) * 8;
  if (kh == 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[e] = acc[e / 4][e % 4];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e / 4][e % 4] += red[e];
  // tile i's A rows g, g + 8 are columns c0 + 2i, c0 + 2i + 1; its C
  // columns the x rows 2 t4, 2 t4 + 1
  float* o = a.dst + static_cast<size_t>(blockIdx.z) * a.M * ldo;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t4 + e % 2, n = n0 + c0 + 2 * i + e / 2;
      if (m < a.M && n < a.d_out) o[static_cast<size_t>(m) * ldo + n] = acc[i][e];
    }
}

// format F's decode tile over all of x's rows (M <= 8)
template <class F, int PROBE = 0>
void launch_decode_mma_tile(const typename F::Args& a) {
  constexpr int bytes = DecodeTile<F, decode_stages<F>()>::BYTES;
  auto kernel = decode_mma_kernel<F, PROBE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((a.d_out + kMmaBN - 1) / kMmaBN, 1, a.splits);
  kernel<<<grid, kMmaThreads, bytes, a.stream>>>(a);
}

}  // namespace
