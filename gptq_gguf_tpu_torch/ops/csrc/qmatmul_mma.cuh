// Tensor-core prefill mainloop of the dequant-matmul kernels, for Hopper
// (sm_90a): one kernel body, mma_kernel<F, BM>, for every runtime format
// and v2 kernel variant with a prefill tile. The format F is a policy type
// that stages a step's planes and turns them into the bf16 B operand;
// everything else is here. Instantiated with:
//   V2Mma<BUILD, PB, GS, HAS_MIN> (qmatmul_v2_mma.cuh): the per-weight v2
//       builds v2g / v2 / v3 / v2f / v2h (qmatmul_v2g.cu, qmatmul_v2.cu,
//       qmatmul_v3.cu);
//   V2Mma<kV2s, 2, GS, HAS_MIN> (the same file): v2s, v2g's weights with
//       the low- and high-nibble halves summed apart (qmatmul_v2g.cu);
//   V4Mma<PB, GS, I8> (qmatmul_v4.cu): the v4 bodies pb2, pb2_i8, pb1;
//   GroupDotMma<PB, GS, HAS_MIN> (qmatmul_v2m_mma.cuh): the group-dot
//       variants v2m (gs 32) and v2p (gs 16), and GroupSumMma<PB, HAS_MIN>
//       there: v2t (gs 32) (qmatmul_v2m.cu);
//   V1Mma<PB, GS> (qmatmul_v1_mma.cuh): v1 with a bf16 x, a group dot of
//       raw codes with v1's f32 scale_t and offset_t rows (qmatmul_v1.cu).
// (The decode tiles of qmatmul_decode_mma.cuh stage their steps with the
// same policy issue and stage_x / sum_x below.)
// Each computes, from M >= 9 rows (qmatmul.MMA_MIN_ROWS):
//   y (M, d_out) f32 = bf16(x) @ w  [ - xsum @ off ]   (f32 sums)
// with w the format's bf16 weight from the same helpers its CUDA-core
// decode kernel uses (so bit for bit the decode kernel's, and the JAX
// bodies'), off the format's per-group offset row, and xsum the f32 group
// sums of the un-rounded x. Only the order of the f32 sums differs. A
// group-dot policy (F::GROUP_DOT) builds the raw codes instead, and the
// products of each GS-row group go into a partial sum that is scaled into
// the accumulator:  y = sum_g scale_g * (bf16(x_g) @ q_g) - xsum @ off.
// A group-sum policy (F::GROUP_SUM, with GROUP_DOT) sums a step's scaled
// partials first and adds that sum to the accumulator once (JAX's v2t:
// sum(parts * scale) before the output). A split-halves policy
// (F::SPLIT_HALVES; 4-bit codes) sums a step's high-nibble products on
// their own before they meet the low-nibble ones in the accumulator (JAX's
// v2s: x_lo @ w_lo + x_hi @ w_hi, the halves meeting once per K tile).
//
// What bounds it: operations from M ~ 300 up (Llama-3-8B gate/up at M =
// 1024: 240 GFLOP against 66 MB of planes and x), bytes below. The CUDA-core
// tiles it replaced ran every weight through M f32 FMAs at 25-29 TFLOP/s
// (H100, 700 W) and dequantized each weight once per 32 rows of x.
//
// Design:
//   * a block computes BM (32, 64 or 128) rows x 128 columns with 8 warps
//     (2 along M, 4 along N; a warp tile of BM/2 x 32) by
//     mma.sync.m16n8k16 bf16 -> f32, the accumulators in registers;
//   * K is walked 64 weight rows at a time (a quarter supergroup; with 4-bit
//     codes 32 code-byte rows, whose low and high nibbles are the weight
//     rows k and k + 128, so the step's x columns are the same two 32-wide
//     runs); a 3-stage cp.async ring brings each step's x tile (bf16,
//     row-major, 16-byte copies) and the format's raw planes (F::issue:
//     16-byte copies, 4-byte ones where a plane's rows are not 16-byte
//     aligned) while the previous steps compute; f32 x is loaded through
//     registers and rounded to bf16 as it is stored, its group sums taken on
//     the way;
//   * two blocks per SM (__launch_bounds__(256, 2): at most 116 KB of shared
//     memory each, at most 128 registers a thread; the 128-row v2 and
//     group-dot tiles spill 84-216 bytes of stores, 152-560 of loads):
//     while one block dequantizes, the other's warps keep the tensor cores
//     busy. On an H100
//     (700 W) this ran one Llama-3-8B v2g forward at M = 1024 in 109 ms
//     against 131 ms at one block per SM; 16 warps of 32 x 32 in one
//     512-thread block took 146 ms, and a double-buffered weight tile with
//     one barrier per step 125 ms (tools/time_v2_kernels.py, PERF.md);
//   * the block's threads dequantize the step's codes once into a bf16
//     k-major [64][128] tile (F::build), so each weight is dequantized
//     M / BM times; fragments come by ldmatrix.x4 (x) and ldmatrix.x4.trans
//     (weights); rows padded by 16 bytes so an ldmatrix's 8 rows hit
//     distinct banks;
//   * xsum @ off (formats that fold the offset out of the weight: v2g, v3,
//     v4 with an offc plane, the group-dot variants) is subtracted from the
//     accumulator fragments in f32 on the CUDA cores after each step's
//     products: K / gs FMAs per output, 1/32 (gs 32) or 1/16 (gs 16) of the
//     main work, at a fifteenth of the tensor cores' rate;
//   * group dot (F::GROUP_DOT): per group of the step, its GS / 16 k16
//     slices of mma.sync go into a fresh partial fragment (the first with a
//     zero C operand), which one FMA per output adds to the accumulator
//     times the group's f32 scale: as many CUDA-core FMAs again as the xsum
//     term. The partial covers one m16 row tile at a time, so it costs 16
//     registers at any BM;
//   * group sum (F::GROUP_SUM): the same partials, the loop turned round
//     (row tiles outside, the step's groups inside), so one step sum per
//     m16 row tile (16 registers) takes each group's scaled partial before
//     one add into the accumulator; every group's B fragments stay in
//     registers across the row tiles (GPK x 16);
//   * split halves (F::SPLIT_HALVES): k16 slices 0-1 of a step (the low
//     nibbles) go into the accumulators, 2-3 (the high nibbles) into a
//     fresh partial per m16 row tile (16 registers, their B fragments
//     held across the row tiles), added once. A second accumulator set
//     for the whole K range (the decode kernel's acc_hi) took 64 more
//     registers at BM = 128 and ran 2.6x slower (H100,
//     tools/time_v2_kernels.py: PERF.md);
//   * split-K over supergroups into the partial buffer, reduced in a fixed
//     order (finish_launch): no float atomics, reproducible run to run;
//   * ragged M rows are zero-filled and not stored; columns past d_out are
//     zero-filled and not stored.
// Next step: wgmma with TMA loads, a producer warp dequantizing straight
// into the wgmma B layout, persistent blocks.
//
// A format F provides: Args (with x, x_bf16, dst, M, d_in, d_out,
// sg_per_split, splits, stream), PB (codes per byte), GS (group size),
// PLANE_BYTES (its planes in one stage), O2_BYTES (its scratch after the
// weight tile), XSUM (whether it may subtract xsum @ off: the code is not
// emitted otherwise), GROUP_DOT (whether its B operand is raw codes whose
// group partials are scaled: the code is not emitted otherwise), GROUP_SUM
// (whether a step's scaled partials are summed before the accumulator),
// SPLIT_HALVES (whether a step's high-nibble products are summed apart;
// neither flag's code is emitted otherwise), has_off(a)
// (whether this weight does), and, for its planes at byte P of a stage st,
// issue<P>(a, st, sg, q, n0, cols_left, w16), build<P>(a, st, ws, o2s),
// offsets<P>(st, o2s) (the step's [GS-group][128] f32 offset rows) and, for
// a group-dot policy, scales<P>(st, o2s) (its f32 scale rows, alike).

#pragma once

#include "qmatmul_common.cuh"

namespace {

constexpr int kMmaThreads = 256;      // 8 warps: 2 along M x 4 along N
constexpr int kMmaBN = 128;           // output columns per block
constexpr int kMmaKT = 64;            // weight rows per pipeline step
constexpr int kMmaStages = 3;         // cp.async ring depth
constexpr int kAStride = kMmaKT + 8;  // bf16 per staged x row (144 B)
constexpr int kBStride = kMmaBN + 8;  // bf16 per weight-tile row (272 B)

// shared-memory layout of one block: STAGES stages (x tile, the format's
// planes, xsum), then the bf16 weight tile and the format's scratch (every
// offset a multiple of 16 bytes)
template <class F, int BM, int STAGES = kMmaStages>
struct MmaTile {
  static constexpr int GPK = kMmaKT / F::GS;  // groups per step
  static constexpr int X_OFF = 0;
  static constexpr int P_OFF = X_OFF + BM * kAStride * 2;  // the format's planes
  static constexpr int G_OFF = P_OFF + F::PLANE_BYTES;     // xsum [BM][GPK] f32
  static constexpr int STAGE = G_OFF + BM * GPK * 4;
  static constexpr int W_OFF = STAGES * STAGE;                  // [kMmaKT][kBStride] bf16
  static constexpr int O2_OFF = W_OFF + kMmaKT * kBStride * 2;  // the format's scratch
  static constexpr int BYTES = O2_OFF + F::O2_BYTES;
  static_assert(F::PLANE_BYTES % 16 == 0 && STAGE % 16 == 0 && W_OFF % 16 == 0 &&
                O2_OFF % 16 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared, zero-filled when !live (src stays a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16x16, row) * b (16x8, col), bf16 operands, f32 result (zero C)
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// four adjacent weights of weight-tile row kk, rounded to bf16 (nearest even)
__device__ __forceinline__ void store_w4(__nv_bfloat16* ws, int kk, int n, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(ws + kk * kBStride + n) =
      make_uint2(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]));
}

// a step's raw codes into the bf16 weight tile, exact (each is < 64), for
// the group-dot policies: thread t takes 4 columns of 8 weight rows (4-bit
// codes: 4 code rows, whose low nibbles are tile rows r and high nibbles
// rows 32 + r); codes points at the first staged code row, PITCH bytes a row
template <int PB, int PITCH = kMmaBN>
__device__ __forceinline__ void build_codes(const char* codes, __nv_bfloat16* ws) {
  const int n = 4 * (threadIdx.x % 32);  // 4 columns per thread
  const int slice = threadIdx.x / 32;     // 8 row slices
  if constexpr (PB == 2) {  // 32 code rows: 4 per slice, low nibbles k, high k + 32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * slice + i;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + r * PITCH + n);
      float lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = small_u2f((w >> (8 * c)) & 0xFu);
        hi[c] = small_u2f((w >> (8 * c + 4)) & 0xFu);
      }
      store_w4(ws, r, n, lo);
      store_w4(ws, 32 + r, n, hi);
    }
  } else {  // 64 code rows: 8 per slice
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * slice + i;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + r * PITCH + n);
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = small_u2f((w >> (8 * c)) & 0xFFu);
      store_w4(ws, r, n, v);
    }
  }
}

// the supergroup-relative row of step-local weight row kk in quarter q:
// 4-bit codes take rows 32q.. (low nibbles) and 128 + 32q.. (high nibbles)
template <int PB>
__device__ __forceinline__ int k_in_sg(int kk, int q) {
  if constexpr (PB == 2) return kk < 32 ? 32 * q + kk : kHalf + 32 * q + kk - 32;
  else return kMmaKT * q + kk;
}

// rows x ROW_BYTES bytes of a plane into shared memory (row r from
// row_src(r), to byte r * PITCH), zero from byte bytes_left of a row on:
// 16-byte copies when every row start is 16-byte aligned (w16), 4-byte ones
// otherwise
template <int ROW_BYTES = kMmaBN, int PITCH = ROW_BYTES, class RowSrc>
__device__ __forceinline__ void stage_rows(char* dst, int rows, int bytes_left, bool w16,
                                           RowSrc row_src) {
  if (w16) {
    constexpr int C = ROW_BYTES / 16;
    for (int i = threadIdx.x; i < rows * C; i += kMmaThreads) {
      const int r = i / C, j = i % C;
      const uint8_t* src = row_src(r);
      const bool in = 16 * j < bytes_left;
      cp_async16(dst + r * PITCH + 16 * j, in ? src + 16 * j : src, in);
    }
  } else {
    constexpr int C = ROW_BYTES / 4;
    for (int i = threadIdx.x; i < rows * C; i += kMmaThreads) {
      const int r = i / C, j = i % C;
      const uint8_t* src = row_src(r);
      const bool in = 4 * j < bytes_left;
      cp_async4(dst + r * PITCH + 4 * j, in ? src + 4 * j : src, in);
    }
  }
}

// rows m0.. of step (sg, q)'s x tile into xs (bf16 [BM][kAStride], rows
// past M zero-filled): a bf16 x by 16-byte cp.async copies; an f32 x
// loaded through registers, rounded to bf16 as it is stored and (formats
// with the xsum term) its group sums taken on the way into xg ([BM][GPK])
template <class F, int BM>
__device__ __forceinline__ void stage_x(const typename F::Args& a, __nv_bfloat16* xs, float* xg,
                                        int m0, int sg, int q) {
  constexpr int GS = F::GS;
  constexpr int GPK = kMmaKT / GS;
  static_assert(BM * 8 % 32 == 0, "whole warps stage x (the group sums shuffle)");
  const float* xf = static_cast<const float*>(a.x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x);
  for (int i = threadIdx.x; i < BM * 8; i += kMmaThreads) {
    const int r = i / 8, c = i % 8, row = m0 + r;
    const bool in = row < a.M;
    const size_t src = static_cast<size_t>(in ? row : 0) * a.d_in +
                       static_cast<size_t>(sg) * kQK + k_in_sg<F::PB>(8 * c, q);
    __nv_bfloat16* dst = xs + r * kAStride + 8 * c;
    if (a.x_bf16) {
      cp_async16(dst, xb + src, in);
    } else {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (in) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(xf + src));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(xf + src + 4));
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                                                  bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
      if constexpr (F::XSUM) {
        if (F::has_off(a)) {  // a group's GS / 8 chunks lie in adjacent lanes
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) s += v[j];
#pragma unroll
          for (int o = 1; o < GS / 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (c % (GS / 8) == 0) xg[r * GPK + 8 * c / GS] = s;
        }
      }
    }
  }
}

// the group sums of the bf16 x tile staged at byte X_OFF of st (its own
// values) into the f32 [BM][GPK] at byte G_OFF, for the xsum term (an f32 x
// has them from stage_x). The tile's addresses are formed inside the
// branch: formed before it, they moved ptxas's registers and spills in 22
// prefill instances of v2g, v3 and v2m (PERF.md).
template <class F, int BM, int X_OFF, int G_OFF>
__device__ __forceinline__ void sum_x(const typename F::Args& a, char* st) {
  constexpr int GS = F::GS;
  constexpr int GPK = kMmaKT / GS;
  if constexpr (F::XSUM) {
    if (F::has_off(a) && a.x_bf16) {
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + X_OFF);
      float* xg = reinterpret_cast<float*>(st + G_OFF);
      for (int i = threadIdx.x; i < BM * GPK; i += kMmaThreads) {
        const int r = i / GPK, lg = i % GPK;
        const uint4* p = reinterpret_cast<const uint4*>(xs + r * kAStride + lg * GS);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < GS / 8; ++j) {
          const uint4 u = p[j];
          s += __uint_as_float(u.x << 16) + __uint_as_float(u.x & 0xFFFF0000u);
          s += __uint_as_float(u.y << 16) + __uint_as_float(u.y & 0xFFFF0000u);
          s += __uint_as_float(u.z << 16) + __uint_as_float(u.z & 0xFFFF0000u);
          s += __uint_as_float(u.w << 16) + __uint_as_float(u.w & 0xFFFF0000u);
        }
        xg[i] = s;
      }
    }
  }
}

template <class F, int BM>
__global__ void __launch_bounds__(kMmaThreads, 2) mma_kernel(typename F::Args a) {
  using T = MmaTile<F, BM>;
  constexpr int PB = F::PB;
  constexpr int GS = F::GS;
  constexpr int GPK = T::GPK;
  constexpr int QUARTERS = kQK / kMmaKT;
  constexpr int WM = BM / 2;             // warp tile rows
  constexpr int MI = WM / 16;            // m16 tiles per warp
  constexpr int NI = 4;                  // n8 tiles per warp (32 columns)
  extern __shared__ __align__(16) char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * kMmaBN;
  const int m0 = blockIdx.y * BM;
  const int n_sg = a.d_in / kQK;
  const int sg_begin = blockIdx.z * a.sg_per_split;
  const int steps = (min(n_sg, sg_begin + a.sg_per_split) - sg_begin) * QUARTERS;
  const size_t ldo = static_cast<size_t>(a.d_out);
  const int cols_left = a.d_out - n0;
  const bool w16 = a.d_out % 16 == 0;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + T::W_OFF);
  float* o2s = reinterpret_cast<float*>(smem + T::O2_OFF);

  // step t's x tile and raw planes into stage t % kMmaStages
  auto issue = [&](int t) {
    char* st = smem + (t % kMmaStages) * T::STAGE;
    const int sg = sg_begin + t / QUARTERS, q = t % QUARTERS;
    stage_x<F, BM>(a, reinterpret_cast<__nv_bfloat16*>(st + T::X_OFF),
                   reinterpret_cast<float*>(st + T::G_OFF), m0, sg, q);
    F::template issue<T::P_OFF>(a, st, sg, q, n0, cols_left, w16);
  };

  // step t's weights dequantized into the bf16 tile (and the format's
  // offset scratch), and (bf16 x) its group sums
  auto build = [&](int t) {
    char* st = smem + (t % kMmaStages) * T::STAGE;
    F::template build<T::P_OFF>(a, st, ws, o2s);
    sum_x<F, BM, T::X_OFF, T::G_OFF>(a, st);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  static_assert(!F::SPLIT_HALVES || (PB == 2 && !F::GROUP_DOT), "split halves: 4-bit weights");
  static_assert(!F::GROUP_SUM || F::GROUP_DOT, "a group sum is a group dot");

  // step t's products (and its xsum term) into the accumulators
  auto product = [&](int t) {
    const char* st = smem + (t % kMmaStages) * T::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::X_OFF);
    if constexpr (F::GROUP_SUM) {  // per row tile: sum_g partial_g * scale_g, then one add
      constexpr int KG = GS / 16;  // k16 slices per group
      const float* sc = F::template scales<T::P_OFF>(st, o2s);
      uint32_t bf[GPK][KG][NI][2];
#pragma unroll
      for (int lg = 0; lg < GPK; ++lg)
#pragma unroll
        for (int kg = 0; kg < KG; ++kg)
#pragma unroll
          for (int np = 0; np < NI / 2; ++np) {
            uint32_t r[4];
            ldsm_x4_trans(r, ws + ((lg * KG + kg) * 16 + lane % 16) * kBStride + wn * 32 + np * 16 +
                                 (lane / 16) * 8);
            bf[lg][kg][2 * np][0] = r[0];
            bf[lg][kg][2 * np][1] = r[1];
            bf[lg][kg][2 * np + 1][0] = r[2];
            bf[lg][kg][2 * np + 1][1] = r[3];
          }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float sum[NI][4];
#pragma unroll
        for (int lg = 0; lg < GPK; ++lg) {
          float p[NI][4];
#pragma unroll
          for (int kg = 0; kg < KG; ++kg) {
            uint32_t af[4];
            ldsm_x4(af, xs + (wm * WM + mi * 16 + lane % 16) * kAStride + (lg * KG + kg) * 16 +
                            (lane / 16) * 8);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              if (kg == 0) mma_bf16_first(p[ni], af, bf[lg][kg][ni][0], bf[lg][kg][ni][1]);
              else mma_bf16(p[ni], af, bf[lg][kg][ni][0], bf[lg][kg][ni][1]);
            }
          }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const float2 s =
                *reinterpret_cast<const float2*>(sc + lg * kMmaBN + wn * 32 + ni * 8 + 2 * (lane % 4));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float se = e % 2 ? s.y : s.x;
              sum[ni][e] = lg == 0 ? p[ni][e] * se : fmaf(p[ni][e], se, sum[ni][e]);
            }
          }
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sum[ni][e];
      }
    } else if constexpr (F::GROUP_DOT) {  // each group's partial, then acc += partial * scale
      constexpr int KG = GS / 16;  // k16 slices per group
      const float* sc = F::template scales<T::P_OFF>(st, o2s);
#pragma unroll
      for (int lg = 0; lg < GPK; ++lg) {
        uint32_t bf[KG][NI][2];
#pragma unroll
        for (int kg = 0; kg < KG; ++kg)
#pragma unroll
          for (int np = 0; np < NI / 2; ++np) {
            uint32_t r[4];
            ldsm_x4_trans(r, ws + ((lg * KG + kg) * 16 + lane % 16) * kBStride + wn * 32 + np * 16 +
                                 (lane / 16) * 8);
            bf[kg][2 * np][0] = r[0];
            bf[kg][2 * np][1] = r[1];
            bf[kg][2 * np + 1][0] = r[2];
            bf[kg][2 * np + 1][1] = r[3];
          }
        float2 s[NI];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          s[ni] = *reinterpret_cast<const float2*>(sc + lg * kMmaBN + wn * 32 + ni * 8 + 2 * (lane % 4));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          float p[NI][4];
#pragma unroll
          for (int kg = 0; kg < KG; ++kg) {
            uint32_t af[4];
            ldsm_x4(af, xs + (wm * WM + mi * 16 + lane % 16) * kAStride + (lg * KG + kg) * 16 +
                            (lane / 16) * 8);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              if (kg == 0) mma_bf16_first(p[ni], af, bf[kg][ni][0], bf[kg][ni][1]);
              else mma_bf16(p[ni], af, bf[kg][ni][0], bf[kg][ni][1]);
            }
          }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            acc[mi][ni][0] = fmaf(p[ni][0], s[ni].x, acc[mi][ni][0]);
            acc[mi][ni][1] = fmaf(p[ni][1], s[ni].y, acc[mi][ni][1]);
            acc[mi][ni][2] = fmaf(p[ni][2], s[ni].x, acc[mi][ni][2]);
            acc[mi][ni][3] = fmaf(p[ni][3], s[ni].y, acc[mi][ni][3]);
          }
        }
      }
    } else if constexpr (F::SPLIT_HALVES) {  // the low half into acc, the high half apart
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // the low nibbles into the accumulators
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(af[mi], xs + (wm * WM + mi * 16 + lane % 16) * kAStride + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, ws + (ks * 16 + lane % 16) * kBStride + wn * 32 + np * 16 + (lane / 16) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
      uint32_t bh[2][NI][2];  // the high nibbles: the step's partial per row tile
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, ws + ((2 + k) * 16 + lane % 16) * kBStride + wn * 32 + np * 16 + (lane / 16) * 8);
          bh[k][2 * np][0] = r[0];
          bh[k][2 * np][1] = r[1];
          bh[k][2 * np + 1][0] = r[2];
          bh[k][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float p[NI][4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uint32_t af[4];
          ldsm_x4(af, xs + (wm * WM + mi * 16 + lane % 16) * kAStride + (2 + k) * 16 + (lane / 16) * 8);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            if (k == 0) mma_bf16_first(p[ni], af, bh[k][ni][0], bh[k][ni][1]);
            else mma_bf16(p[ni], af, bh[k][ni][0], bh[k][ni][1]);
          }
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[ni][e];
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kMmaKT / 16; ++ks) {
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(af[mi], xs + (wm * WM + mi * 16 + lane % 16) * kAStride + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, ws + (ks * 16 + lane % 16) * kBStride + wn * 32 + np * 16 + (lane / 16) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
    }
    if constexpr (F::XSUM) {
      if (F::has_off(a)) {
        const float* xg = reinterpret_cast<const float*>(st + T::G_OFF);
        const float* off = F::template offsets<T::P_OFF>(st, o2s);
#pragma unroll
        for (int lg = 0; lg < GPK; ++lg) {
          float xr[MI][2];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) xr[mi][h] = xg[(wm * WM + mi * 16 + lane / 4 + 8 * h) * GPK + lg];
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const float2 o = *reinterpret_cast<const float2*>(off + lg * kMmaBN + wn * 32 + ni * 8 +
                                                               2 * (lane % 4));
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              acc[mi][ni][0] = fmaf(-xr[mi][0], o.x, acc[mi][ni][0]);
              acc[mi][ni][1] = fmaf(-xr[mi][0], o.y, acc[mi][ni][1]);
              acc[mi][ni][2] = fmaf(-xr[mi][1], o.x, acc[mi][ni][2]);
              acc[mi][ni][3] = fmaf(-xr[mi][1], o.y, acc[mi][ni][3]);
            }
          }
        }
      }
    }
  };

  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kMmaStages - 2>();  // step t's copies (this thread's) have landed
    __syncthreads();                  // ... everyone's; step t - 1 is fully consumed
    if (t + kMmaStages - 1 < steps) issue(t + kMmaStages - 1);
    cp_async_commit();
    build(t);
    __syncthreads();
    product(t);
  }

  float* o = a.dst + static_cast<size_t>(blockIdx.z) * a.M * ldo;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + mi * 16 + lane / 4 + 8 * h;
        const int col = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        if (row < a.M && col < a.d_out)  // d_out % 4 == 0: the pair is whole
          *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * ldo + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

template <class F, int BM>
void launch_mma_tile(const typename F::Args& a) {
  constexpr int bytes = MmaTile<F, BM>::BYTES;
  auto kernel = mma_kernel<F, BM>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((a.d_out + kMmaBN - 1) / kMmaBN, (a.M + BM - 1) / BM, a.splits);
  kernel<<<grid, kMmaThreads, bytes, a.stream>>>(a);
}

// format F's tile of bm rows per block (32, 64 or 128); false for another bm
template <class F>
bool launch_mma_tiles(const typename F::Args& a, int bm) {
  switch (bm) {
    case 32: launch_mma_tile<F, 32>(a); return true;
    case 64: launch_mma_tile<F, 64>(a); return true;
    case 128: launch_mma_tile<F, 128>(a); return true;
    default: return false;
  }
}

}  // namespace
