// Per-weight dequant + matmul over the v2 runtime format, for Hopper
// (sm_90a): one kernel template for the six Pallas bodies behind
// gptq_gguf_tpu/ops/qmatmul.py::dequant_matmul_pallas_v2 that build every
// weight before the product and differ only in how. Three sources
// instantiate it, two builds each, so nvcc compiles them in parallel:
//   qmatmul_v2g.cu  _kernel_v2g (the default), _kernel_v2s
//   qmatmul_v2.cu   _kernel_v2, _kernel_v2f
//   qmatmul_v3.cu   _kernel_v3, _kernel_v2h
// (the group-dot bodies v2m / v2t / v2p are qmatmul_v2m.cu).
//
// Computes, for x (M, d_in) f32 or bf16 and one v2-packed weight:
//   y (M, d_out) f32 = sum_k T(x_k) * w_k  [ - xsum @ off2 ]   (f32 sums)
//   scale[g, n] = d_sg[d_rep * (g / gpsg), n] * f32(sc_q[g, n])   (exact: 17 bits)
//   off2[g, n]  = dmin_sg[...] * f32(mn_q[g, n])  (types with a min; their shift is 0)
//               = scale[g, n] * shift             (signed Q3_K / Q6_K)
//   q           = the raw unsigned code, xsum = f32 group sums of the UN-rounded x
// with T the rounding to the operand type (mxu_dtype: bf16, round to nearest
// even, or none for f32) and w, by build:
//   v2g  T(scale * q)                      with the xsum term
//   v2s  v2g's, the low- and high-nibble halves summed apart (JAX's split
//        x_lo @ w_lo + x_hi @ w_hi; 4-bit codes only)
//   v3   T(T(q) * T(scale))                with the xsum term
//   v2   T(scale * (q - shift) - off)      no xsum term
//   v2f  T(scale * q - off2)               no xsum term
//   v2h  T(T(T(scale) * T(q)) - T(off2))   no xsum term: the affine in bf16,
//        each operation rounded (as the JAX body's bf16 arithmetic is)
// Every product above is exact in f32, for it has at most 24 significant
// bits: an 11-bit f16 super-scale, a group scale of at most 7 bits (|int8|
// <= 127 for the signed types, 6-bit codes otherwise) and a code of at most
// 6 bits (|q - 32| <= 32 for Q6_K). So v2's f32 weight (d * sc first, then
// * (q - shift), then - off: JAX's order) equals dequantize_runtime_v2 bit
// for bit whether nvcc contracts the subtraction into an FMA or not (the
// FMA rounds the same exact value once), and v2f's equals it too:
// scale * q - scale * shift is the exact scale * (q - shift). The weights
// equal the JAX bodies' bit for bit; only the order of the f32 sums differs.
//
// What bounds it: bytes at decode. At M <= 8 each packed weight byte feeds
// at most 2 * M multiply-adds, far below the ~295 flop/byte the H100 needs
// before compute matters; one Llama-3-8B B=8 step reads 4,773,330,944 B
// (planes, x, y): d_sg / dmin_sg hold each supergroup's row d_rep = 2 times
// (a TPU tiling rule) and only row d_rep * sg is read.
//
// Design (CUDA cores, f32 accumulation; the decode kernel):
//   * each thread owns VEC = 4 adjacent output columns and reads one 32-bit
//     word per weight row, so a warp reads 128 contiguous bytes per row
//     (VEC = 1 for a d_out that is not a multiple of 4);
//   * x is staged in shared memory one 256-row supergroup at a time for MT
//     rows, rounded to the operand type and laid out k-major so one vector
//     load fetches a row's MT values; the group sums xsum of the un-rounded
//     x are taken while staging;
//   * a group's scale, offsets and build constants are formed once per
//     group and column; codes become floats by the 2^23 magic-number trick
//     and, in bf16, pairs of weights are rounded by one packed conversion;
//   * at decode the block's 4 warps split each supergroup's rows four ways
//     and add their partial sums through shared memory in a fixed order;
//     d_out = 4096 still gives few blocks, so the wrapper also splits the
//     K axis over supergroups (gridDim.z) and a second kernel reduces those
//     partials in a fixed order (no float atomics): token streams stay
//     reproducible run to run;
//   * rows per block: up to 8. With bf16 operands every build runs M >= 9
//     rows on the tensor-core tiles of qmatmul_v2_mma.cuh, and v2g, v2h
//     and v2s also their decode rows (from qmatmul.DECODE_MMA_MIN_ROWS) on
//     the tensor-core decode tile (qmatmul_decode_mma.cuh, tile code
//     kDecodeMmaTile); f32 operands (a test mode) and vec 1 weights stay
//     here at any M, in 8-row tiles, and so do the other builds' decode
//     steps and the calls below those thresholds;
//   * tiles of 8 rows or fewer are declared for 4 blocks per SM, which lets
//     the compiler keep up to 128 registers a thread: left alone it kept 72
//     at the 8-row decode tile and ran the Llama-3-8B gate/up and down
//     projections 16% and 25% slower (tools/time_v2_kernels.py, H100).

#pragma once

#include "qmatmul_common.cuh"

namespace {

enum Build { kV2g = 0, kV2 = 1, kV3 = 2, kV2f = 3, kV2h = 4, kV2s = 5 };

// the builds that leave the offset out of the weights and subtract
// xsum @ off2 instead
__host__ __device__ constexpr bool corrects(int build) {
  return build == kV2g || build == kV3 || build == kV2s;
}

// one group's constants for one column: w = weight(affine, q)
struct Affine {
  float s, o;
};

template <int BUILD, bool BF16, bool HAS_MIN>
__device__ __forceinline__ Affine group_affine(float scale, float off2, float shift) {
  if constexpr (BUILD == kV2) return {scale, HAS_MIN ? off2 : shift};
  else if constexpr (BUILD == kV2f) return {scale, off2};
  else if constexpr (BUILD == kV3) return {BF16 ? bf16_round(scale) : scale, 0.f};
  else if constexpr (BUILD == kV2h)
    return BF16 ? Affine{bf16_round(scale), bf16_round(off2)} : Affine{scale, off2};
  else return {scale, 0.f};  // v2g, v2s
}

// the f32 weight of a code, given as its exact float q, before the final
// rounding to the operand type
template <int BUILD, bool BF16, bool HAS_MIN>
__device__ __forceinline__ float weight_q(const Affine& a, float q) {
  if constexpr (BUILD == kV2) return HAS_MIN ? a.s * q - a.o : a.s * (q - a.o);
  else if constexpr (BUILD == kV2f) return a.s * q - a.o;
  else if constexpr (BUILD == kV2h) return (BF16 ? bf16_round(a.s * q) : a.s * q) - a.o;
  else return a.s * q;  // v2g, v2s, v3 (its scale already rounded)
}

// the f32 weight of code q before the final rounding to the operand type
template <int BUILD, bool BF16, bool HAS_MIN>
__device__ __forceinline__ float weight(const Affine& a, uint32_t code) {
  return weight_q<BUILD, BF16, HAS_MIN>(a, small_u2f(code));
}

template <int BUILD, bool BF16, int PB, int GS, bool HAS_MIN, int MT, int VEC>
__global__ void __launch_bounds__(kThreads, MT <= 8 ? 4 : 1) v2_weight_kernel(V2Args a) {
  constexpr int KS = Slices<MT>::KS;
  constexpr int COLT = kThreads / KS;  // column threads per slice
  constexpr int GPSG = kQK / GS;       // groups per supergroup
  constexpr int GPS = GPSG / KS;       // groups per slice (PB == 1)
  constexpr int PPS = GPSG / 2 / KS;   // low/high group pairs per slice (PB == 2)
  constexpr bool SPLIT = BUILD == kV2s;
  static_assert(PB == 1 ? GPS * KS == GPSG : PPS * KS * 2 == GPSG, "slices");
  static_assert(!SPLIT || PB == 2, "v2s takes 4-bit codes only");
  __shared__ __align__(16) float xs[kQK * MT];   // k-major: xs[k * MT + m]
  __shared__ float xg[MT * GPSG];                // xsum of this supergroup
  __shared__ __align__(16) float red[(KS - 1) * MT * COLT * VEC + 1];

  const int tx = threadIdx.x % COLT;
  const int slice = threadIdx.x / COLT;
  const int n0 = (blockIdx.x * COLT + tx) * VEC;
  const int m0 = blockIdx.y * MT;
  const int n_sg = a.d_in / kQK;
  const int sg_begin = blockIdx.z * a.sg_per_split;
  const int sg_end = min(n_sg, sg_begin + a.sg_per_split);
  const bool live = n0 < a.d_out;
  const size_t ldo = static_cast<size_t>(a.d_out);
  const float* xf = static_cast<const float*>(a.x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x);

  float acc[MT][VEC], acc_hi[SPLIT ? MT : 1][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;
#pragma unroll
  for (int m = 0; m < (SPLIT ? MT : 1); ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc_hi[m][c] = 0.f;

  for (int sg = sg_begin; sg < sg_end; ++sg) {
    __syncthreads();  // the previous supergroup's tile is fully consumed
    // stage: one (row, group) per task; group sums of the raw x, tile rounded
    for (int t = threadIdx.x; t < MT * GPSG; t += kThreads) {
      const int m = t / GPSG, g = t % GPSG, row = m0 + m;
      const size_t i0 = static_cast<size_t>(row) * a.d_in + static_cast<size_t>(sg) * kQK + g * GS;
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < GS; ++j) {
        float v = 0.f;
        if (row < a.M) v = a.x_bf16 ? __bfloat162float(xb[i0 + j]) : xf[i0 + j];
        s += v;
        xs[(g * GS + j) * MT + m] = BF16 ? bf16_round(v) : v;
      }
      if constexpr (corrects(BUILD)) xg[m * GPSG + g] = s;
    }
    __syncthreads();
    if (!live) continue;

    float d[VEC], dmin[VEC];
    const size_t sg_row = static_cast<size_t>(sg) * a.d_rep * ldo + n0;
    load_f32<VEC>(a.d_sg + sg_row, d);
    if (HAS_MIN) load_f32<VEC>(a.dmin_sg + sg_row, dmin);

    // one group: its build constants and its offset term
    auto group = [&](int g, Affine (&w)[VEC]) {
      const size_t gi = static_cast<size_t>(sg * GPSG + g) * ldo + n0;
      const uint32_t scw = load_bytes<VEC>(a.sc_q + gi);
      const uint32_t mnw = HAS_MIN ? load_bytes<VEC>(a.mn_q + gi) : 0u;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float s = d[c] * scale_code<!HAS_MIN>(scw, c);
        const float o2 = HAS_MIN ? dmin[c] * static_cast<float>((mnw >> (8 * c)) & 0xFFu)
                                 : s * a.shift;
        w[c] = group_affine<BUILD, BF16, HAS_MIN>(s, o2, a.shift);
        if constexpr (corrects(BUILD)) {
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(-xg[m * GPSG + g], o2, acc[m][c]);
        }
      }
    };

    if (PB == 2) {
      const uint8_t* qrow = a.qs + static_cast<size_t>(sg) * kHalf * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < PPS; ++p) {
        const int g = slice * PPS + p, g_hi = g + GPSG / 2;
        Affine f_lo[VEC], f_hi[VEC];
        group(g, f_lo);
        group(g_hi, f_hi);
#pragma unroll 8
        for (int j = 0; j < GS; ++j) {
          const int k = g * GS + j;
          const uint32_t w = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          float w_lo[VEC], w_hi[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            w_lo[c] = weight<BUILD, BF16, HAS_MIN>(f_lo[c], (w >> (8 * c)) & 0xFu);
            w_hi[c] = weight<BUILD, BF16, HAS_MIN>(f_hi[c], (w >> (8 * c + 4)) & 0xFu);
            if (BF16) bf16_round2(w_lo[c], w_hi[c]);
          }
          float xa[MT], xb2[MT];
          load_x<MT>(xs + k * MT, xa);
          load_x<MT>(xs + (k + kHalf) * MT, xb2);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              if constexpr (SPLIT) {
                acc[m][c] = fmaf(xa[m], w_lo[c], acc[m][c]);
                acc_hi[m][c] = fmaf(xb2[m], w_hi[c], acc_hi[m][c]);
              } else {
                acc[m][c] = fmaf(xa[m], w_lo[c], fmaf(xb2[m], w_hi[c], acc[m][c]));
              }
            }
        }
      }
    } else {
      const uint8_t* qrow = a.qs + static_cast<size_t>(sg) * kQK * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < GPS; ++p) {
        const int g = slice * GPS + p;
        Affine f[VEC];
        group(g, f);
#pragma unroll 8
        for (int j = 0; j < GS; j += 2) {
          const int k = g * GS + j;
          const uint32_t w0 = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          const uint32_t w1 = load_bytes<VEC>(qrow + static_cast<size_t>(k + 1) * ldo);
          float u[VEC], v[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            u[c] = weight<BUILD, BF16, HAS_MIN>(f[c], (w0 >> (8 * c)) & 0xFFu);
            v[c] = weight<BUILD, BF16, HAS_MIN>(f[c], (w1 >> (8 * c)) & 0xFFu);
            if (BF16) bf16_round2(u[c], v[c]);
          }
          float xa[MT], xb2[MT];
          load_x<MT>(xs + k * MT, xa);
          load_x<MT>(xs + (k + 1) * MT, xb2);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[m][c] = fmaf(xa[m], u[c], fmaf(xb2[m], v[c], acc[m][c]));
        }
      }
    }
  }
  if constexpr (SPLIT) {  // the two half-depth sums meet once, at the end
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[m][c] += acc_hi[m][c];
  }

  if (KS > 1) {  // slices 1..KS-1 hand their sums to slice 0
    if (slice > 0 && live) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          red[((slice - 1) * MT + m) * COLT * VEC + tx * VEC + c] = acc[m][c];
    }
    __syncthreads();
    if (slice > 0) return;
    for (int s = 1; s < KS; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          acc[m][c] += red[((s - 1) * MT + m) * COLT * VEC + tx * VEC + c];
  }
  if (!live) return;
  float* o = a.dst + static_cast<size_t>(blockIdx.z) * a.M * ldo;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= a.M) break;
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (n0 + c < a.d_out) o[static_cast<size_t>(row) * ldo + n0 + c] = acc[m][c];
  }
}

template <int BUILD, bool BF16, int PB, int GS, bool HAS_MIN, int MT, int VEC>
void launch(const V2Args& a) {
  constexpr int cols = kThreads / Slices<MT>::KS * VEC;
  const dim3 grid((a.d_out + cols - 1) / cols, (a.M + MT - 1) / MT, a.splits);
  v2_weight_kernel<BUILD, BF16, PB, GS, HAS_MIN, MT, VEC><<<grid, kThreads, 0, a.stream>>>(a);
}

// the tensor-core tiles of qmatmul_v2_mma.cuh (bf16 operands, bm rows per
// block: 32, 64 or 128), defined there
template <int BUILD, int PB, int GS, bool HAS_MIN>
bool launch_mma(const V2Args& a, int bm);

// the tensor-core decode tile of v2g, v2h or v2s (tile code
// kDecodeMmaTile), defined in qmatmul_v2_mma.cuh
template <int BUILD, int PB, int GS, bool HAS_MIN>
bool launch_decode_mma(const V2Args& a);

// row tiles: MT in {1, 2, 4, 8} for VEC 4, {1, 8} for VEC 1 on the CUDA
// cores; mt of 32, 64 or 128 (VEC 4, bf16 operands) the tensor-core tiles
// with mt rows per block; kDecodeMmaTile (VEC 4, bf16 operands, v2g, v2h
// and v2s) the tensor-core decode tile
template <int BUILD, bool BF16, int PB, int GS, bool HAS_MIN>
bool launch_tile(const V2Args& a, int mt, int vec) {
  if (vec == 4) {
    switch (mt) {
      case 1: launch<BUILD, BF16, PB, GS, HAS_MIN, 1, 4>(a); return true;
      case 2: launch<BUILD, BF16, PB, GS, HAS_MIN, 2, 4>(a); return true;
      case 4: launch<BUILD, BF16, PB, GS, HAS_MIN, 4, 4>(a); return true;
      case 8: launch<BUILD, BF16, PB, GS, HAS_MIN, 8, 4>(a); return true;
      case kDecodeMmaTile:
        if constexpr (BF16 && (BUILD == kV2g || BUILD == kV2h || BUILD == kV2s))
          return launch_decode_mma<BUILD, PB, GS, HAS_MIN>(a);
        return false;
      default:
        if constexpr (BF16) return launch_mma<BUILD, PB, GS, HAS_MIN>(a, mt);
        return false;
    }
  }
  if (vec == 1) {
    switch (mt) {
      case 1: launch<BUILD, BF16, PB, GS, HAS_MIN, 1, 1>(a); return true;
      case 8: launch<BUILD, BF16, PB, GS, HAS_MIN, 8, 1>(a); return true;
      default: return false;
    }
  }
  return false;
}

template <int BUILD, bool BF16>
bool launch_format(const V2Args& a, int per_byte, int group_size, int has_min, int mt,
                   int vec) {
  if (per_byte == 2 && group_size == 32 && has_min)  // Q4_K
    return launch_tile<BUILD, BF16, 2, 32, true>(a, mt, vec);
  if (per_byte == 2 && group_size == 16 && has_min)  // Q2_K
    return launch_tile<BUILD, BF16, 2, 16, true>(a, mt, vec);
  if (per_byte == 2 && group_size == 16 && !has_min)  // Q3_K
    return launch_tile<BUILD, BF16, 2, 16, false>(a, mt, vec);
  if constexpr (BUILD != kV2s) {
    if (per_byte == 1 && group_size == 32 && has_min)  // Q5_K
      return launch_tile<BUILD, BF16, 1, 32, true>(a, mt, vec);
    if (per_byte == 1 && group_size == 16 && !has_min)  // Q6_K
      return launch_tile<BUILD, BF16, 1, 16, false>(a, mt, vec);
  }
  return false;
}

template <int BUILD>
bool launch_build(const V2Args& a, int mxu_bf16, int per_byte, int group_size, int has_min,
                  int mt, int vec) {
  return mxu_bf16 ? launch_format<BUILD, true>(a, per_byte, group_size, has_min, mt, vec)
                  : launch_format<BUILD, false>(a, per_byte, group_size, has_min, mt, vec);
}

// launch_build<B> for the B of BUILDS that equals build (false if none)
template <int... BUILDS>
bool dispatch_build(const V2Args& a, int build, int mxu_bf16, int per_byte, int group_size,
                    int has_min, int mt, int vec) {
  return ((build == BUILDS &&
           launch_build<BUILDS>(a, mxu_bf16, per_byte, group_size, has_min, mt, vec)) || ...);
}

}  // namespace

// The C entry point NAME of a source that instantiates the builds listed
// after it. Returns 0 on success, else a cudaError_t value
// (cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// build, format or tile the source does not instantiate). build is a Build
// value; x is bf16 when x_bf16 != 0, else f32; the operands are rounded to
// bf16 when mxu_bf16 != 0, else kept in f32. partials is (splits, M, d_out)
// f32 scratch when splits > 1, ignored otherwise. mt is the rows per block:
// 1, 2, 4, 8 on the CUDA cores; 32, 64, 128 on the tensor cores (vec 4 and
// bf16 operands only); kDecodeMmaTile (16) the tensor-core decode tile of
// v2g, v2h or v2s over all M <= 8 rows (vec 4, bf16 operands). vec 4 needs
// d_out % 4 == 0 and 16-byte-aligned planes. Every pointer is a device
// pointer of contiguous data.
#define GG_V2_WEIGHT_ENTRY(NAME, ...)                                                      \
  extern "C" int NAME(int build, const void* x, int x_bf16, int mxu_bf16,                 \
                      const uint8_t* qs, const float* d_sg, const float* dmin_sg,         \
                      const uint8_t* sc_q, const uint8_t* mn_q, float* partials,          \
                      float* out, int M, int d_in, int d_out, int per_byte,               \
                      int group_size, int has_min, int shift, int d_rep, int mt, int vec, \
                      int sg_per_split, int splits, void* stream) {                       \
    const V2Args a{x, x_bf16, qs, d_sg, dmin_sg, sc_q, mn_q, splits > 1 ? partials : out, \
                   M, d_in, d_out, d_rep, static_cast<float>(shift), sg_per_split,        \
                   splits, static_cast<cudaStream_t>(stream)};                            \
    const bool ok = dispatch_build<__VA_ARGS__>(a, build, mxu_bf16, per_byte, group_size, \
                                                has_min, mt, vec);                        \
    return finish_launch(ok, partials, out, splits, static_cast<size_t>(M) * d_out,       \
                         a.stream);                                                       \
  }
