// Fused K-quant dequant + matmul over the v4 runtime format, for Hopper
// (sm_90a). Built by gptq_gguf_tpu_torch/ops/cuda_build.py into a shared
// library with a plain C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmv4.py::dequant_matmul_v4.
//
// Replaces the three Pallas bodies behind gptq_gguf_tpu/ops/qmv4.py::
// _main_dot_v4, plus the offset correction dequant_matmul_v4 runs after it:
//   _kernel_v4_pb2     4-bit codes, layout "i32": lo = b & 0xF (row k),
//                      hi = b >> 4 (row k + 128)
//   _kernel_v4_pb2_i8  4-bit codes, layout "i8": lo = b & 0x0F,
//                      hi = int8(b & 0xF0) = 16 * (stored nibble as int4); the
//                      x16 and the -8 bias are folded into the stored planes
//   _kernel_v4_pb1     5/6-bit codes, one byte per code: q = byte ("i32") or
//                      int8(byte) ("i8"; the same value, the codes are < 128)
//
// Computes, for x (M, d_in) f32 or bf16 and one v4-packed weight:
//   y (M, d_out) f32 = sum_k bf16(x_k) * bf16(q_k * bf16(s_g))  -  xsum @ offc
//   s     = the (n_groups, d_out) scale plane, f32 or bf16, rounded to bf16
//           even when stored in f32 (the JAX kernels' astype(mxu_dtype))
//   q * bf16(s) is exact in f32 and rounded to bf16 once (a bf16 multiply)
//   xsum  = f32 group sums of the UN-rounded x; offc (n_groups, d_out) f32,
//           absent (null) when the type has neither a min nor a shift
// The products of two bf16 values are exact in f32, so both paths below and
// the plain version differ only in the order of the f32 sums; both paths
// build each weight with the same lo_code / hi_code / byte_code helpers and
// the same rounding, so their bf16 weights are equal bit for bit.
//
// Two paths, chosen by the wrapper's launch plan (qmatmul._plan):
//   * M <= 8 (decode), and weights given one column per thread at any M
//     (vec 1: d_out % 4 != 0 or planes not 16-byte aligned): v4_kernel, f32
//     FMAs on the CUDA cores. Bound by bytes: Q4_K reads 0.75 bytes per
//     weight with f32 scales (0.6875 with bf16 scales), Q6_K 1.5 (1.375);
//     each byte feeds at most 2 * M multiply-adds. The structure of
//     qmatmul_v2_weight.cuh: VEC = 4 adjacent output columns per thread, one
//     32-bit word of codes per weight row; x staged in shared memory a
//     256-row supergroup at a time for MT rows (group sums of the raw x
//     taken there, then rounded to bf16 in place); codes to floats by the
//     2^23 magic-number trick and pairs of weights rounded to bf16 by one
//     packed conversion; 4 warps split each supergroup's rows, and the K
//     axis is split over supergroups with a second kernel reducing the
//     partials in a fixed order.
//   * M >= 9 on vec-4 weights (prefill, perplexity), f32 or bf16 x:
//     V4Mma, this format's policy for the tensor-core mainloop of
//     qmatmul_mma.cuh (mma.sync bf16 -> f32, 32 / 64 / 128-row tiles; what
//     bounds it and its design are written there). Per 64-row step it
//     stages the code bytes (32 rows of nibble pairs, or 64 byte rows), the
//     step's 64 / GS scale rows and offc rows; each thread turns 4 columns
//     of 8 weight rows into bf16(code * bf16(s)), and the mainloop
//     subtracts xsum @ offc from the accumulators, reading the offc rows
//     where they were staged. f32 x is rounded to bf16 as it is staged (v4's
//     products are bf16 whatever x is), its group sums taken first.

#include "qmatmul_common.cuh"
#include "qmatmul_mma.cuh"

namespace {

// VEC bf16 values as floats (8-byte load for VEC 4)
template <int VEC>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xFFFF0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xFFFF0000u);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// the code value of the low nibble of byte c of a word
__device__ __forceinline__ float lo_code(uint32_t w, int c) {
  return small_u2f((w >> (8 * c)) & 0xFu);
}

// the code value of the high nibble of byte c: the nibble itself ("i32"),
// or int8(byte & 0xF0) = 16 * (the nibble read as a signed 4-bit value)
template <bool I8>
__device__ __forceinline__ float hi_code(uint32_t w, int c) {
  const uint32_t n = (w >> (8 * c + 4)) & 0xFu;
  if constexpr (I8) return (small_u2f(n ^ 8u) - 8.f) * 16.f;  // exact
  else return small_u2f(n);
}

// one byte per code: the byte ("i32") or int8(byte) ("i8")
template <bool I8>
__device__ __forceinline__ float byte_code(uint32_t w, int c) {
  const uint32_t b = (w >> (8 * c)) & 0xFFu;
  if constexpr (I8) return small_u2f(b ^ 0x80u) - 128.f;  // exact
  else return small_u2f(b);
}

template <int PB, int GS, bool I8, int MT, int VEC>
__global__ void __launch_bounds__(kThreads) v4_kernel(
    const void* __restrict__ x,       // (M, d_in) f32 or bf16
    int x_bf16,
    const uint8_t* __restrict__ qs,   // (d_in / PB, d_out)
    const void* __restrict__ scale,   // (d_in / GS, d_out) f32 or bf16
    int scale_bf16,
    const float* __restrict__ offc,   // (d_in / GS, d_out) or null
    float* __restrict__ out,          // (gridDim.z, M, d_out)
    int M, int d_in, int d_out, int sg_per_split) {
  constexpr int KS = Slices<MT>::KS;
  constexpr int COLT = kThreads / KS;  // column threads per slice
  constexpr int GPSG = kQK / GS;       // groups per supergroup
  constexpr int GPS = GPSG / KS;       // groups per slice (PB == 1)
  constexpr int PPS = GPSG / 2 / KS;   // low/high group pairs per slice (PB == 2)
  static_assert(PB == 1 ? GPS * KS == GPSG : PPS * KS * 2 == GPSG, "slices");
  __shared__ __align__(16) float xs[kQK * MT];   // k-major: xs[k * MT + m]
  __shared__ float xg[GPSG * MT];                // xsum: xg[g * MT + m]
  __shared__ __align__(16) float red[(KS - 1) * MT * COLT * VEC + 1];

  const int tx = threadIdx.x % COLT;
  const int slice = threadIdx.x / COLT;
  const int n0 = (blockIdx.x * COLT + tx) * VEC;
  const int m0 = blockIdx.y * MT;
  const int n_sg = d_in / kQK;
  const int sg_begin = blockIdx.z * sg_per_split;
  const int sg_end = min(n_sg, sg_begin + sg_per_split);
  const bool live = n0 < d_out;
  const size_t ldo = static_cast<size_t>(d_out);
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* scale_f = static_cast<const float*>(scale);
  const __nv_bfloat16* scale_b = static_cast<const __nv_bfloat16*>(scale);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  for (int sg = sg_begin; sg < sg_end; ++sg) {
    __syncthreads();  // the previous supergroup's tile is fully consumed
    // stage the raw x (thread t writes xs[t]: no bank conflicts)
    for (int t = threadIdx.x; t < MT * kQK; t += kThreads) {
      const int m = t % MT, k = t / MT, row = m0 + m;
      const size_t i = static_cast<size_t>(row) * d_in + static_cast<size_t>(sg) * kQK + k;
      float v = 0.f;
      if (row < M) v = x_bf16 ? __bfloat162float(xb[i]) : xf[i];
      xs[t] = v;
    }
    __syncthreads();
    // group sums of the raw x, then the tile rounded to bf16 in place
    // (each value belongs to one (row, group) task)
    for (int t = threadIdx.x; t < MT * GPSG; t += kThreads) {
      const int m = t % MT, g = t / MT;
      float s = 0.f;
#pragma unroll 4
      for (int j = 0; j < GS; ++j) {
        float* p = xs + (g * GS + j) * MT + m;
        s += *p;
        *p = bf16_round(*p);
      }
      xg[t] = s;
    }
    __syncthreads();
    if (!live) continue;

    // one group: its bf16 scale, and its offset term folded into acc
    auto group_scale = [&](int g, float (&s)[VEC]) {
      const size_t gi = static_cast<size_t>(sg * GPSG + g) * ldo + n0;
      if (scale_bf16) {
        load_bf16<VEC>(scale_b + gi, s);
      } else {
        load_f32<VEC>(scale_f + gi, s);
#pragma unroll
        for (int c = 0; c < VEC; ++c) s[c] = bf16_round(s[c]);
      }
      if (offc != nullptr) {
        float o[VEC];
        load_f32<VEC>(offc + gi, o);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(-xg[g * MT + m], o[c], acc[m][c]);
      }
    };

    if (PB == 2) {
      const uint8_t* qrow = qs + static_cast<size_t>(sg) * kHalf * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < PPS; ++p) {
        const int g = slice * PPS + p, g_hi = g + GPSG / 2;
        float s_lo[VEC], s_hi[VEC];
        group_scale(g, s_lo);
        group_scale(g_hi, s_hi);
#pragma unroll 8
        for (int j = 0; j < GS; ++j) {
          const int k = g * GS + j;
          const uint32_t w = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          float w_lo[VEC], w_hi[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            w_lo[c] = lo_code(w, c) * s_lo[c];
            w_hi[c] = hi_code<I8>(w, c) * s_hi[c];
            bf16_round2(w_lo[c], w_hi[c]);
          }
          float xa[MT], xb2[MT];
          load_x<MT>(xs + k * MT, xa);
          load_x<MT>(xs + (k + kHalf) * MT, xb2);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[m][c] = fmaf(xa[m], w_lo[c], fmaf(xb2[m], w_hi[c], acc[m][c]));
        }
      }
    } else {
      const uint8_t* qrow = qs + static_cast<size_t>(sg) * kQK * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < GPS; ++p) {
        const int g = slice * GPS + p;
        float s[VEC];
        group_scale(g, s);
#pragma unroll 8
        for (int j = 0; j < GS; j += 2) {
          const int k = g * GS + j;
          const uint32_t w0 = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          const uint32_t w1 = load_bytes<VEC>(qrow + static_cast<size_t>(k + 1) * ldo);
          float a[VEC], b[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            a[c] = byte_code<I8>(w0, c) * s[c];
            b[c] = byte_code<I8>(w1, c) * s[c];
            bf16_round2(a[c], b[c]);
          }
          float xa[MT], xb2[MT];
          load_x<MT>(xs + k * MT, xa);
          load_x<MT>(xs + (k + 1) * MT, xb2);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[m][c] = fmaf(xa[m], a[c], fmaf(xb2[m], b[c], acc[m][c]));
        }
      }
    }
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
  float* o = out + static_cast<size_t>(blockIdx.z) * M * ldo;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (n0 + c < d_out) o[static_cast<size_t>(row) * ldo + n0 + c] = acc[m][c];
  }
}

struct Args {
  const void* x;
  int x_bf16;
  const uint8_t* qs;
  const void* scale;
  int scale_bf16;
  const float* offc;
  float* dst;
  int M, d_in, d_out, sg_per_split, splits;
  cudaStream_t stream;
};

// The v4 format's policy for the tensor-core mainloop (qmatmul_mma.cuh):
// per 64-row step the code bytes, the step's scale rows (f32 or bf16) and
// offc rows (f32); each weight bf16(code * bf16(s)), as v4_kernel builds it
template <int PB_, int GS_, bool I8>
struct V4Mma {
  using Args = ::Args;
  static constexpr int PB = PB_;
  static constexpr int GS = GS_;
  static constexpr int GPK = kMmaKT / GS;  // groups per step
  static constexpr int GPSG = kQK / GS;    // groups per supergroup
  static constexpr int CODE_ROWS = kMmaKT / PB;
  // plane offsets in a stage: codes, scale [GPK][kMmaBN] (room for f32),
  // offc [GPK][kMmaBN] f32
  static constexpr int SC_OFF = CODE_ROWS * kMmaBN;
  static constexpr int OFF_OFF = SC_OFF + GPK * kMmaBN * 4;
  static constexpr int PLANE_BYTES = OFF_OFF + GPK * kMmaBN * 4;
  static constexpr int O2_BYTES = 0;  // the offc rows are read where they were staged
  static constexpr bool XSUM = true;  // subtracts xsum @ offc where a weight has offc

  __device__ __forceinline__ static bool has_off(const Args& a) { return a.offc != nullptr; }

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
    // row lg of a per-group plane of esize-byte elements
    auto group_row = [&](const void* plane, int esize) {
      return [=](int lg) {
        const size_t g = sg * GPSG + k_in_sg<PB>(lg * GS, q) / GS;
        return static_cast<const uint8_t*>(plane) + (g * ldo + n0) * esize;
      };
    };
    // f32 rows start 16-byte aligned (d_out % 4 == 0), bf16 ones when d_out % 8 == 0
    if (a.scale_bf16)
      stage_rows<2 * kMmaBN>(p + SC_OFF, GPK, 2 * cols_left, a.d_out % 8 == 0,
                             group_row(a.scale, 2));
    else
      stage_rows<4 * kMmaBN>(p + SC_OFF, GPK, 4 * cols_left, true, group_row(a.scale, 4));
    if (a.offc != nullptr)
      stage_rows<4 * kMmaBN>(p + OFF_OFF, GPK, 4 * cols_left, true, group_row(a.offc, 4));
  }

  // the step's weights into the bf16 tile (store_w4 rounds them)
  template <int P>
  __device__ __forceinline__ static void build(const Args& a, const char* st, __nv_bfloat16* ws,
                                               float*) {
    const char* p = st + P;
    const int n = 4 * (threadIdx.x % 32);  // 4 columns per thread
    const int slice = threadIdx.x / 32;     // 8 row slices
    // group lg's scales of the thread's columns, rounded to bf16
    auto scale = [&](int lg, float (&s)[4]) {
      if (a.scale_bf16) {
        const uint2 t = *reinterpret_cast<const uint2*>(p + SC_OFF + (lg * kMmaBN + n) * 2);
        s[0] = __uint_as_float(t.x << 16);
        s[1] = __uint_as_float(t.x & 0xFFFF0000u);
        s[2] = __uint_as_float(t.y << 16);
        s[3] = __uint_as_float(t.y & 0xFFFF0000u);
      } else {
        const float4 t = *reinterpret_cast<const float4*>(p + SC_OFF + (lg * kMmaBN + n) * 4);
        s[0] = bf16_round(t.x);
        s[1] = bf16_round(t.y);
        s[2] = bf16_round(t.z);
        s[3] = bf16_round(t.w);
      }
    };
    if constexpr (PB == 2) {  // 32 code rows: 4 per slice, one group each half
      float s_lo[4], s_hi[4];
      scale(4 * slice / GS, s_lo);
      scale((32 + 4 * slice) / GS, s_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * slice + i;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(p + r * kMmaBN + n);
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = lo_code(w, c) * s_lo[c];
          hi[c] = hi_code<I8>(w, c) * s_hi[c];
        }
        store_w4(ws, r, n, lo);
        store_w4(ws, 32 + r, n, hi);
      }
    } else {  // 64 code rows: 8 per slice, one group
      float s[4];
      scale(8 * slice / GS, s);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * slice + i;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(p + r * kMmaBN + n);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = byte_code<I8>(w, c) * s[c];
        store_w4(ws, r, n, v);
      }
    }
  }
};

template <int PB, int GS, bool I8, int MT, int VEC>
void launch(const Args& a) {
  constexpr int cols = kThreads / Slices<MT>::KS * VEC;
  const dim3 grid((a.d_out + cols - 1) / cols, (a.M + MT - 1) / MT, a.splits);
  v4_kernel<PB, GS, I8, MT, VEC><<<grid, kThreads, 0, a.stream>>>(
      a.x, a.x_bf16, a.qs, a.scale, a.scale_bf16, a.offc, a.dst, a.M, a.d_in,
      a.d_out, a.sg_per_split);
}

// row tiles: MT in {1, 2, 4, 8} for VEC 4 and {1, 8, 32} for VEC 1 on the
// CUDA cores; mt of 32, 64 or 128 with VEC 4 the tensor-core tiles with mt
// rows per block
template <int PB, int GS, bool I8>
bool launch_tile(const Args& a, int mt, int vec) {
  if (vec == 4) {
    switch (mt) {
      case 1: launch<PB, GS, I8, 1, 4>(a); return true;
      case 2: launch<PB, GS, I8, 2, 4>(a); return true;
      case 4: launch<PB, GS, I8, 4, 4>(a); return true;
      case 8: launch<PB, GS, I8, 8, 4>(a); return true;
      default: return launch_mma_tiles<V4Mma<PB, GS, I8>>(a, mt);
    }
  }
  if (vec == 1) {
    switch (mt) {
      case 1: launch<PB, GS, I8, 1, 1>(a); return true;
      case 8: launch<PB, GS, I8, 8, 1>(a); return true;
      case 32: launch<PB, GS, I8, 32, 1>(a); return true;
      default: return false;
    }
  }
  return false;
}

template <bool I8>
bool launch_format(const Args& a, int per_byte, int group_size, int mt, int vec) {
  if (per_byte == 2 && group_size == 32) return launch_tile<2, 32, I8>(a, mt, vec);  // Q4_K
  if (per_byte == 2 && group_size == 16) return launch_tile<2, 16, I8>(a, mt, vec);  // Q2/Q3_K
  if (per_byte == 1 && group_size == 32) return launch_tile<1, 32, I8>(a, mt, vec);  // Q5_K
  if (per_byte == 1 && group_size == 16) return launch_tile<1, 16, I8>(a, mt, vec);  // Q6_K
  return false;
}

}  // namespace

// Returns 0 on success, else a cudaError_t value (cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a format or tile this file
// does not instantiate). x is bf16 when x_bf16 != 0, else f32; the scale
// plane bf16 when scale_bf16 != 0, else f32; offc may be null; layout_i8
// selects the "i8" code layout. partials is (splits, M, d_out) f32 scratch
// when splits > 1, ignored otherwise. mt is the rows per block: 1, 2, 4, 8
// on the CUDA cores (and 32 with vec 1); 32, 64, 128 on the tensor cores
// (vec 4 only, which also needs a 16-byte-aligned x). vec 4 needs
// d_out % 4 == 0 and 16-byte-aligned planes. Every pointer is a device
// pointer of contiguous data.
extern "C" int gg_v4_matmul(const void* x, int x_bf16, const uint8_t* qs,
                            const void* scale, int scale_bf16, const float* offc,
                            float* partials, float* out, int M, int d_in,
                            int d_out, int per_byte, int group_size,
                            int layout_i8, int mt, int vec, int sg_per_split,
                            int splits, void* stream) {
  Args a{x, x_bf16, qs, scale, scale_bf16, offc, splits > 1 ? partials : out,
         M, d_in, d_out, sg_per_split, splits, static_cast<cudaStream_t>(stream)};
  const bool ok = layout_i8 ? launch_format<true>(a, per_byte, group_size, mt, vec)
                            : launch_format<false>(a, per_byte, group_size, mt, vec);
  return finish_launch(ok, partials, out, splits, static_cast<size_t>(M) * d_out, a.stream);
}
