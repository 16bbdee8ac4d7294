// Fused K-quant dequant + matmul over the v1 runtime format, for Hopper
// (sm_90a). Built by gptq_gguf_tpu_torch/ops/cuda_build.py into a shared
// library with a plain C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmatmul.py::dequant_matmul_v1.
//
// Replaces: gptq_gguf_tpu/ops/qmatmul.py::_kernel (the Pallas kernel behind
// dequant_matmul_pallas), which carries every projection and the lm_head
// when the runtime format is "v1".
//
// Computes, for x (M, d_in) f32 or bf16 and one v1-packed weight:
//   y (M, d_out) f32 = f32(x) @ (f32(q) * scale_t - offset_t)
//   q         = the raw unsigned code (Q3_K / Q6_K carry their shift in offset_t)
//   scale_t   = (n_groups, d_out) f32, offset_t = (n_groups, d_out) f32
// all in f32 with f32 accumulation on the CUDA cores (the JAX kernel's dot
// is f32 x f32): no TF32, no bf16. q * scale_t is exact in f32 (a 17-bit
// scale times a code of at most 6 bits), so the weight is one rounding of
// the subtraction, bit-equal to the plain version's; only the order of the
// f32 sums differs.
//
// What bounds it: bytes at decode. A Q4_K weight costs 0.75 bytes (half a
// byte of code plus two f32 planes per group of 32), Q6_K 1.5 bytes; each
// byte feeds at most 2 * M multiply-adds at M <= 8. At prefill (M in the
// hundreds) it is bound by f32 operations on the CUDA cores (67 TFLOP/s).
//
// Design (the structure of qmatmul_v2_weight.cuh; only the per-weight
// dequantization differs):
//   * each thread owns VEC = 4 adjacent output columns and reads one 32-bit
//     word per weight row, so a warp reads 128 contiguous bytes per row
//     (VEC = 1 for a d_out that is not a multiple of 4);
//   * x is staged in f32 in shared memory one 256-row supergroup at a time
//     for MT rows, k-major so one vector load fetches a row's MT values;
//   * codes become floats by the 2^23 magic-number trick;
//   * at decode the block's 4 warps split each supergroup's rows four ways
//     and add their partial sums through shared memory in a fixed order;
//     the wrapper also splits the K axis over supergroups (gridDim.z) and a
//     second kernel reduces those partials in a fixed order (no float
//     atomics): results are reproducible run to run.

#include "qmatmul_common.cuh"

namespace {

template <int PB, int GS, int MT, int VEC>
__global__ void __launch_bounds__(kThreads) v1_kernel(
    const void* __restrict__ x,          // (M, d_in) f32 or bf16
    int x_bf16,
    const uint8_t* __restrict__ qs,      // (d_in / PB, d_out)
    const float* __restrict__ scale_t,   // (d_in / GS, d_out)
    const float* __restrict__ offset_t,  // (d_in / GS, d_out)
    float* __restrict__ out,             // (gridDim.z, M, d_out)
    int M, int d_in, int d_out, int sg_per_split) {
  constexpr int KS = Slices<MT>::KS;
  constexpr int COLT = kThreads / KS;  // column threads per slice
  constexpr int GPSG = kQK / GS;       // groups per supergroup
  constexpr int GPS = GPSG / KS;       // groups per slice (PB == 1)
  constexpr int PPS = GPSG / 2 / KS;   // low/high group pairs per slice (PB == 2)
  static_assert(PB == 1 ? GPS * KS == GPSG : PPS * KS * 2 == GPSG, "slices");
  __shared__ __align__(16) float xs[kQK * MT];   // k-major: xs[k * MT + m]
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

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  for (int sg = sg_begin; sg < sg_end; ++sg) {
    __syncthreads();  // the previous supergroup's tile is fully consumed
    // stage the supergroup's 256 x values of MT rows, f32, k-major (thread
    // t writes xs[t]: no shared-memory bank conflicts)
    for (int t = threadIdx.x; t < MT * kQK; t += kThreads) {
      const int m = t % MT, k = t / MT, row = m0 + m;
      const size_t i = static_cast<size_t>(row) * d_in + static_cast<size_t>(sg) * kQK + k;
      float v = 0.f;
      if (row < M) v = x_bf16 ? __bfloat162float(xb[i]) : xf[i];
      xs[k * MT + m] = v;
    }
    __syncthreads();
    if (!live) continue;

    // one group's scale and offset planes
    auto group_planes = [&](int g, float (&s)[VEC], float (&o)[VEC]) {
      const size_t gi = static_cast<size_t>(sg * GPSG + g) * ldo + n0;
      load_f32<VEC>(scale_t + gi, s);
      load_f32<VEC>(offset_t + gi, o);
    };

    if (PB == 2) {
      const uint8_t* qrow = qs + static_cast<size_t>(sg) * kHalf * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < PPS; ++p) {
        const int g = slice * PPS + p, g_hi = g + GPSG / 2;
        float s_lo[VEC], o_lo[VEC], s_hi[VEC], o_hi[VEC];
        group_planes(g, s_lo, o_lo);
        group_planes(g_hi, s_hi, o_hi);
#pragma unroll 8
        for (int j = 0; j < GS; ++j) {
          const int k = g * GS + j;
          const uint32_t w = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          float w_lo[VEC], w_hi[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            // q * s is exact, so the fused form rounds once, as q * s - o does
            w_lo[c] = fmaf(small_u2f((w >> (8 * c)) & 0xFu), s_lo[c], -o_lo[c]);
            w_hi[c] = fmaf(small_u2f((w >> (8 * c + 4)) & 0xFu), s_hi[c], -o_hi[c]);
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
        float s[VEC], o[VEC];
        group_planes(g, s, o);
#pragma unroll 8
        for (int j = 0; j < GS; j += 2) {
          const int k = g * GS + j;
          const uint32_t w0 = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          const uint32_t w1 = load_bytes<VEC>(qrow + static_cast<size_t>(k + 1) * ldo);
          float a[VEC], b[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            a[c] = fmaf(small_u2f((w0 >> (8 * c)) & 0xFFu), s[c], -o[c]);
            b[c] = fmaf(small_u2f((w1 >> (8 * c)) & 0xFFu), s[c], -o[c]);
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
  const float* scale_t;
  const float* offset_t;
  float* dst;
  int M, d_in, d_out, sg_per_split, splits;
  cudaStream_t stream;
};

template <int PB, int GS, int MT, int VEC>
void launch(const Args& a) {
  constexpr int cols = kThreads / Slices<MT>::KS * VEC;
  const dim3 grid((a.d_out + cols - 1) / cols, (a.M + MT - 1) / MT, a.splits);
  v1_kernel<PB, GS, MT, VEC><<<grid, kThreads, 0, a.stream>>>(
      a.x, a.x_bf16, a.qs, a.scale_t, a.offset_t, a.dst, a.M, a.d_in, a.d_out,
      a.sg_per_split);
}

// row tiles: MT in {1, 2, 4, 8, 16, 32} for VEC 4, {1, 8, 32} for VEC 1
template <int PB, int GS>
bool launch_tile(const Args& a, int mt, int vec) {
  if (vec == 4) {
    switch (mt) {
      case 1: launch<PB, GS, 1, 4>(a); return true;
      case 2: launch<PB, GS, 2, 4>(a); return true;
      case 4: launch<PB, GS, 4, 4>(a); return true;
      case 8: launch<PB, GS, 8, 4>(a); return true;
      case 16: launch<PB, GS, 16, 4>(a); return true;
      case 32: launch<PB, GS, 32, 4>(a); return true;
      default: return false;
    }
  }
  if (vec == 1) {
    switch (mt) {
      case 1: launch<PB, GS, 1, 1>(a); return true;
      case 8: launch<PB, GS, 8, 1>(a); return true;
      case 32: launch<PB, GS, 32, 1>(a); return true;
      default: return false;
    }
  }
  return false;
}

}  // namespace

// Returns 0 on success, else a cudaError_t value (cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a format or tile this file
// does not instantiate). x is bf16 when x_bf16 != 0, else f32. partials is
// (splits, M, d_out) f32 scratch when splits > 1, ignored otherwise. vec 4
// needs d_out % 4 == 0 and 16-byte-aligned planes. Every pointer is a device
// pointer of contiguous data.
extern "C" int gg_v1_matmul(const void* x, int x_bf16, const uint8_t* qs,
                            const float* scale_t, const float* offset_t,
                            float* partials, float* out, int M, int d_in,
                            int d_out, int per_byte, int group_size, int mt,
                            int vec, int sg_per_split, int splits, void* stream) {
  Args a{x, x_bf16, qs, scale_t, offset_t, splits > 1 ? partials : out,
         M, d_in, d_out, sg_per_split, splits, static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (per_byte == 2 && group_size == 32) ok = launch_tile<2, 32>(a, mt, vec);       // Q4_K
  else if (per_byte == 2 && group_size == 16) ok = launch_tile<2, 16>(a, mt, vec);  // Q2_K, Q3_K
  else if (per_byte == 1 && group_size == 32) ok = launch_tile<1, 32>(a, mt, vec);  // Q5_K
  else if (per_byte == 1 && group_size == 16) ok = launch_tile<1, 16>(a, mt, vec);  // Q6_K
  return finish_launch(ok, partials, out, splits, static_cast<size_t>(M) * d_out, a.stream);
}
