// Fused K-quant dequant + matmul over the v2 runtime format, for Hopper
// (sm_90a). Built by gptq_gguf_tpu_torch/ops/cuda_build.py into a shared
// library with a plain C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmatmul.py::dequant_matmul_v2g.
//
// Replaces: gptq_gguf_tpu/ops/qmatmul.py::_kernel_v2g (the Pallas kernel
// behind dequant_matmul_pallas_v2 with variant "v2g"), which carries every
// projection and the lm_head of the serving path.
//
// Computes, for x (M, d_in) f32 or bf16 and one v2-packed weight:
//   y (M, d_out) f32 = bf16(x) @ bf16(scale * q)  -  xsum @ off2
//   scale[g, n] = d_sg[d_rep * (g / gpsg), n] * f32(sc_q[g, n])   (exact: 17-bit product)
//   q           = the raw unsigned code (no shift)
//   off2[g, n]  = dmin_sg[...] * f32(mn_q[g, n])   (types with a min)
//               = scale[g, n] * shift              (signed Q3_K / Q6_K)
//   xsum[m, g]  = f32 sum of the UN-rounded x over group g
// scale * q is exact in f32, so the bf16 weight equals the JAX kernel's bit
// for bit; only the order of the f32 sums differs.
//
// What bounds it: bytes. At decode (M <= 8) each packed weight byte feeds
// at most 2 * M multiply-adds, far below the ~295 flop/byte the H100 needs
// before compute matters. One Llama-3-8B decoder layer at Q4_K holds
// 136,314,880 bytes of qs plus scale planes, of which this kernel reads
// 129,499,136 once per decode step: d_sg / dmin_sg hold each supergroup's
// row d_rep = 2 times (a TPU tiling rule) and only row d_rep * sg is read.
//
// Design (CUDA cores, f32 accumulation; wgmma / TMA are later work):
//   * each thread owns VEC = 4 adjacent output columns and reads one 32-bit
//     word per weight row, so a warp reads 128 contiguous bytes per row
//     (VEC = 1 for a d_out that is not a multiple of 4);
//   * x is staged in shared memory one 256-row supergroup at a time for MT
//     rows, rounded to bf16 (round to nearest even, like JAX's astype) and
//     laid out k-major so one vector load fetches a row's MT values; the
//     group sums xsum of the un-rounded x are taken while staging;
//   * codes become floats by the 2^23 magic-number trick and pairs of
//     weights are rounded to bf16 by one packed conversion, keeping the
//     slow int-to-float unit out of the inner loop;
//   * at decode the block's 4 warps split each supergroup's rows four ways
//     and add their partial sums through shared memory in a fixed order;
//     d_out = 4096 still gives few blocks, so the wrapper also splits the
//     K axis over supergroups (gridDim.z) and a second kernel reduces those
//     partials in a fixed order (no float atomics): token streams stay
//     reproducible run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQK = 256;       // rows per supergroup
constexpr int kHalf = 128;     // nibble split: byte k holds rows k and k+128
constexpr int kThreads = 128;  // threads per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// exact float of a small unsigned integer without the int-to-float unit
__device__ __forceinline__ float small_u2f(uint32_t q) {
  return __uint_as_float(0x4B000000u | q) - 8388608.f;
}

// round two f32 to bf16 (nearest even) in one packed conversion
__device__ __forceinline__ void bf16_round2(float& a, float& b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  a = __low2float(p);
  b = __high2float(p);
}

template <int VEC>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (VEC == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  else return __ldg(p);
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// the MT staged x values of one row k (k-major tile), by 16-byte loads
template <int MT>
__device__ __forceinline__ void load_x(const float* p, float (&v)[MT]) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i) v[i] = p[i];
  }
}

// byte c of a loaded word as the group's scale code (int8 for signed types)
template <bool SIGNED>
__device__ __forceinline__ float scale_code(uint32_t w, int c) {
  const uint32_t b = (w >> (8 * c)) & 0xFFu;
  return SIGNED ? static_cast<float>(static_cast<int8_t>(b)) : static_cast<float>(b);
}

// MT rows x (kThreads / KS * VEC) columns per block; KS warps-slices split
// each supergroup's rows when MT is small (decode), 1 otherwise.
template <int MT>
struct Slices {
  static constexpr int KS = MT <= 8 ? 4 : 1;
};

template <typename XT, int PB, int GS, bool HAS_MIN, int MT, int VEC>
__global__ void __launch_bounds__(kThreads) v2g_kernel(
    const XT* __restrict__ x,           // (M, d_in)
    const uint8_t* __restrict__ qs,     // (d_in / PB, d_out)
    const float* __restrict__ d_sg,     // (d_rep * n_sg, d_out)
    const float* __restrict__ dmin_sg,  // (d_rep * n_sg, d_out) or null
    const uint8_t* __restrict__ sc_q,   // (d_in / GS, d_out) u8 or i8 bytes
    const uint8_t* __restrict__ mn_q,   // (d_in / GS, d_out) or null
    float* __restrict__ out,            // (gridDim.z, M, d_out)
    int M, int d_in, int d_out, int d_rep, float shift, int sg_per_split) {
  constexpr int KS = Slices<MT>::KS;
  constexpr int COLT = kThreads / KS;  // column threads per slice
  constexpr int GPSG = kQK / GS;       // groups per supergroup
  constexpr int GPS = GPSG / KS;       // groups per slice (PB == 1)
  constexpr int PPS = GPSG / 2 / KS;   // low/high group pairs per slice (PB == 2)
  static_assert(PB == 1 ? GPS * KS == GPSG : PPS * KS * 2 == GPSG, "slices");
  __shared__ __align__(16) float xs[kQK * MT];   // k-major: xs[k * MT + m]
  __shared__ float xg[MT * GPSG];                // xsum of this supergroup
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

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  for (int sg = sg_begin; sg < sg_end; ++sg) {
    __syncthreads();  // the previous supergroup's tile is fully consumed
    // stage: one (row, group) per task; group sums of the raw x, tile in bf16
    for (int t = threadIdx.x; t < MT * GPSG; t += kThreads) {
      const int m = t / GPSG, g = t % GPSG, row = m0 + m;
      const XT* src = x + static_cast<size_t>(row) * d_in + static_cast<size_t>(sg) * kQK + g * GS;
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < GS; ++j) {
        const float v = row < M ? to_f32(src[j]) : 0.f;
        s += v;
        xs[(g * GS + j) * MT + m] = bf16_round(v);
      }
      xg[m * GPSG + g] = s;
    }
    __syncthreads();
    if (!live) continue;

    float d[VEC], dmin[VEC];
    const size_t sg_row = static_cast<size_t>(sg) * d_rep * ldo + n0;
    load_f32<VEC>(d_sg + sg_row, d);
    if (HAS_MIN) load_f32<VEC>(dmin_sg + sg_row, dmin);

    // one group: its scales, its offset term, then GS rows of codes
    auto group_scales = [&](int g, float (&s)[VEC], float (&o)[VEC]) {
      const size_t gi = static_cast<size_t>(sg * GPSG + g) * ldo + n0;
      const uint32_t scw = load_bytes<VEC>(sc_q + gi);
      const uint32_t mnw = HAS_MIN ? load_bytes<VEC>(mn_q + gi) : 0u;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        s[c] = d[c] * scale_code<!HAS_MIN>(scw, c);
        o[c] = HAS_MIN ? dmin[c] * static_cast<float>((mnw >> (8 * c)) & 0xFFu) : s[c] * shift;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(-xg[m * GPSG + g], o[c], acc[m][c]);
    };

    if (PB == 2) {
      const uint8_t* qrow = qs + static_cast<size_t>(sg) * kHalf * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < PPS; ++p) {
        const int g = slice * PPS + p, g_hi = g + GPSG / 2;
        float s_lo[VEC], s_hi[VEC], o[VEC];
        group_scales(g, s_lo, o);
        group_scales(g_hi, s_hi, o);
#pragma unroll 8
        for (int j = 0; j < GS; ++j) {
          const int k = g * GS + j;
          const uint32_t w = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          float w_lo[VEC], w_hi[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            w_lo[c] = s_lo[c] * small_u2f((w >> (8 * c)) & 0xFu);
            w_hi[c] = s_hi[c] * small_u2f((w >> (8 * c + 4)) & 0xFu);
            bf16_round2(w_lo[c], w_hi[c]);
          }
          float xa[MT], xb[MT];
          load_x<MT>(xs + k * MT, xa);
          load_x<MT>(xs + (k + kHalf) * MT, xb);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[m][c] = fmaf(xa[m], w_lo[c], fmaf(xb[m], w_hi[c], acc[m][c]));
        }
      }
    } else {
      const uint8_t* qrow = qs + static_cast<size_t>(sg) * kQK * ldo + n0;
#pragma unroll 1
      for (int p = 0; p < GPS; ++p) {
        const int g = slice * GPS + p;
        float s[VEC], o[VEC];
        group_scales(g, s, o);
#pragma unroll 8
        for (int j = 0; j < GS; j += 2) {
          const int k = g * GS + j;
          const uint32_t w0 = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
          const uint32_t w1 = load_bytes<VEC>(qrow + static_cast<size_t>(k + 1) * ldo);
          float a[VEC], b[VEC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            a[c] = s[c] * small_u2f((w0 >> (8 * c)) & 0xFFu);
            b[c] = s[c] * small_u2f((w1 >> (8 * c)) & 0xFFu);
            bf16_round2(a[c], b[c]);
          }
          float xa[MT], xb[MT];
          load_x<MT>(xs + k * MT, xa);
          load_x<MT>(xs + (k + 1) * MT, xb);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[m][c] = fmaf(xa[m], a[c], fmaf(xb[m], b[c], acc[m][c]));
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

// out[i] = sum over z of part[z][i], always in the order z = 0, 1, ...
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int splits,
                                     size_t count) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[static_cast<size_t>(z) * count + i];
  out[i] = s;
}

struct Args {
  const void* x;
  const uint8_t* qs;
  const float* d_sg;
  const float* dmin_sg;
  const uint8_t* sc_q;
  const uint8_t* mn_q;
  float* dst;
  int M, d_in, d_out, d_rep;
  float shift;
  int sg_per_split, splits;
  cudaStream_t stream;
};

template <typename XT, int PB, int GS, bool HAS_MIN, int MT, int VEC>
void launch(const Args& a) {
  constexpr int cols = kThreads / Slices<MT>::KS * VEC;
  const dim3 grid((a.d_out + cols - 1) / cols, (a.M + MT - 1) / MT, a.splits);
  v2g_kernel<XT, PB, GS, HAS_MIN, MT, VEC><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const XT*>(a.x), a.qs, a.d_sg, a.dmin_sg, a.sc_q, a.mn_q,
      a.dst, a.M, a.d_in, a.d_out, a.d_rep, a.shift, a.sg_per_split);
}

// row tiles: MT in {1, 2, 4, 8, 16, 32} for VEC 4, {1, 8, 32} for VEC 1
template <typename XT, int PB, int GS, bool HAS_MIN>
bool launch_tile(const Args& a, int mt, int vec) {
  if (vec == 4) {
    switch (mt) {
      case 1: launch<XT, PB, GS, HAS_MIN, 1, 4>(a); return true;
      case 2: launch<XT, PB, GS, HAS_MIN, 2, 4>(a); return true;
      case 4: launch<XT, PB, GS, HAS_MIN, 4, 4>(a); return true;
      case 8: launch<XT, PB, GS, HAS_MIN, 8, 4>(a); return true;
      case 16: launch<XT, PB, GS, HAS_MIN, 16, 4>(a); return true;
      case 32: launch<XT, PB, GS, HAS_MIN, 32, 4>(a); return true;
      default: return false;
    }
  }
  if (vec == 1) {
    switch (mt) {
      case 1: launch<XT, PB, GS, HAS_MIN, 1, 1>(a); return true;
      case 8: launch<XT, PB, GS, HAS_MIN, 8, 1>(a); return true;
      case 32: launch<XT, PB, GS, HAS_MIN, 32, 1>(a); return true;
      default: return false;
    }
  }
  return false;
}

template <typename XT>
bool launch_format(const Args& a, int per_byte, int group_size, int has_min,
                   int mt, int vec) {
  if (per_byte == 2 && group_size == 32 && has_min)  // Q4_K
    return launch_tile<XT, 2, 32, true>(a, mt, vec);
  if (per_byte == 2 && group_size == 16 && has_min)  // Q2_K
    return launch_tile<XT, 2, 16, true>(a, mt, vec);
  if (per_byte == 2 && group_size == 16 && !has_min)  // Q3_K
    return launch_tile<XT, 2, 16, false>(a, mt, vec);
  if (per_byte == 1 && group_size == 32 && has_min)  // Q5_K
    return launch_tile<XT, 1, 32, true>(a, mt, vec);
  if (per_byte == 1 && group_size == 16 && !has_min)  // Q6_K
    return launch_tile<XT, 1, 16, false>(a, mt, vec);
  return false;
}

}  // namespace

// Returns 0 on success, else a cudaError_t value (cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a format or tile this file
// does not instantiate). x is bf16 when x_bf16 != 0, else f32. partials is
// (splits, M, d_out) f32 scratch when splits > 1, ignored otherwise. vec 4
// needs d_out % 4 == 0 and 16-byte-aligned planes. Every pointer is a device
// pointer of contiguous data.
extern "C" int gg_v2g_matmul(const void* x, int x_bf16, const uint8_t* qs,
                             const float* d_sg, const float* dmin_sg,
                             const uint8_t* sc_q, const uint8_t* mn_q,
                             float* partials, float* out, int M, int d_in,
                             int d_out, int per_byte, int group_size,
                             int has_min, int shift, int d_rep, int mt, int vec,
                             int sg_per_split, int splits, void* stream) {
  Args a{x, qs, d_sg, dmin_sg, sc_q, mn_q, splits > 1 ? partials : out,
         M, d_in, d_out, d_rep, static_cast<float>(shift), sg_per_split,
         splits, static_cast<cudaStream_t>(stream)};
  const bool ok = x_bf16
      ? launch_format<__nv_bfloat16>(a, per_byte, group_size, has_min, mt, vec)
      : launch_format<float>(a, per_byte, group_size, has_min, mt, vec);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    const size_t count = static_cast<size_t>(M) * d_out;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((count + threads - 1) / threads);
    reduce_splits_kernel<<<blocks, threads, 0, a.stream>>>(partials, out, splits, count);
  }
  return static_cast<int>(cudaGetLastError());
}
