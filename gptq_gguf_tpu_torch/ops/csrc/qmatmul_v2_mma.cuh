// Tensor-core prefill path of the per-weight v2 dequant-matmul kernels, for
// Hopper (sm_90a). The same function as the CUDA-core template in
// qmatmul_v2_weight.cuh, for bf16 operands at M >= 9 rows (every call past
// the decode tiles; qmatmul.MMA_MIN_ROWS):
//   y (M, d_out) f32 = bf16(x) @ w  [ - xsum @ off2 ]   (f32 sums)
// with w the build's bf16 weight from the same group_affine / weight
// functions (so bit for bit the decode kernel's, and the JAX bodies'), and
// xsum the f32 group sums of the un-rounded x. Only the order of the f32
// sums differs.
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
// What bounds it: operations from M ~ 300 up (Llama-3-8B gate/up at M =
// 1024: 240 GFLOP against 66 MB of planes and x), bytes below. The CUDA-core
// tiles it replaces ran every weight through M f32 FMAs at 25-29 TFLOP/s
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
//     row-major, 16-byte copies) and its raw planes (codes, sc_q, mn_q, one
//     d_sg / dmin_sg row: 16-byte copies, 4-byte ones when d_out % 16 != 0)
//     while the previous steps compute; f32 x is loaded through registers
//     and rounded to bf16 as it is stored, its group sums taken on the way;
//   * two blocks per SM (__launch_bounds__(256, 2): 110 KB of shared memory
//     each, at most 128 registers a thread; the 128-row tiles spill 84-200
//     bytes of stores, 152-436 of loads): while one block dequantizes, the
//     other's warps keep the tensor cores busy. On an H100 (700 W) this ran one Llama-3-8B
//     forward at M = 1024 in 109 ms against 131 ms at one block per SM;
//     16 warps of 32 x 32 in one 512-thread block took 146 ms, and a
//     double-buffered weight tile with one barrier per step 125 ms
//     (tools/time_v2_kernels.py, PERF.md);
//   * the block's threads dequantize the step's codes once into a bf16
//     k-major [64][128] tile, so each weight is dequantized M / BM times
//     (M / 32 on the CUDA-core tiles); fragments come by ldmatrix.x4 (x) and
//     ldmatrix.x4.trans (weights); rows padded by 16 bytes so an ldmatrix's
//     8 rows hit distinct banks;
//   * xsum @ off2 (v2g, v3) is subtracted from the accumulator fragments in
//     f32 on the CUDA cores after each step's products: K / gs FMAs per
//     output, 1/32 (Q4_K) or 1/16 (Q6_K) of the main work, at a fifteenth of
//     the tensor cores' rate;
//   * split-K over supergroups into the partial buffer, reduced in a fixed
//     order (finish_launch): no float atomics, reproducible run to run;
//   * ragged M rows are zero-filled and not stored; columns past d_out are
//     zero-filled and not stored.
// Next step: wgmma with TMA loads, a producer warp dequantizing straight
// into the wgmma B layout, persistent blocks.

#pragma once

#include "qmatmul_v2_weight.cuh"

namespace {

constexpr int kMmaThreads = 256;      // 8 warps: 2 along M x 4 along N
constexpr int kMmaBN = 128;           // output columns per block
constexpr int kMmaKT = 64;            // weight rows per pipeline step
constexpr int kMmaStages = 3;         // cp.async ring depth
constexpr int kAStride = kMmaKT + 8;  // bf16 per staged x row (144 B)
constexpr int kBStride = kMmaBN + 8;  // bf16 per weight-tile row (272 B)

// shared-memory layout of one block: kMmaStages stages, then the bf16 weight
// tile and the step's off2 (every offset a multiple of 16 bytes)
template <int PB, int GS, int BM>
struct MmaTile {
  static constexpr int GPK = kMmaKT / GS;  // groups per step
  static constexpr int CODE_ROWS = kMmaKT / PB;
  static constexpr int X_OFF = 0;
  static constexpr int Q_OFF = X_OFF + BM * kAStride * 2;
  static constexpr int SC_OFF = Q_OFF + CODE_ROWS * kMmaBN;
  static constexpr int MN_OFF = SC_OFF + GPK * kMmaBN;
  static constexpr int D_OFF = MN_OFF + GPK * kMmaBN;
  static constexpr int DMIN_OFF = D_OFF + kMmaBN * 4;
  static constexpr int G_OFF = DMIN_OFF + kMmaBN * 4;  // xsum [BM][GPK] f32
  static constexpr int STAGE = G_OFF + BM * GPK * 4;
  static constexpr int W_OFF = kMmaStages * STAGE;      // [kMmaKT][kBStride] bf16
  static constexpr int O2_OFF = W_OFF + kMmaKT * kBStride * 2;  // [GPK][kMmaBN] f32
  static constexpr int BYTES = O2_OFF + GPK * kMmaBN * 4;
  static_assert(STAGE % 16 == 0 && W_OFF % 16 == 0 && O2_OFF % 16 == 0, "alignment");
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

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the supergroup-relative row of step-local weight row kk in quarter q:
// 4-bit codes take rows 32q.. (low nibbles) and 128 + 32q.. (high nibbles)
template <int PB>
__device__ __forceinline__ int k_in_sg(int kk, int q) {
  if constexpr (PB == 2) return kk < 32 ? 32 * q + kk : kHalf + 32 * q + kk - 32;
  else return kMmaKT * q + kk;
}

// rows x 128 bytes of a plane into shared memory (row r from row_src(r)),
// zero past the last column: 16-byte copies when every row start is
// 16-byte aligned (d_out % 16 == 0), 4-byte ones otherwise (d_out % 4 == 0)
template <class RowSrc>
__device__ __forceinline__ void stage_rows(char* dst, int rows, int cols_left, bool w16,
                                           RowSrc row_src) {
  if (w16) {
    for (int i = threadIdx.x; i < rows * 8; i += kMmaThreads) {
      const int r = i / 8, j = i % 8;
      const uint8_t* src = row_src(r);
      const bool in = 16 * j < cols_left;
      cp_async16(dst + r * kMmaBN + 16 * j, in ? src + 16 * j : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * 32; i += kMmaThreads) {
      const int r = i / 32, j = i % 32;
      const uint8_t* src = row_src(r);
      const bool in = 4 * j < cols_left;
      cp_async4(dst + r * kMmaBN + 4 * j, in ? src + 4 * j : src, in);
    }
  }
}

template <int BUILD, int PB, int GS, bool HAS_MIN, int BM>
__global__ void __launch_bounds__(kMmaThreads, 2) v2_mma_kernel(V2Args a) {
  using T = MmaTile<PB, GS, BM>;
  constexpr int GPK = T::GPK;
  constexpr int GPSG = kQK / GS;         // groups per supergroup
  constexpr int QUARTERS = kQK / kMmaKT;
  constexpr int WM = BM / 2;             // warp tile rows
  constexpr int MI = WM / 16;            // m16 tiles per warp
  constexpr int NI = 4;                  // n8 tiles per warp (32 columns)
  constexpr bool XSUM = corrects(BUILD);
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
  const float* xf = static_cast<const float*>(a.x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + T::W_OFF);
  float* o2s = reinterpret_cast<float*>(smem + T::O2_OFF);

  // step t's x tile and raw planes into stage t % kMmaStages
  auto issue = [&](int t) {
    char* st = smem + (t % kMmaStages) * T::STAGE;
    const int sg = sg_begin + t / QUARTERS, q = t % QUARTERS;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + T::X_OFF);
    float* xg = reinterpret_cast<float*>(st + T::G_OFF);
    for (int i = threadIdx.x; i < BM * 8; i += kMmaThreads) {  // BM * 8 % 256 == 0
      const int r = i / 8, c = i % 8, row = m0 + r;
      const bool in = row < a.M;
      const size_t src = static_cast<size_t>(in ? row : 0) * a.d_in +
                         static_cast<size_t>(sg) * kQK + k_in_sg<PB>(8 * c, q);
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
        if constexpr (XSUM) {  // a group's GS / 8 chunks lie in adjacent lanes
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) s += v[j];
#pragma unroll
          for (int o = 1; o < GS / 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (c % (GS / 8) == 0) xg[r * GPK + 8 * c / GS] = s;
        }
      }
    }
    const uint8_t* qsrc = a.qs + (static_cast<size_t>(sg) * (kQK / PB) + T::CODE_ROWS * q) * ldo + n0;
    stage_rows(st + T::Q_OFF, T::CODE_ROWS, cols_left, w16,
               [&](int r) { return qsrc + r * ldo; });
    auto group_row = [&](const uint8_t* plane) {
      return [=](int lg) {
        const int g = sg * GPSG + k_in_sg<PB>(lg * GS, q) / GS;
        return plane + static_cast<size_t>(g) * ldo + n0;
      };
    };
    stage_rows(st + T::SC_OFF, GPK, cols_left, w16, group_row(a.sc_q));
    if (HAS_MIN) stage_rows(st + T::MN_OFF, GPK, cols_left, w16, group_row(a.mn_q));
    for (int i = threadIdx.x; i < (HAS_MIN ? 64 : 32); i += kMmaThreads) {
      const int j = i % 32;
      const float* plane = i < 32 ? a.d_sg : a.dmin_sg;
      const float* src = plane + static_cast<size_t>(sg) * a.d_rep * ldo + n0;
      const bool in = 4 * j < cols_left;
      cp_async16(st + (i < 32 ? T::D_OFF : T::DMIN_OFF) + 16 * j, in ? src + 4 * j : src, in);
    }
  };

  // step t's weights dequantized into the bf16 tile, its off2 and (bf16 x)
  // its group sums
  auto build = [&](int t) {
    const char* st = smem + (t % kMmaStages) * T::STAGE;
    const float* dsg = reinterpret_cast<const float*>(st + T::D_OFF);
    const float* dmn = reinterpret_cast<const float*>(st + T::DMIN_OFF);
    const int n = 4 * (threadIdx.x % 32);  // 4 columns per thread
    const int slice = threadIdx.x / 32;     // 8 row slices
    float d[4], dmin[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[c] = dsg[n + c];
      dmin[c] = HAS_MIN ? dmn[n + c] : 0.f;
    }
    auto affine = [&](int lg, Affine (&f)[4]) {
      const uint32_t scw = *reinterpret_cast<const uint32_t*>(st + T::SC_OFF + lg * kMmaBN + n);
      const uint32_t mnw =
          HAS_MIN ? *reinterpret_cast<const uint32_t*>(st + T::MN_OFF + lg * kMmaBN + n) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = d[c] * scale_code<!HAS_MIN>(scw, c);
        const float o2 = HAS_MIN ? dmin[c] * static_cast<float>((mnw >> (8 * c)) & 0xFFu)
                                 : s * a.shift;
        f[c] = group_affine<BUILD, true, HAS_MIN>(s, o2, a.shift);
      }
    };
    auto store = [&](int kk, const float (&v)[4]) {
      *reinterpret_cast<uint2*>(ws + kk * kBStride + n) =
          make_uint2(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]));
    };
    if constexpr (PB == 2) {  // 32 code rows: 4 per slice, one group each half
      Affine f_lo[4], f_hi[4];
      affine(4 * slice / GS, f_lo);
      affine((32 + 4 * slice) / GS, f_hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * slice + i;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(st + T::Q_OFF + r * kMmaBN + n);
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = weight<BUILD, true, HAS_MIN>(f_lo[c], (w >> (8 * c)) & 0xFu);
          hi[c] = weight<BUILD, true, HAS_MIN>(f_hi[c], (w >> (8 * c + 4)) & 0xFu);
        }
        store(r, lo);
        store(32 + r, hi);
      }
    } else {  // 64 code rows: 8 per slice, one group
      Affine f[4];
      affine(8 * slice / GS, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * slice + i;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(st + T::Q_OFF + r * kMmaBN + n);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = weight<BUILD, true, HAS_MIN>(f[c], (w >> (8 * c)) & 0xFFu);
        store(r, v);
      }
    }
    if constexpr (XSUM) {
      for (int i = threadIdx.x; i < GPK * kMmaBN; i += kMmaThreads) {  // [lg][col]
        const int col = i % kMmaBN;
        const uint8_t* b = reinterpret_cast<const uint8_t*>(st);
        o2s[i] = HAS_MIN ? dmn[col] * static_cast<float>(b[T::MN_OFF + i])
                         : dsg[col] * scale_code<true>(b[T::SC_OFF + i], 0) * a.shift;
      }
      if (a.x_bf16) {  // group sums of the staged bf16 x (its own values)
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::X_OFF);
        float* xg = reinterpret_cast<float*>(const_cast<char*>(st) + T::G_OFF);
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
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // step t's products (and its xsum term) into the accumulators
  auto product = [&](int t) {
    const char* st = smem + (t % kMmaStages) * T::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::X_OFF);
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
    if constexpr (XSUM) {
      const float* xg = reinterpret_cast<const float*>(st + T::G_OFF);
#pragma unroll
      for (int lg = 0; lg < GPK; ++lg) {
        float xr[MI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) xr[mi][h] = xg[(wm * WM + mi * 16 + lane / 4 + 8 * h) * GPK + lg];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const float2 o = *reinterpret_cast<const float2*>(o2s + lg * kMmaBN + wn * 32 + ni * 8 +
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

template <int BUILD, int PB, int GS, bool HAS_MIN, int BM>
void launch_mma_tile(const V2Args& a) {
  constexpr int bytes = MmaTile<PB, GS, BM>::BYTES;
  auto kernel = v2_mma_kernel<BUILD, PB, GS, HAS_MIN, BM>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((a.d_out + kMmaBN - 1) / kMmaBN, (a.M + BM - 1) / BM, a.splits);
  kernel<<<grid, kMmaThreads, bytes, a.stream>>>(a);
}

// the tile of bm rows per block (32, 64 or 128); false for another bm
template <int BUILD, int PB, int GS, bool HAS_MIN>
bool launch_mma(const V2Args& a, int bm) {
  switch (bm) {
    case 32: launch_mma_tile<BUILD, PB, GS, HAS_MIN, 32>(a); return true;
    case 64: launch_mma_tile<BUILD, PB, GS, HAS_MIN, 64>(a); return true;
    case 128: launch_mma_tile<BUILD, PB, GS, HAS_MIN, 128>(a); return true;
    default: return false;
  }
}

}  // namespace
