// Tensor-core prefill mainloop of the dequant-matmul kernels, for Hopper
// (sm_90a): one kernel body, mma_kernel<F, BM>, for every runtime format
// whose weights are built per weight before the product. The format F is a
// policy type that stages a step's planes and dequantizes them; everything
// else is here. Instantiated with:
//   V2Mma<BUILD, PB, GS, HAS_MIN> (qmatmul_v2_mma.cuh): the per-weight v2
//       builds v2g / v2 / v3 / v2f / v2h (qmatmul_v2g.cu, qmatmul_v2.cu,
//       qmatmul_v3.cu);
//   V4Mma<PB, GS, I8> (qmatmul_v4.cu): the v4 bodies pb2, pb2_i8, pb1.
// Each computes, from M >= 9 rows (qmatmul.MMA_MIN_ROWS):
//   y (M, d_out) f32 = bf16(x) @ w  [ - xsum @ off ]   (f32 sums)
// with w the format's bf16 weight from the same helpers its CUDA-core
// decode kernel uses (so bit for bit the decode kernel's, and the JAX
// bodies'), off the format's per-group offset row, and xsum the f32 group
// sums of the un-rounded x. Only the order of the f32 sums differs.
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
//     memory each, at most 128 registers a thread; the 128-row v2 tiles
//     spill 84-200 bytes of stores, 152-436 of loads): while one block
//     dequantizes, the other's warps keep the tensor cores busy. On an H100
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
//     v4 with an offc plane) is subtracted from the accumulator fragments in
//     f32 on the CUDA cores after each step's products: K / gs FMAs per
//     output, 1/32 (gs 32) or 1/16 (gs 16) of the main work, at a fifteenth
//     of the tensor cores' rate;
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
// emitted otherwise), has_off(a) (whether this weight does), and, for its
// planes at byte P of a stage st, issue<P>(a, st, sg, q, n0, cols_left,
// w16), build<P>(a, st, ws, o2s) and offsets<P>(st, o2s) (the step's
// [GS-group][128] f32 offset rows).

#pragma once

#include "qmatmul_common.cuh"

namespace {

constexpr int kMmaThreads = 256;      // 8 warps: 2 along M x 4 along N
constexpr int kMmaBN = 128;           // output columns per block
constexpr int kMmaKT = 64;            // weight rows per pipeline step
constexpr int kMmaStages = 3;         // cp.async ring depth
constexpr int kAStride = kMmaKT + 8;  // bf16 per staged x row (144 B)
constexpr int kBStride = kMmaBN + 8;  // bf16 per weight-tile row (272 B)

// shared-memory layout of one block: kMmaStages stages (x tile, the
// format's planes, xsum), then the bf16 weight tile and the format's
// scratch (every offset a multiple of 16 bytes)
template <class F, int BM>
struct MmaTile {
  static constexpr int GPK = kMmaKT / F::GS;  // groups per step
  static constexpr int X_OFF = 0;
  static constexpr int P_OFF = X_OFF + BM * kAStride * 2;  // the format's planes
  static constexpr int G_OFF = P_OFF + F::PLANE_BYTES;     // xsum [BM][GPK] f32
  static constexpr int STAGE = G_OFF + BM * GPK * 4;
  static constexpr int W_OFF = kMmaStages * STAGE;              // [kMmaKT][kBStride] bf16
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

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// four adjacent weights of weight-tile row kk, rounded to bf16 (nearest even)
__device__ __forceinline__ void store_w4(__nv_bfloat16* ws, int kk, int n, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(ws + kk * kBStride + n) =
      make_uint2(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]));
}

// the supergroup-relative row of step-local weight row kk in quarter q:
// 4-bit codes take rows 32q.. (low nibbles) and 128 + 32q.. (high nibbles)
template <int PB>
__device__ __forceinline__ int k_in_sg(int kk, int q) {
  if constexpr (PB == 2) return kk < 32 ? 32 * q + kk : kHalf + 32 * q + kk - 32;
  else return kMmaKT * q + kk;
}

// rows x ROW_BYTES bytes of a plane into shared memory (row r from
// row_src(r)), zero from byte bytes_left of a row on: 16-byte copies when
// every row start is 16-byte aligned (w16), 4-byte ones otherwise
template <int ROW_BYTES = kMmaBN, class RowSrc>
__device__ __forceinline__ void stage_rows(char* dst, int rows, int bytes_left, bool w16,
                                           RowSrc row_src) {
  if (w16) {
    constexpr int C = ROW_BYTES / 16;
    for (int i = threadIdx.x; i < rows * C; i += kMmaThreads) {
      const int r = i / C, j = i % C;
      const uint8_t* src = row_src(r);
      const bool in = 16 * j < bytes_left;
      cp_async16(dst + r * ROW_BYTES + 16 * j, in ? src + 16 * j : src, in);
    }
  } else {
    constexpr int C = ROW_BYTES / 4;
    for (int i = threadIdx.x; i < rows * C; i += kMmaThreads) {
      const int r = i / C, j = i % C;
      const uint8_t* src = row_src(r);
      const bool in = 4 * j < bytes_left;
      cp_async4(dst + r * ROW_BYTES + 4 * j, in ? src + 4 * j : src, in);
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
    F::template issue<T::P_OFF>(a, st, sg, q, n0, cols_left, w16);
  };

  // step t's weights dequantized into the bf16 tile (and the format's
  // offset scratch), and (bf16 x) its group sums
  auto build = [&](int t) {
    char* st = smem + (t % kMmaStages) * T::STAGE;
    F::template build<T::P_OFF>(a, st, ws, o2s);
    if constexpr (F::XSUM) {
      if (F::has_off(a) && a.x_bf16) {  // group sums of the staged bf16 x (its own values)
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + T::X_OFF);
        float* xg = reinterpret_cast<float*>(st + T::G_OFF);
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
