// Device helpers shared by the dequant-matmul kernels (qmatmul_v1.cu,
// qmatmul_v2*.cu, qmatmul_v3.cu, qmatmul_v4.cu). Every source includes this
// header and compiles on its own; cuda_build.py hashes the headers of
// ops/csrc/ into each library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQK = 256;       // rows per supergroup
constexpr int kHalf = 128;     // nibble split: byte k holds rows k and k+128
constexpr int kThreads = 128;  // threads per block

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

// MT rows x (kThreads / KS * VEC) columns per block; KS warp-slices split
// each supergroup's rows when MT is small (decode), 1 otherwise.
template <int MT>
struct Slices {
  static constexpr int KS = MT <= 8 ? 4 : 1;
};

// The arguments of one v2-format launch (qmatmul_v2*.cu, qmatmul_v3.cu).
struct V2Args {
  const void* x;
  int x_bf16;
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

// The tail of every C entry point: cudaErrorInvalidValue when no kernel
// was instantiated for the request (launched false), else the split-K
// partials (splits > 1) reduced into out and cudaGetLastError().
inline int finish_launch(bool launched, const float* partials, float* out, int splits,
                         size_t count, cudaStream_t stream) {
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((count + threads - 1) / threads);
    reduce_splits_kernel<<<blocks, threads, 0, stream>>>(partials, out, splits, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
