// Paged flash-decode for Hopper (sm_90a): one query token per slot, attention
// read straight from block-table KV page pools. Built by
// gptq_gguf_tpu_torch/ops/cuda_build.py into a shared library with a plain C
// interface, bound with ctypes by gptq_gguf_tpu_torch/ops/paged_attention.py
// (paged_flash_decode, paged_flash_decode_q4).
//
// Replaces: gptq_gguf_tpu/ops/paged_attention.py::_kernel (bf16 / f32 pools,
// behind paged_flash_decode) and ::_kernel_q4 (combined int4 pools, behind
// paged_flash_decode_q4), which carry every decode step of the paged engine.
//
// Computes, for each slot b, kv head kv and each of the G query heads g of
// its group, over the positions pos in [0, length] (length = lengths[b], the
// query's own position) read through table[b, pos / page]:
//   s[pos]  = (scale * q[g]) . k[pos];  s = softcap * tanh(s / softcap) if set
//   masked  : pos > length, or pos <= length - window when a window is set
//   out[g]  = sum_pos softmax(s)[pos] * v[pos], the softmax denominator
//             joined by exp(sink[kv * G + g] - max) when sinks are given
// as an online softmax in f32 with the TPU kernel's constants and order
// (running max from -1e30, correction exp(m_old - m_new), out = acc /
// max(l, 1e-30)). Table entries of -1 (unassigned) read page 0, as the TPU
// kernel's jnp.maximum(table, 0): an idle slot (length 0) reads page 0 and
// its output is discarded; no index below 0 or past the pool ever reaches an
// address.
//
// int4 pools (mode 2) use the combined layout of the JAX package: codes
// (n_pages, nKV, page, hd) u8 with k's packed bytes in [0, hd/2) and v's
// after, each half split-nibble (feature j < hd/2 in the low nibble of byte
// j, feature j >= hd/2 in the high nibble of byte j - hd/2), value
// (nibble - 8) * scale; scales (n_pages, nKV, 2 * hd / 32, page) f32, k's
// groups first, positions last. The TPU kernel's zero-padded query planes
// and plane-space accumulation are Mosaic tiling workarounds: here each
// chunk is dequantized once into shared memory and runs the plain path.
//
// What bounds it: bytes. Each attended position leaves device memory once
// per kv head (2 * hd * 2 bytes bf16, hd + 2 * hd / 32 * 4 bytes int4) for
// ~4 * G * hd operations, far below the card's ~20 f32 operations per
// byte. Design (simple and right first):
//   * one block of 128 threads per (slot, kv head) with all G query heads of
//     the group in the block, so each page is read once per kv head; the
//     block reads lengths[b] and table[b, :] itself (no host readback);
//   * the block walks live pages p in [p_start, length / page] (pages wholly
//     below a sliding window are never read) in chunks of 32 positions,
//     loaded with 16-byte loads into shared memory as f32 (K rows padded to
//     hd + 1 floats: the 32 lanes of the score loop read 32 banks);
//   * scores: one thread per (head, position) pair; softmax: one warp per
//     head, one lane per position; P @ V: one thread per (head, feature).
// B * nKV blocks = 64 at Llama-3-8B widths and B = 8 fill half of the 132
// SMs, and a slot's pages are walked in order by one block. A later PR
// splits the pages of a slot over several blocks with a second reduction
// pass (flash-decoding), and overlaps the next chunk's loads (cp.async or
// TMA) with the current chunk's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // positions per chunk: one per lane in the softmax step
constexpr int kMaxG = 16;      // query heads per kv head
constexpr int kMaxPage = 256;
constexpr int kQ4Group = 32;   // int4 KV group size
constexpr float kNeg = -1e30f;

enum Mode { kF32 = 0, kBF16 = 1, kQ4 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// rows [0, live) of one chunk from a (rows, HD) tile of T into dst (row
// stride `stride` floats); rows [live, kChunk) become 0 so that no stale
// value meets a zero probability
template <int HD, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* dst, int stride,
                                          int live) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const int n_vec = live * HD / kVec;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 u = __ldg(s4 + i);
    const int e = i * kVec;
    float* o = dst + (e / HD) * stride + e % HD;
    const T* vals = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = to_f32(vals[j]);
  }
  for (int i = live * HD + threadIdx.x; i < kChunk * HD; i += kThreads) {
    dst[(i / HD) * stride + i % HD] = 0.f;
  }
}

// one chunk of the combined int4 pools, dequantized: codes is the
// (page, HD) u8 tile of (page id, kv head), scales its (2 * HD / 32, page)
// f32 tile; k_s rows have stride HD + 1, v_s rows HD
template <int HD>
__device__ __forceinline__ void load_q4(const uint8_t* __restrict__ codes,
                                        const float* __restrict__ scales, int page, int off,
                                        int live, float* k_s, float* v_s, float* sc_s) {
  constexpr int kNg = HD / kQ4Group;  // groups of one of k or v
  constexpr int kHalf = HD / 2;
  for (int i = threadIdx.x; i < 2 * kNg * kChunk; i += kThreads) {
    const int grp = i / kChunk, t = i % kChunk;
    sc_s[i] = t < live ? __ldg(scales + (size_t)grp * page + off + t) : 0.f;
  }
  __syncthreads();
  const uint4* c4 = reinterpret_cast<const uint4*>(codes + (size_t)off * HD);
  const int n_vec = live * HD / 16;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 u = __ldg(c4 + i);
    const int e = i * 16;
    const int r = e / HD, col = e % HD;  // 16 bytes inside one half of row r
    const bool is_k = col < kHalf;
    const int j0 = is_k ? col : col - kHalf;  // feature of the first low nibble
    float* dst = is_k ? k_s + r * (HD + 1) : v_s + r * HD;
    const float* sc = sc_s + (is_k ? 0 : kNg) * kChunk + r;
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = bytes[j];
      const int f_lo = j0 + j, f_hi = j0 + j + kHalf;
      dst[f_lo] = (float)((c & 0xF) - 8) * sc[(f_lo / kQ4Group) * kChunk];
      dst[f_hi] = (float)((c >> 4) - 8) * sc[(f_hi / kQ4Group) * kChunk];
    }
  }
  for (int i = live * HD + threadIdx.x; i < kChunk * HD; i += kThreads) {
    k_s[(i / HD) * (HD + 1) + i % HD] = 0.f;
    v_s[i] = 0.f;
  }
}

__device__ __forceinline__ bool in_mask(int pos, int length, int window) {
  return pos <= length && (window <= 0 || pos > length - window);
}

template <int HD, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const void* __restrict__ kpool,
                    const void* __restrict__ vpool, const int* __restrict__ table,
                    const int* __restrict__ lengths, const float* __restrict__ sinks,
                    float* __restrict__ out, int nKV, int G, int page, int pps, int n_pool,
                    float scale, int window, float softcap) {
  extern __shared__ float smem[];
  float* q_s = smem;                       // (G, HD), pre-scaled
  float* k_s = q_s + G * HD;               // (kChunk, HD + 1)
  float* v_s = k_s + kChunk * (HD + 1);    // (kChunk, HD)
  float* p_s = v_s + kChunk * HD;          // (G, kChunk): scores, then probabilities
  float* m_s = p_s + G * kChunk;           // (kMaxG) running max
  float* l_s = m_s + kMaxG;                // (kMaxG) running denominator
  float* c_s = l_s + kMaxG;                // (kMaxG) this chunk's correction
  float* sc_s = c_s + kMaxG;               // (2 * HD / 32, kChunk) int4 group scales

  const int b = blockIdx.x / nKV;
  const int kv = blockIdx.x % nKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int n_live = min(length / page + 1, pps);
  const int p_start = window > 0 ? max(length - window + 1, 0) / page : 0;

  const float* qb = q + ((size_t)b * nKV + kv) * G * HD;
  for (int i = tid; i < G * HD; i += kThreads) q_s[i] = qb[i] * scale;
  if (tid < kMaxG) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  constexpr int kPer = kMaxG * HD / kThreads;  // (head, feature) pairs per thread, at most
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  __syncthreads();

  const int* trow = table + (size_t)b * pps;
  for (int p = p_start; p < n_live; ++p) {
    const int pid = min(max(trow[p], 0), n_pool - 1);
    const size_t tile = (size_t)pid * nKV + kv;  // the (page id, kv head) tile
    for (int off = 0; off < page; off += kChunk) {
      const int pos0 = p * page + off;
      const int rows = min(kChunk, page - off);
      if (pos0 > length) break;                                      // past the query
      if (window > 0 && pos0 + rows - 1 <= length - window) continue;  // below the window
      const int live = min(rows, length - pos0 + 1);
      if constexpr (MODE == kQ4) {
        load_q4<HD>(static_cast<const uint8_t*>(kpool) + tile * page * HD,
                    static_cast<const float*>(vpool) + tile * (2 * HD / kQ4Group) * page, page,
                    off, live, k_s, v_s, sc_s);
      } else {
        using T = typename std::conditional<MODE == kBF16, __nv_bfloat16, float>::type;
        const size_t row0 = tile * page + off;
        load_rows<HD, T>(static_cast<const T*>(kpool) + row0 * HD, k_s, HD + 1, live);
        load_rows<HD, T>(static_cast<const T*>(vpool) + row0 * HD, v_s, HD, live);
      }
      __syncthreads();

      // scores, softcapped before masking (the HF / TPU-kernel order)
      for (int i = tid; i < G * kChunk; i += kThreads) {
        const int g = i / kChunk, t = i % kChunk;
        const float* qr = q_s + g * HD;
        const float* kr = k_s + t * (HD + 1);
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
        if (softcap != 0.f) s = softcap * tanhf(s * (1.f / softcap));
        p_s[i] = (t < rows && in_mask(pos0 + t, length, window)) ? s : kNeg;
      }
      __syncthreads();

      // online softmax: warp w owns heads w, w + 4, ...; lane t owns position t
      const bool valid = lane < rows && in_mask(pos0 + lane, length, window);
      for (int g = warp; g < G; g += kWarps) {
        const float s = p_s[g * kChunk + lane];
        float mx = s;
#pragma unroll
        for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        const float pr = valid ? expf(s - m_new) : 0.f;
        float sum = pr;
#pragma unroll
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        p_s[g * kChunk + lane] = pr;
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * corr + P @ V, one (head, feature) pair per thread and step
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kThreads;
        if (i < G * HD) {
          const int g = i / HD, d = i % HD;
          const float* pr = p_s + g * kChunk;
          float a = 0.f;
#pragma unroll 8
          for (int t = 0; t < kChunk; ++t) a = fmaf(pr[t], v_s[t * HD + d], a);
          acc[k] = acc[k] * c_s[g] + a;
        }
      }
      __syncthreads();  // the next chunk overwrites k_s, v_s and p_s
    }
  }

  float* ob = out + ((size_t)b * nKV + kv) * G * HD;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < G * HD) {
      const int g = i / HD;
      float l = l_s[g];
      if (sinks != nullptr) l += expf(sinks[kv * G + g] - m_s[g]);  // sink mass
      ob[i] = acc[k] / fmaxf(l, 1e-30f);
    }
  }
}

template <int HD, int MODE>
int launch(const float* q, const void* kpool, const void* vpool, const int* table,
           const int* lengths, const float* sinks, float* out, int B, int nKV, int G, int page,
           int pps, int n_pool, float scale, int window, float softcap, cudaStream_t stream) {
  const size_t floats = (size_t)G * HD + kChunk * (HD + 1) + kChunk * HD + G * kChunk +
                        3 * kMaxG + (MODE == kQ4 ? 2 * HD / kQ4Group * kChunk : 0);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<HD, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<HD, MODE><<<B * nKV, kThreads, smem, stream>>>(
      q, kpool, vpool, table, lengths, sinks, out, nKV, G, page, pps, n_pool, scale, window,
      softcap);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_hd(int hd, const float* q, const void* kpool, const void* vpool, const int* table,
              const int* lengths, const float* sinks, float* out, int B, int nKV, int G,
              int page, int pps, int n_pool, float scale, int window, float softcap,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, MODE>(q, kpool, vpool, table, lengths, sinks, out, B, nKV, G, page, pps,
                              n_pool, scale, window, softcap, stream);
    case 128:
      return launch<128, MODE>(q, kpool, vpool, table, lengths, sinks, out, B, nKV, G, page,
                               pps, n_pool, scale, window, softcap, stream);
    case 192:
      return launch<192, MODE>(q, kpool, vpool, table, lengths, sinks, out, B, nKV, G, page,
                               pps, n_pool, scale, window, softcap, stream);
    case 256:
      return launch<256, MODE>(q, kpool, vpool, table, lengths, sinks, out, B, nKV, G, page,
                               pps, n_pool, scale, window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode 0: f32 pools, 1: bf16 pools (k_pool, v_pool); 2: combined int4 pools
// (k_pool = codes, v_pool = scales). q (B, nKV, G, hd) f32, out the same;
// table (B, pps) and lengths (B,) int32; sinks (nKV * G,) f32 or null;
// n_pool the pools' leading extent. Returns 0 or the CUDA error of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take). Asynchronous
// on ``stream``.
extern "C" int gg_paged_flash_decode(const float* q, const void* k_pool, const void* v_pool,
                                     int mode, const int* table, const int* lengths,
                                     const float* sinks, float* out, int B, int nKV, int G,
                                     int hd, int page, int pps, int n_pool, float scale,
                                     int window, float softcap, cudaStream_t stream) {
  if (B < 1 || nKV < 1 || G < 1 || G > kMaxG || hd % 64 != 0 || hd < 64 || hd > 256 ||
      page < 1 || page > kMaxPage || pps < 1 || n_pool < 1) {
    return (int)cudaErrorInvalidValue;
  }
  switch (mode) {
    case kF32:
      return launch_hd<kF32>(hd, q, k_pool, v_pool, table, lengths, sinks, out, B, nKV, G, page,
                             pps, n_pool, scale, window, softcap, stream);
    case kBF16:
      return launch_hd<kBF16>(hd, q, k_pool, v_pool, table, lengths, sinks, out, B, nKV, G,
                              page, pps, n_pool, scale, window, softcap, stream);
    case kQ4:
      return launch_hd<kQ4>(hd, q, k_pool, v_pool, table, lengths, sinks, out, B, nKV, G, page,
                            pps, n_pool, scale, window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
