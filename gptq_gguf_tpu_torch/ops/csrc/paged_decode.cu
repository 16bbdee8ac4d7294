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
// as an online softmax in f32 with the TPU kernel's constants (running max
// from -1e30, correction exp(m_old - m_new), out = acc / max(l, 1e-30)),
// the exponentials taken as exp2 of log2(e)-scaled scores (the same
// function). Table entries of -1 (unassigned) read page 0, as the TPU
// kernel's jnp.maximum(table, 0): an idle slot (length 0) reads page 0 and
// its output is discarded; no index below 0 or past the pool ever reaches an
// address. Pages wholly below a sliding window are never read.
//
// int4 pools (mode 2) use the combined layout of the JAX package: codes
// (n_pages, nKV, page, hd) u8 with k's packed bytes in [0, hd/2) and v's
// after, each half split-nibble (feature j < hd/2 in the low nibble of byte
// j, feature j >= hd/2 in the high nibble of byte j - hd/2), value
// (nibble - 8) * scale; scales (n_pages, nKV, 2 * hd / 32, page) f32, k's
// groups first, positions last. The TPU kernel's zero-padded query planes
// and plane-space accumulation are Mosaic tiling workarounds: here the
// codes are dequantized in registers as they enter the products.
//
// What bounds it: bytes. Each attended position leaves device memory once
// per kv head (2 * hd * 2 bytes bf16, hd + 2 * hd / 32 * 4 bytes int4) for
// ~4 * G * hd operations. Two things stood between the first version and
// that bound: too few blocks walking a slot's pages one after another, and
// ~74 CUDA-core instructions per position by count (a shuffle tree per
// head and position), which on their own took about as long as the
// loads. Design:
//   * flash-decoding. Pass 1, paged_split_kernel: grid (B * nKV,
//     n_split), 128 threads. Split s of a (slot, kv head) owns pages
//     [s * pps_split, (s + 1) * pps_split) of the slot's table and writes
//     a partial over its live positions: max m, denominator l and
//     unnormalised acc (G, hd), f32, to scratch the wrapper allocates. A
//     split past the slot's length or wholly below its window writes the
//     empty partial (m = -1e30, l = 0, acc = 0) and reads nothing. n_split comes from the
//     shapes alone (the wrapper's _split_plan); the kernel reads lengths
//     and the table itself, so the host never reads a device tensor.
//     Pass 2, paged_combine_kernel on the same stream, joins a (slot, kv
//     head)'s partials in split order 0, 1, ... (results repeat bit for
//     bit), adds the sink mass and divides. (The last split block of each
//     (slot, kv head) doing it, found by an atomic counter, ran as fast at
//     fill 300 and slower at 1900: PERF.md §6.)
//   * K and V staged in shared memory in their stored type (bf16 / f32
//     rows; u8 codes plus the rows' f32 group scales) by 16-byte cp.async
//     (4-byte for the scales, which need not be 16-byte aligned) in a ring
//     of two stages of up to 64 positions of one page (32 KB of bf16 at hd
//     128): the next chunk's loads fly while the current one is scored,
//     and rows outside the chunk's attended range are zero-filled (the
//     src-size 0 form), never read. cp.async over a bulk TMA copy: one
//     mechanism serves the contiguous bf16 / f32 rows, the strided int4
//     scale slice and the zero fill, and a build with the arithmetic taken
//     out moved the bytes about as fast as a plain torch.amax over them
//     (PERF.md §6): the copies are not what bounds it;
//   * tensor-core body (MmaBody: bf16 pools at hd 64 / 96 / 128 and int4
//     pools at hd 64 / 128, the serving path): the G <= 16 query heads of
//     a kv head on the M side of mma.sync m16n8k16, each warp 16 positions of the chunk; S = Q K^T,
//     then O += P V with P's accumulator fragments reused as the A operand.
//     q is staged once in three bf16 parts and P split in two, so the f32
//     sums keep f32's accuracy to ~1e-6; bf16 K / V and int4 (nibble - 8)
//     are exact bf16 operands, the int4 group scales applied in f32 (to
//     each 32-feature group's partial scores; folded into P for V's). int4
//     codes become bf16 in registers (0x4300 | nibble is 128 + nibble), no
//     shared f32 tile. ~17 instructions per position by count. A staged
//     bf16 row spans a power of two of 16-byte pieces (hd 96: 12 pieces
//     padded to 16), so the XOR swizzle of a piece by its row's low three
//     bits stays inside the row;
//   * CUDA-core body (CoreBody: f32 pools, and bf16 / int4 at hd 192 /
//     256): four query heads per warp, q and acc in registers, hd / 8 lanes per position and a
//     shuffle reduction per head, for the shapes the tensor-core body's
//     registers do not take;
//   * warps meet once per chunk (the ring's barrier) and join their
//     softmax states once per split.
// Shape limits: hd 64, 96 (bf16 / f32 pools), 128, 192 or 256; G <= 16;
// page <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;      // query heads a warp holds (a head group)
constexpr int kF = 8;          // features a lane holds of each row and head
constexpr int kStages = 2;     // cp.async ring
constexpr int kU = 2;          // passes a warp runs at once (independent chains)
constexpr int kMinBlocks = 3;  // blocks per SM the register budget keeps room for
constexpr int kStageBytes = 32768;  // bf16 / f32 K + V of one stage, at most
constexpr int kQ4Chunk = 64;   // int4 positions per stage
constexpr int kMaxG = 16;      // query heads per kv head
constexpr int kMaxSplit = 64;  // page ranges per slot
constexpr int kCombineThreads = 512;
constexpr int kMaxPage = 256;
constexpr int kQ4Group = 32;   // int4 KV group size
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { kF32 = 0, kBF16 = 1, kQ4 = 2 };

constexpr int pow2_floor(int x) { return x < 2 ? 1 : 2 * pow2_floor(x / 2); }
constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }
constexpr int clamp_int(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// the shared-memory tile of one (HD, MODE) instance
template <int HD, int MODE>
struct Tile {
  // the tensor-core body takes bf16 and int4 pools at hd <= 128, the
  // CUDA-core body f32 pools and hd 192 / 256
  static constexpr bool MMA = MODE != kF32 && HD <= 128;
  static constexpr int LP = pow2_ceil(HD / kF);  // CUDA-core lanes per position (hd 192: 24 of 32)
  static constexpr int PP = 32 / LP;             // CUDA-core positions per warp and pass
  static constexpr int ELT = MODE == kF32 ? 4 : 2;
  static constexpr int GROW = HD * ELT;  // bytes of a bf16 / f32 row in the pool
  // positions per staged chunk: 64, or fewer so a stage of bf16 / f32 K + V stays 32 KB
  static constexpr int CH =
      MODE == kQ4 ? kQ4Chunk : clamp_int(pow2_floor(kStageBytes / (2 * HD * ELT)), 16, 64);
  static constexpr int NG = HD / kQ4Group;  // int4 scale groups of k (and of v)
  // bytes of one staged row: K or V (bf16 / f32; the tensor-core body's
  // 16-byte pieces XOR-swizzled by row, in a power of two of pieces so the
  // swizzle stays in the row); int4 codes, padded for the tensor-core body
  // so the 8 rows one LDS reads fall in different banks
  static constexpr int ROW =
      MODE == kQ4 ? HD + (MMA ? 16 : 0) : (MMA ? 16 * pow2_ceil(GROW / 16) : GROW);
  static constexpr int SCS = CH + 2;  // floats per staged scale group (bank spread)
  static constexpr int STAGE =
      MODE == kQ4 ? round16(CH * ROW + 2 * NG * SCS * 4) : 2 * CH * ROW;
  static constexpr int RED = kWarps * kMaxG * (HD + 2) * 4;  // the warps' softmax states
  static constexpr int RING = kStages * STAGE > RED ? kStages * STAGE : RED;
  static constexpr int SBUF = MMA ? 0 : kWarps * CH * 16;  // CUDA-core scores (CH, 4 heads)
  static constexpr int QROW = HD + 8;  // bf16 per staged q row (16-byte pad: ldmatrix banks)
  // bytes of shared memory for G query heads: the tensor-core body stages q
  // in three bf16 parts (3 G rows) and one zero row
  static constexpr int smem(int G) { return RING + SBUF + (MMA ? (3 * G + 1) * QROW * 2 : 0); }
  static_assert(!MMA || CH == kWarps * 16, "the tensor-core body takes 16 positions a warp");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
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

__device__ __forceinline__ uint32_t bf16x2_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as two bf16x2 parts, hi = bf16(x, y) and lo = bf16 of the rest:
// hi + lo carries 16 bits of each mantissa
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_u32(h);
  lo = bf16x2_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// w = byte a | byte b << 16 -> (nibble - 8) of both low nibbles and of both
// high nibbles as bf16x2, exactly: 0x4300 | n is the bf16 128 + n
__device__ __forceinline__ void nibbles_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 k136 = __float2bfloat162_rn(136.f);
  uint32_t a = (w & 0x000F000Fu) | 0x43004300u, b = ((w >> 4) & 0x000F000Fu) | 0x43004300u;
  lo = bf16x2_u32(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), k136));
  hi = bf16x2_u32(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), k136));
}

// feature of value i (of kF) a lane holds: bf16 8 contiguous; f32 and int4
// 4 in each half of the row
template <int HD, int MODE>
__device__ __forceinline__ int feature(int lig, int i) {
  if constexpr (MODE == kBF16) {
    return kF * lig + i;
  } else {
    return i < 4 ? 4 * lig + i : HD / 2 + 4 * lig + i - 4;
  }
}

// one chunk's positions: global chunk gc of the slot, attended rows [r_lo, r_hi)
struct Chunk {
  int page_idx, off, r_lo, r_hi;
};

template <int CH>
__device__ __forceinline__ Chunk chunk_at(int gc, int page, int lo_pos, int hi_pos) {
  const int cpp = (page + CH - 1) / CH;
  Chunk c;
  c.page_idx = gc / cpp;
  c.off = (gc % cpp) * CH;
  const int pos0 = c.page_idx * page + c.off;
  c.r_lo = max(lo_pos - pos0, 0);
  c.r_hi = min(min(CH, page - c.off), hi_pos - pos0 + 1);
  return c;
}

// queue the copies of one chunk into a stage; rows outside [r_lo, r_hi) are
// zero-filled without a read
template <int HD, int MODE>
__device__ __forceinline__ void issue_chunk(uint8_t* st, const void* kpool, const void* vpool,
                                            size_t tile, int page, const Chunk& c) {
  using TL = Tile<HD, MODE>;
  const int tid = threadIdx.x;
  if constexpr (MODE == kQ4) {
    constexpr int kPieces = HD / 16;  // 16-byte pieces of a row of codes
    const uint8_t* src = static_cast<const uint8_t*>(kpool) + (tile * page + c.off) * HD;
    for (int i = tid; i < TL::CH * kPieces; i += kThreads) {
      const int r = i / kPieces, p = i % kPieces;
      const bool ok = r >= c.r_lo && r < c.r_hi;
      cp_async16(st + r * TL::ROW + p * 16, ok ? src + r * HD + p * 16 : src, ok);
    }
    const float* ssrc = static_cast<const float*>(vpool) + tile * (2 * TL::NG) * page + c.off;
    float* sc = reinterpret_cast<float*>(st + TL::CH * TL::ROW);
    for (int i = tid; i < 2 * TL::NG * TL::CH; i += kThreads) {
      const int g = i / TL::CH, r = i % TL::CH;
      const bool ok = r >= c.r_lo && r < c.r_hi;
      cp_async4(sc + g * TL::SCS + r, ok ? ssrc + g * page + r : ssrc, ok);
    }
  } else {
    constexpr int kPieces = TL::GROW / 16;
    const size_t row0 = (tile * page + c.off) * TL::GROW;
#pragma unroll
    for (int which = 0; which < 2; ++which) {  // K rows, then V rows
      const uint8_t* src = static_cast<const uint8_t*>(which ? vpool : kpool) + row0;
      uint8_t* dst = st + which * TL::CH * TL::ROW;
      for (int i = tid; i < TL::CH * kPieces; i += kThreads) {
        const int r = i / kPieces, p = i % kPieces;
        const bool ok = r >= c.r_lo && r < c.r_hi;
        const int pd = TL::MMA ? p ^ (r & 7) : p;  // ldmatrix reads 8 rows bank-free
        cp_async16(dst + r * TL::ROW + pd * 16, ok ? src + r * TL::GROW + p * 16 : src, ok);
      }
    }
  }
}

// a lane's kF values of staged row r of K (IS_V false) or V, as f32
template <int HD, int MODE, bool IS_V>
__device__ __forceinline__ void row_values(const uint8_t* st, int r, int lig, float (&x)[kF]) {
  using TL = Tile<HD, MODE>;
  if constexpr (MODE == kBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(st + ((IS_V ? TL::CH : 0) + r) * TL::ROW +
                                                    lig * 16);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else if constexpr (MODE == kF32) {
    const float* row =
        reinterpret_cast<const float*>(st + ((IS_V ? TL::CH : 0) + r) * TL::ROW);
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * lig);
    const float4 b = *reinterpret_cast<const float4*>(row + HD / 2 + 4 * lig);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
    // bytes 4 lig .. 4 lig + 3 of k's (or v's) half: low nibbles are
    // features 4 lig + i, high nibbles hd / 2 + 4 lig + i
    const unsigned w =
        *reinterpret_cast<const unsigned*>(st + r * TL::ROW + (IS_V ? HD / 2 : 0) + 4 * lig);
    const float* sc = reinterpret_cast<const float*>(st + TL::CH * TL::ROW) +
                      (IS_V ? TL::NG : 0) * TL::SCS + r;
    const float s_lo = sc[(4 * lig / kQ4Group) * TL::SCS];
    const float s_hi = sc[((4 * lig + HD / 2) / kQ4Group) * TL::SCS];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // 0x4B0000bb: 2^23 + byte as a float; its nibbles give (nibble - 8) exactly
      const unsigned bits = __byte_perm(w, 0x4B000000u, 0x7440u + i);
      x[i] = (__uint_as_float(bits & 0x4B00000Fu) - 8388616.f) * s_lo;
      x[4 + i] = fmaf(__uint_as_float(bits & 0x4B0000F0u), 0.0625f, -524296.f) * s_hi;
    }
  }
}

// CUDA-core body (f32 pools; bf16 / int4 at hd 192 / 256): each warp
// holds four query heads' q (pre-scaled) and acc in registers, kF features
// a lane; LP lanes score one position (a shuffle reduction per head), PP
// positions per warp and pass. With G <= 4 the warps split the chunk's positions; with G = 5-8
// two, with G = 9-16 four head groups of four share them (heads past G are
// zero). Scores go to a per-warp buffer; the chunk's max and correction are
// taken per warp, then P @ V with the same lane-to-feature map.
template <int HD, int MODE>
struct CoreBody {
  using TL = Tile<HD, MODE>;
  int lig, grp, n_ps, hg, ps;
  bool active;
  float qr[kHeads][kF];
  float m[kHeads], l[kHeads], acc[kHeads][kF];

  // head groups of G heads and the warps sharing each
  static __device__ __forceinline__ int warps_per_group(int G) {
    return kWarps / (G <= kHeads ? 1 : (G <= 2 * kHeads ? 2 : 4));
  }
  // the warps holding head h: [first, first + count)
  static __device__ __forceinline__ void holders(int h, int G, int& first, int& count) {
    count = warps_per_group(G);
    first = h / kHeads * count;
  }

  __device__ __forceinline__ void init(const float* __restrict__ q, int bk, int G, float scale,
                                       uint8_t*) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    lig = lane % TL::LP;
    grp = lane / TL::LP;
    active = lig * kF < HD;
    n_ps = warps_per_group(G);
    hg = warp / n_ps;
    ps = warp % n_ps;
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const int head = hg * kHeads + g;
      m[g] = kNeg;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kF; ++i) {
        qr[g][i] = head < G && active
                       ? q[((size_t)bk * G + head) * HD + feature<HD, MODE>(lig, i)] * scale
                       : 0.f;
        acc[g][i] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void chunk(const uint8_t* st, uint8_t* smem, const Chunk& ch, int,
                                        float softcap, float inv_cap) {
    float4* wsc = reinterpret_cast<float4*>(smem + TL::RING) + (threadIdx.x >> 5) * TL::CH;
    // scores of this warp's positions: ps * PP + grp, then every step
    // rows, kU passes at a time (independent chains)
    const int step = n_ps * TL::PP;
    float mc[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) mc[g] = kNeg;
    for (int base = ps * TL::PP; base < ch.r_hi; base += kU * step) {
      float s[kU][kHeads];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float x[kF];
        if (active && base + u * step < ch.r_hi) {
          row_values<HD, MODE, false>(st, base + u * step + grp, lig, x);
        } else {
#pragma unroll
          for (int i = 0; i < kF; ++i) x[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < kF; ++i) t = fmaf(qr[g][i], x[i], t);
          s[u][g] = t;
        }
      }
#pragma unroll
      for (int o = 1; o < TL::LP; o <<= 1) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
          for (int g = 0; g < kHeads; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = base + u * step + grp;
        const bool valid = r >= ch.r_lo && r < ch.r_hi;
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          float t = s[u][g];
          if (softcap != 0.f) t = softcap * tanhf(t * inv_cap);  // before masking
          s[u][g] = valid ? t * kLog2e : kNeg;
          mc[g] = fmaxf(mc[g], s[u][g]);
        }
        if (lig == 0 && base + u * step < ch.r_hi) {
          wsc[r] = make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
        }
      }
    }
    // the chunk's max over the warp, and the correction
#pragma unroll
    for (int o = TL::LP; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g) mc[g] = fmaxf(mc[g], __shfl_xor_sync(0xffffffffu, mc[g], o));
    }
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const float m_new = fmaxf(m[g], mc[g]);
      const float corr = exp2f(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < kF; ++i) acc[g][i] *= corr;
    }
    __syncwarp();

    // acc += P @ V over the same positions
    for (int base = ps * TL::PP; base < ch.r_hi; base += kU * step) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool in = base + u * step < ch.r_hi;
        const int r = base + u * step + grp;
        const bool valid = r >= ch.r_lo && r < ch.r_hi;
        const float4 sv = in ? wsc[r] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float sg[kHeads] = {sv.x, sv.y, sv.z, sv.w};
        float p[kHeads];
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          p[g] = valid ? exp2f(sg[g] - m[g]) : 0.f;
          l[g] += p[g];
        }
        float x[kF];
        if (active && in) {
          row_values<HD, MODE, true>(st, r, lig, x);
        } else {
#pragma unroll
          for (int i = 0; i < kF; ++i) x[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
#pragma unroll
          for (int i = 0; i < kF; ++i) acc[g][i] = fmaf(p[g], x[i], acc[g][i]);
        }
      }
    }
  }

  // this warp's softmax states into red (kWarps, kMaxG, HD + 2): acc, m, l
  __device__ __forceinline__ void to_red(float* red, int G) {
    // join the warp's position groups (m is warp-uniform)
#pragma unroll
    for (int o = TL::LP; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int i = 0; i < kF; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
      }
    }
    if (grp != 0 || !active) return;
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const int head = hg * kHeads + g;
      if (head >= G) break;
      float* rw = red + ((threadIdx.x >> 5) * kMaxG + head) * (HD + 2);
#pragma unroll
      for (int i = 0; i < kF; ++i) rw[feature<HD, MODE>(lig, i)] = acc[g][i];
      if (lig == 0) {
        rw[HD] = m[g];
        rw[HD + 1] = l[g];
      }
    }
  }
};

// tensor-core body (bf16 and int4 pools, hd <= 128): every warp holds all
// G <= 16 query heads on the M side of mma.sync m16n8k16 (bf16 operands,
// f32 accumulators) and takes 16 of the chunk's 64 positions. S = Q K^T,
// then O += P V with P's accumulator fragments reused as the A operand
// (the flash-attention-2 layout). q is staged once in three bf16 parts (q1
// + q2 + q3 carries q's 24-bit mantissa, three products per step) and P in
// two (16 bits), so the sums keep f32's accuracy to ~1e-6; bf16 K / V are
// exact operands, int4 (nibble - 8) too, the group scales applied in f32:
// to each 32-feature group's partial scores, and folded into P for V's.
template <int HD, int MODE>
struct MmaBody {
  using TL = Tile<HD, MODE>;
  static constexpr int NT = HD / 8;  // n8 tiles of O
  const __nv_bfloat16* qs;           // (3 G + 1, QROW): the parts of q, then a zero row
  int G;
  float o[NT][4];
  float m[2], l[2];  // heads lane / 4 and lane / 4 + 8

  static __device__ __forceinline__ void holders(int, int, int& first, int& count) {
    first = 0;
    count = kWarps;
  }

  __device__ __forceinline__ void init(const float* __restrict__ q, int bk, int G_, float scale,
                                       uint8_t* smem) {
    G = G_;
    __nv_bfloat16* qw = reinterpret_cast<__nv_bfloat16*>(smem + TL::RING + TL::SBUF);
    for (int i = threadIdx.x; i < (G + 1) * HD; i += kThreads) {
      const int h = i / HD, d = i % HD;
      if (h == G) {
        qw[3 * G * TL::QROW + d] = __float2bfloat16_rn(0.f);
        continue;
      }
      float x = q[((size_t)bk * G + h) * HD + d] * scale;
#pragma unroll
      for (int sp = 0; sp < 3; ++sp) {
        const __nv_bfloat16 v = __float2bfloat16_rn(x);
        qw[(sp * G + h) * TL::QROW + d] = v;
        x -= __bfloat162float(v);  // exact
      }
    }
    qs = qw;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[j] = kNeg;
      l[j] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    }
  }

  // A fragment of part sp of q at k-step kk (features 16 kk ..): heads past G read the zero row
  __device__ __forceinline__ void q_frag(uint32_t (&a)[4], int sp, int kk, int lane) const {
    const int h = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int row = h < G ? sp * G + h : 3 * G;
    ldsm_x4(a, qs + row * TL::QROW + kk * 16 + (lane >> 4) * 8);
  }

  // S of the warp's 16 positions r0 .. r0 + 15 (two n8 tiles), natural units
  __device__ __forceinline__ void scores(const uint8_t* st, int r0, int lane,
                                         float (&s)[2][4]) const {
    if constexpr (MODE == kBF16) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];  // K rows as the col-major B: n-tile 0 in b[0..1], 1 in b[2..3]
        const int mi = lane >> 3, row = r0 + (mi >> 1) * 8 + (lane & 7);
        const int piece = 2 * kk + (mi & 1);
        ldsm_x4(b, st + row * TL::ROW + ((piece ^ (row & 7)) << 4));
#pragma unroll
        for (int sp = 0; sp < 3; ++sp) {
          uint32_t a[4];
          q_frag(a, sp, kk, lane);
          mma_bf16(s[0], a, b[0], b[1]);
          mma_bf16(s[1], a, b[2], b[3]);
        }
      }
    } else {
      // code bytes 32 j .. 32 j + 31 of k's half: low nibbles are features
      // of group j, high nibbles of group hd / 64 + j
      const float* sc = reinterpret_cast<const float*>(st + TL::CH * TL::ROW);
      constexpr int kHalfGroups = HD / 64;
#pragma unroll
      for (int j = 0; j < kHalfGroups; ++j) {
        float tl[2][4] = {}, th[2][4] = {};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kb = 32 * j + 16 * u;  // first code byte of this k-step
          uint32_t bl[2][2], bh[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {
              const uint8_t* p =
                  st + (r0 + nt * 8 + (lane >> 2)) * TL::ROW + kb + 2 * (lane & 3) + 8 * hb;
              nibbles_bf16(__byte_perm(*reinterpret_cast<const uint16_t*>(p), 0u, 0x4140u),
                           bl[nt][hb], bh[nt][hb]);
            }
          }
#pragma unroll
          for (int sp = 0; sp < 3; ++sp) {
            uint32_t a[4];
            q_frag(a, sp, kb / 16, lane);
            mma_bf16(tl[0], a, bl[0][0], bl[0][1]);
            mma_bf16(tl[1], a, bl[1][0], bl[1][1]);
            q_frag(a, sp, (HD / 2 + kb) / 16, lane);
            mma_bf16(th[0], a, bh[0][0], bh[0][1]);
            mma_bf16(th[1], a, bh[1][0], bh[1][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + nt * 8 + 2 * (lane & 3) + (e & 1);
            s[nt][e] += fmaf(tl[nt][e], sc[j * TL::SCS + r],
                             th[nt][e] * sc[(kHalfGroups + j) * TL::SCS + r]);
          }
        }
      }
    }
  }

  // O += P V over the warp's 16 positions; p[nt][e] as the S fragments
  __device__ __forceinline__ void pv(const uint8_t* st, int r0, int lane,
                                     const float (&p)[2][4]) {
    if constexpr (MODE == kBF16) {
      uint32_t ph[4], pl[4];  // A fragments: (heads, positions 2c.. / 8 + 2c..)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          split_bf16(p[nt][2 * j], p[nt][2 * j + 1], ph[2 * nt + j], pl[2 * nt + j]);
        }
      }
#pragma unroll
      for (int nf = 0; nf < NT; nf += 2) {
        uint32_t b[4];  // V rows as the B: n-tile nf in b[0..1], nf + 1 in b[2..3]
        const int mi = lane >> 3, row = r0 + (mi & 1) * 8 + (lane & 7), piece = nf + (mi >> 1);
        ldsm_x4_trans(b, st + (TL::CH + row) * TL::ROW + ((piece ^ (row & 7)) << 4));
        mma_bf16(o[nf], ph, b[0], b[1]);
        mma_bf16(o[nf], pl, b[0], b[1]);
        mma_bf16(o[nf + 1], ph, b[2], b[3]);
        mma_bf16(o[nf + 1], pl, b[2], b[3]);
      }
    } else {
      const float* sc = reinterpret_cast<const float*>(st + TL::CH * TL::ROW) + TL::NG * TL::SCS;
      const int ra = r0 + 2 * (lane & 3);  // this thread's positions ra, ra + 1, ra + 8, ra + 9
#pragma unroll
      for (int g = 0; g < TL::NG; ++g) {  // v's group g: features 32 g .., n-tiles 4 g ..
        uint32_t ah[4], al[4];            // P scaled by the positions' group-g scales
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float s0 = sc[g * TL::SCS + ra + 8 * nt], s1 = sc[g * TL::SCS + ra + 8 * nt + 1];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            split_bf16(p[nt][2 * j] * s0, p[nt][2 * j + 1] * s1, ah[2 * nt + j], al[2 * nt + j]);
          }
        }
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4) {
          const int nf = 4 * g + n4;
          const bool high = 8 * nf >= HD / 2;  // features hd / 2 .. in the high nibbles
          const uint8_t* col = st + HD / 2 + 8 * nf - (high ? HD / 2 : 0) + (lane >> 2);
          const uint32_t w0 = __byte_perm(col[ra * TL::ROW], col[(ra + 1) * TL::ROW], 0x5410u);
          const uint32_t w1 =
              __byte_perm(col[(ra + 8) * TL::ROW], col[(ra + 9) * TL::ROW], 0x5410u);
          uint32_t lo0, hi0, lo1, hi1;
          nibbles_bf16(w0, lo0, hi0);
          nibbles_bf16(w1, lo1, hi1);
          const uint32_t b0 = high ? hi0 : lo0, b1 = high ? hi1 : lo1;
          mma_bf16(o[nf], ah, b0, b1);
          mma_bf16(o[nf], al, b0, b1);
        }
      }
    }
  }

  __device__ __forceinline__ void chunk(const uint8_t* st, uint8_t*, const Chunk& ch, int,
                                        float softcap, float inv_cap) {
    const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
    if (r0 >= ch.r_hi) return;  // no position of this warp in the chunk
    float s[2][4] = {};
    scores(st, r0, lane, s);
    // softcap before masking, log2 units; the max of each head over the warp's positions
    bool ok[2][2];
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        ok[nt][e & 1] = r >= ch.r_lo && r < ch.r_hi;
        float t = s[nt][e];
        if (softcap != 0.f) t = softcap * tanhf(t * inv_cap);
        s[nt][e] = ok[nt][e & 1] ? t * kLog2e : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // the quad of lanes sharing a head
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      const float corr = exp2f(m[j] - m_new);
      m[j] = m_new;
      l[j] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * j] *= corr;
        o[n][2 * j + 1] *= corr;
      }
    }
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[nt][e] = ok[nt][e & 1] ? exp2f(s[nt][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p[nt][e];
      }
    }
    pv(st, r0, lane, p);
  }

  __device__ __forceinline__ void to_red(float* red, int) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      const int h = (lane >> 2) + 8 * j;
      if (h >= G) continue;
      float* rw = red + (warp * kMaxG + h) * (HD + 2);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        rw[8 * n + 2 * (lane & 3)] = o[n][2 * j];
        rw[8 * n + 2 * (lane & 3) + 1] = o[n][2 * j + 1];
      }
      if ((lane & 3) == 0) {
        rw[HD] = m[j];
        rw[HD + 1] = l[j];
      }
    }
  }
};

template <int HD, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_split_kernel(const float* __restrict__ q, const void* __restrict__ kpool,
                   const void* __restrict__ vpool, const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ part, int nKV, int G,
                   int page, int pps, int n_pool, int pps_split, float scale, int window,
                   float softcap) {
  using TL = Tile<HD, MODE>;
  using Body = typename std::conditional<TL::MMA, MmaBody<HD, MODE>, CoreBody<HD, MODE>>::type;
  extern __shared__ __align__(16) uint8_t smem[];

  const int n_bk = gridDim.x, n_split = gridDim.y;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / nKV, kv = bk % nKV;
  const int tid = threadIdx.x;

  float* part_acc = part;
  float* part_m = part + (size_t)n_bk * n_split * G * HD;
  float* part_l = part_m + (size_t)n_bk * n_split * G;
  const size_t pbase = ((size_t)bk * n_split + split) * G;  // partial (bk, split, head 0)

  // this split's attended positions [lo_pos, hi_pos]
  const int p_lo = split * pps_split, p_hi = min(p_lo + pps_split, pps);
  const int* trow = table + (size_t)b * pps;
  const int length = lengths[b];
  const int pid_lo = trow[p_lo];  // read beside the length: the first page read, bar a window
  int lo_pos = p_lo * page;
  if (window > 0) lo_pos = max(lo_pos, length - window + 1);
  const int hi_pos = min(p_hi * page - 1, length);

  if (lo_pos > hi_pos) {  // empty split: weight exactly 0 in the combine
    for (int i = tid; i < G * HD; i += kThreads) part_acc[pbase * HD + i] = 0.f;
    if (tid < G) {
      part_m[pbase + tid] = kNeg;
      part_l[pbase + tid] = 0.f;
    }
  } else {
    const int cpp = (page + TL::CH - 1) / TL::CH;
    const int gc0 = (lo_pos / page) * cpp + (lo_pos % page) / TL::CH;
    const int n_chunks = (hi_pos / page) * cpp + (hi_pos % page) / TL::CH - gc0 + 1;
    auto issue = [&](int c) {
      const Chunk ch = chunk_at<TL::CH>(gc0 + c, page, lo_pos, hi_pos);
      const int pid = min(max(ch.page_idx == p_lo ? pid_lo : trow[ch.page_idx], 0), n_pool - 1);
      issue_chunk<HD, MODE>(smem + (c % kStages) * TL::STAGE, kpool, vpool,
                            (size_t)pid * nKV + kv, page, ch);
    };
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) issue(c);
      cp_async_commit();
    }
    Body body;
    body.init(q, bk, G, scale, smem);
    const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c landed for every thread; chunk c - 1 consumed
      if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
      cp_async_commit();
      body.chunk(smem + (c % kStages) * TL::STAGE, smem,
                 chunk_at<TL::CH>(gc0 + c, page, lo_pos, hi_pos), c, softcap, inv_cap);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: its space holds the states
    float* red = reinterpret_cast<float*>(smem);  // (kWarps, kMaxG, HD + 2): acc, m, l
    body.to_red(red, G);
    __syncthreads();
    // join the warps holding each head, in warp order
    for (int i = tid; i < G * HD; i += kThreads) {
      const int head = i / HD, d = i % HD;
      int w0, nw;
      Body::holders(head, G, w0, nw);
      const float* r0 = red + (w0 * kMaxG + head) * (HD + 2);
      constexpr int kWarpStride = kMaxG * (HD + 2);
      float M = kNeg;
      for (int w = 0; w < nw; ++w) M = fmaxf(M, r0[w * kWarpStride + HD]);
      float A = 0.f, L = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float* rw = r0 + w * kWarpStride;
        const float wt = exp2f(rw[HD] - M);
        A += rw[d] * wt;
        L += rw[HD + 1] * wt;
      }
      part_acc[(pbase + head) * HD + d] = A;
      if (d == 0) {
        part_m[pbase + head] = M;
        part_l[pbase + head] = L;
      }
    }
  }
}

// pass 2: one block per (slot, kv head) joins its n_split partials in split
// order, adds the sink mass and divides
template <int HD>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ part, const float* __restrict__ sinks,
                     float* __restrict__ out, int nKV, int G, int n_split) {
  __shared__ float w_s[kMaxSplit * kMaxG];  // (n_split, G): m, then the split's weight
  __shared__ float l_s[kMaxSplit * kMaxG];  // (n_split, G)
  __shared__ float L_s[kMaxG];              // denominators
  const int bk = blockIdx.x, n_bk = gridDim.x;
  const float* part_acc = part + (size_t)bk * n_split * G * HD;
  const float* part_m = part + (size_t)n_bk * n_split * G * HD + (size_t)bk * n_split * G;
  const float* part_l = part_m + (size_t)n_bk * n_split * G;
  for (int i = threadIdx.x; i < n_split * G; i += blockDim.x) {
    w_s[i] = part_m[i];
    l_s[i] = part_l[i];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = kNeg;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, w_s[s * G + g]);
    float sk = 0.f;
    if (sinks != nullptr) {
      sk = sinks[(bk % nKV) * G + g] * kLog2e;
      M = fmaxf(M, sk);
    }
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = exp2f(w_s[s * G + g] - M);
      w_s[s * G + g] = w;
      L += l_s[s * G + g] * w;
    }
    if (sinks != nullptr) L += exp2f(sk - M);  // sink mass
    L_s[g] = L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    const float* a = part_acc + i;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) A += a[(size_t)s * G * HD] * w_s[s * G + g];
    out[(size_t)bk * G * HD + i] = A / fmaxf(L_s[g], 1e-30f);
  }
}

struct Args {
  const float* q;
  const void* kpool;
  const void* vpool;
  const int* table;
  const int* lengths;
  const float* sinks;
  float* out;
  float* part;
  int B, nKV, G, page, pps, n_pool, n_split, pps_split;
  float scale;
  int window;
  float softcap;
};

template <int HD, int MODE>
int launch(const Args& a, cudaStream_t stream) {
  using TL = Tile<HD, MODE>;
  const int smem = TL::smem(a.G);
  if (TL::smem(kMaxG) > 48 * 1024) {  // once per device, for the largest G
    static unsigned long long done = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !(done >> dev & 1ull)) {
      e = cudaFuncSetAttribute(paged_split_kernel<HD, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TL::smem(kMaxG));
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) done |= 1ull << dev;
    }
  }
  paged_split_kernel<HD, MODE><<<dim3(a.B * a.nKV, a.n_split), kThreads, smem, stream>>>(
      a.q, a.kpool, a.vpool, a.table, a.lengths, a.part, a.nKV, a.G, a.page, a.pps, a.n_pool,
      a.pps_split, a.scale, a.window, a.softcap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<HD><<<a.B * a.nKV, kCombineThreads, 0, stream>>>(
      a.part, a.sinks, a.out, a.nKV, a.G, a.n_split);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, MODE>(a, stream);
    case 96:  // int4 needs hd / 2 a multiple of 32 (the scale groups of each half)
      if constexpr (MODE == kQ4) {
        return (int)cudaErrorInvalidValue;
      } else {
        return launch<96, MODE>(a, stream);
      }
    case 128:
      return launch<128, MODE>(a, stream);
    case 192:
      return launch<192, MODE>(a, stream);
    case 256:
      return launch<256, MODE>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode 0: f32 pools, 1: bf16 pools (k_pool, v_pool); 2: combined int4 pools
// (k_pool = codes, v_pool = scales). q (B, nKV, G, hd) f32, out the same;
// table (B, pps) and lengths (B,) int32; sinks (nKV * G,) f32 or null;
// n_pool the pools' leading extent. The slot's pages are split into n_split
// ranges of pps_split pages (n_split * pps_split >= pps, no range past pps);
// part is scratch of B * nKV * n_split * G * (hd + 2) f32. Launches
// paged_split_kernel, then paged_combine_kernel. Returns 0 or the CUDA error
// of a launch (cudaErrorInvalidValue for a shape the kernel does not take).
// Asynchronous on ``stream``.
extern "C" int gg_paged_flash_decode(const float* q, const void* k_pool, const void* v_pool,
                                     int mode, const int* table, const int* lengths,
                                     const float* sinks, float* out, float* part, int B,
                                     int nKV, int G, int hd, int page, int pps, int n_pool,
                                     int n_split, int pps_split, float scale, int window,
                                     float softcap, cudaStream_t stream) {
  if (B < 1 || nKV < 1 || G < 1 || G > kMaxG || hd % 32 != 0 || hd < 64 || hd > 256 ||
      page < 1 || page > kMaxPage || pps < 1 || n_pool < 1 || n_split < 1 || n_split > kMaxSplit ||
      pps_split < 1 || (long long)n_split * pps_split < pps ||
      (long long)(n_split - 1) * pps_split >= pps || part == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k_pool, v_pool, table,  lengths, sinks,   out,       part,  B,
               nKV, G,    page,   pps,   n_pool, n_split, pps_split, scale, window,
               softcap};
  switch (mode) {
    case kF32:
      return launch_hd<kF32>(hd, a, stream);
    case kBF16:
      return launch_hd<kBF16>(hd, a, stream);
    case kQ4:
      return launch_hd<kQ4>(hd, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
