// Group-dot dequant + matmul over the v2 runtime format (the kernel
// variants "v2m", "v2t" and "v2p"), for Hopper (sm_90a). Built by
// gptq_gguf_tpu_torch/ops/cuda_build.py into a shared library with a plain
// C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmatmul.py::dequant_matmul_v2m / _v2t / _v2p.
//
// Replaces three Pallas bodies behind
// gptq_gguf_tpu/ops/qmatmul.py::dequant_matmul_pallas_v2:
//   _kernel_v2m  group size 32 (Q4_K, Q5_K): one dot per group of raw
//                codes, its partial sum scaled and added to the
//                accumulator at once;
//   _kernel_v2t  the same function, group size 32, computed in two passes:
//                a supergroup's per-group partial sums kept in shared
//                memory, then reduced weighted by the scales (JAX's
//                batched dot_general plus sum(parts * scale));
//   _kernel_v2p  the same function at group size 16 (Q2_K, Q3_K, Q6_K):
//                two adjacent groups' partial sums scaled and added
//                together, then added to the accumulator (JAX's pair-group
//                k=32 dot over a lane-doubled code plane, whose zero halves
//                add an exact 0; a TPU MXU shape trick this body does not
//                need: it takes the 16-code groups directly).
//
// Computes, for x (M, d_in) f32 or bf16 and one v2-packed weight:
//   y (M, d_out) f32 = sum_g scale_g * (sum_{k in g} T(x_k) * q_k)  -  xsum @ off2
//   q        = the raw unsigned code (< 64, exact in bf16): no per-weight
//              scale multiply; the signed shift rides off2
//   scale[g] = d_sg[d_rep * sg, n] * f32(sc_q[g, n])   (exact)
//   off2[g]  = dmin_sg[...] * f32(mn_q[g, n])  (types with a min), or
//              scale[g] * shift (signed types)
//   xsum     = f32 group sums of the UN-rounded x, taken while staging x
// with T the rounding to the operand type (mxu_dtype): bf16 or none, a
// template parameter of every body that acts only where x is staged (the
// codes are exact in either type). The
// scale multiplies each group's partial sum, not each weight: that is the
// variant's design point, kept here. Products and additions of partials
// use __fmul_rn / __fadd_rn, so each step rounds as the JAX body's does.
//
// What bounds it: bytes at decode, the same planes as v2g (4,773,330,944 B
// per Llama-3-8B B=8 step with x and y); operations at prefill.
//
// Design (CUDA cores, f32 accumulation; the decode bodies): VEC = 4
// adjacent output columns per thread and one 32-bit word of codes per
// weight row, as v2g; x staged in shared memory a 256-row supergroup at a
// time for MT <= 8 rows (the group sums of the raw x taken there, then the
// tile rounded in place); the block's 4 warps split each supergroup into
// units of 32 weight-byte rows (for nibble codes a unit holds a group, or
// a group pair, of the low nibbles and its mirror 128 rows up). MT stays at
// 8 or less: a unit's partial sums live beside the accumulator (v2p at
// 4-bit holds four sets). With bf16 operands all three run M >= 9 rows on
// the tensor-core tiles of qmatmul_v2m_mma.cuh (v2t with JAX's order: a
// step's scaled partials summed before the accumulator), and v2p and v2t
// their decode rows on the tensor-core decode tile (qmatmul_decode_mma.cuh,
// from each one's qmatmul.DECODE_MMA_MIN_ROWS); f32 operands (a test
// mode) and vec-1 weights stay here at any M, in 8-row tiles. The K axis
// is split over supergroups with a second kernel reducing the partials in
// a fixed order (no float atomics).

#include "qmatmul_common.cuh"
#include "qmatmul_v2m_mma.cuh"

namespace {

constexpr int kSlices = 4;     // warps splitting each supergroup
constexpr int kColT = kThreads / kSlices;  // column threads per slice
constexpr int kUnit = 32;      // weight-byte rows per unit

template <int MT, int VEC>
__device__ __forceinline__ void zero(float (&p)[MT][VEC]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) p[m][c] = 0.f;
}

// Stage one supergroup of x for rows m0 .. m0 + MT - 1: xs[k * MT + m]
// (k-major), the group sums of the raw values in xg[g * MT + m], then the
// tile rounded to bf16 in place when the operand type is bf16. Called by
// all threads.
template <bool BF16, int GS, int MT>
__device__ __forceinline__ void stage_x(const void* x, int x_bf16, int M, int d_in, int m0,
                                        int sg, float* xs, float* xg) {
  constexpr int GPSG = kQK / GS;
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __syncthreads();  // the previous supergroup's tile is fully consumed
  for (int t = threadIdx.x; t < MT * kQK; t += kThreads) {
    const int m = t % MT, k = t / MT, row = m0 + m;
    const size_t i = static_cast<size_t>(row) * d_in + static_cast<size_t>(sg) * kQK + k;
    float v = 0.f;
    if (row < M) v = x_bf16 ? __bfloat162float(xb[i]) : xf[i];
    xs[t] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < MT * GPSG; t += kThreads) {
    const int m = t % MT, g = t / MT;
    float s = 0.f;
#pragma unroll 4
    for (int j = 0; j < GS; ++j) {
      float* p = xs + (g * GS + j) * MT + m;
      s += *p;
      if (BF16) *p = bf16_round(*p);
    }
    xg[t] = s;
  }
  __syncthreads();
}

// Partial sums over weight-byte rows k0 .. k0 + N - 1 of raw codes times
// the staged x: for nibble codes (PB 2) the low nibbles (rows k) into lo
// and the high nibbles (rows k + 128) into hi; for byte codes into lo.
// The products of a bf16 x and a code are exact in f32.
template <int PB, int N, int MT, int VEC>
__device__ __forceinline__ void unit_dot(const uint8_t* qrow, size_t ldo, const float* xs,
                                         int k0, float (&lo)[MT][VEC], float (&hi)[MT][VEC]) {
  zero(lo);
  if constexpr (PB == 2) zero(hi);
#pragma unroll 8
  for (int j = 0; j < N; ++j) {
    const int k = k0 + j;
    const uint32_t w = load_bytes<VEC>(qrow + static_cast<size_t>(k) * ldo);
    float xa[MT];
    load_x<MT>(xs + k * MT, xa);
    if constexpr (PB == 2) {
      float xb[MT];
      load_x<MT>(xs + (k + kHalf) * MT, xb);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float ql = small_u2f((w >> (8 * c)) & 0xFu);
        const float qh = small_u2f((w >> (8 * c + 4)) & 0xFu);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          lo[m][c] = fmaf(xa[m], ql, lo[m][c]);
          hi[m][c] = fmaf(xb[m], qh, hi[m][c]);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float q = small_u2f((w >> (8 * c)) & 0xFFu);
#pragma unroll
        for (int m = 0; m < MT; ++m) lo[m][c] = fmaf(xa[m], q, lo[m][c]);
      }
    }
  }
}

// The scale and folded offset of group g (global index sg * GPSG + g) for
// VEC columns from n: scale = d * sc (exact); off2 = dmin * mn, or
// scale * shift for the signed types (_folded_planes_v2's f32 order).
template <bool HAS_MIN, int VEC>
struct GroupPlanes {
  const float* d_sg;
  const float* dmin_sg;
  const uint8_t* sc_q;
  const uint8_t* mn_q;
  size_t ldo;
  int d_rep;
  float shift;

  __device__ __forceinline__ void get(int sg, int gg, int n, float (&s)[VEC],
                                      float (&o)[VEC]) const {
    float d[VEC], dmin[VEC];
    const size_t sg_row = static_cast<size_t>(sg) * d_rep * ldo + n;
    load_f32<VEC>(d_sg + sg_row, d);
    if (HAS_MIN) load_f32<VEC>(dmin_sg + sg_row, dmin);
    const size_t gi = static_cast<size_t>(gg) * ldo + n;
    const uint32_t scw = load_bytes<VEC>(sc_q + gi);
    const uint32_t mnw = HAS_MIN ? load_bytes<VEC>(mn_q + gi) : 0u;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      s[c] = d[c] * scale_code<!HAS_MIN>(scw, c);
      o[c] = HAS_MIN ? dmin[c] * static_cast<float>((mnw >> (8 * c)) & 0xFFu)
                     : s[c] * shift;
    }
  }
};

// acc -= xsum_g * off2_g for every row of the tile
template <int MT, int VEC>
__device__ __forceinline__ void offset_term(float (&acc)[MT][VEC], const float* xg, int g,
                                            const float (&o)[VEC]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(-xg[g * MT + m], o[c], acc[m][c]);
}

// Write the tile's sums (slice 0 after the cross-slice add), rows masked.
template <int MT, int VEC>
__device__ __forceinline__ void store(float* out, const float (&acc)[MT][VEC], int M,
                                      int d_out, int m0, int n0) {
  const size_t ldo = static_cast<size_t>(d_out);
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

// Slices 1..3 hand their sums to slice 0 through shared memory, added in
// slice order. Called by all threads; returns true on slice 0.
template <int MT, int VEC>
__device__ __forceinline__ bool reduce_slices(float (&acc)[MT][VEC], float* red, int slice,
                                              int tx, bool live) {
  if (slice > 0 && live) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        red[((slice - 1) * MT + m) * kColT * VEC + tx * VEC + c] = acc[m][c];
  }
  __syncthreads();
  if (slice > 0) return false;
  for (int s = 1; s < kSlices; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        acc[m][c] += red[((s - 1) * MT + m) * kColT * VEC + tx * VEC + c];
  return true;
}

// _kernel_v2m: group size 32. A unit is one group of byte codes, or a
// low-nibble group and its high-nibble mirror (group g + 4).
template <bool BF16, int PB, bool HAS_MIN, int MT, int VEC>
__global__ void __launch_bounds__(kThreads) v2m_kernel(V2Args a) {
  constexpr int GS = 32, GPSG = kQK / GS;
  constexpr int UPS = (PB == 2 ? kHalf : kQK) / kUnit / kSlices;  // units per slice
  __shared__ __align__(16) float xs[kQK * MT];
  __shared__ float xg[GPSG * MT];
  __shared__ __align__(16) float red[(kSlices - 1) * MT * kColT * VEC];

  const int tx = threadIdx.x % kColT, slice = threadIdx.x / kColT;
  const int n0 = (blockIdx.x * kColT + tx) * VEC, m0 = blockIdx.y * MT;
  const int n_sg = a.d_in / kQK;
  const int sg_begin = blockIdx.z * a.sg_per_split;
  const int sg_end = min(n_sg, sg_begin + a.sg_per_split);
  const bool live = n0 < a.d_out;
  const size_t ldo = static_cast<size_t>(a.d_out);
  const GroupPlanes<HAS_MIN, VEC> planes{a.d_sg, a.dmin_sg, a.sc_q, a.mn_q, ldo, a.d_rep,
                                         a.shift};

  float acc[MT][VEC];
  zero(acc);
  for (int sg = sg_begin; sg < sg_end; ++sg) {
    stage_x<BF16, GS, MT>(a.x, a.x_bf16, a.M, a.d_in, m0, sg, xs, xg);
    if (!live) continue;
    const uint8_t* qrow = a.qs + static_cast<size_t>(sg) * (kQK / PB) * ldo + n0;
#pragma unroll 1
    for (int u = slice * UPS; u < (slice + 1) * UPS; ++u) {
      float lo[MT][VEC], hi[MT][VEC];
      unit_dot<PB, kUnit, MT, VEC>(qrow, ldo, xs, u * kUnit, lo, hi);
      float s[VEC], o[VEC];
      planes.get(sg, sg * GPSG + u, n0, s, o);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(lo[m][c], s[c]));
      offset_term(acc, xg, u, o);
      if constexpr (PB == 2) {
        const int g_hi = u + GPSG / 2;
        planes.get(sg, sg * GPSG + g_hi, n0, s, o);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[m][c] = __fadd_rn(acc[m][c], __fmul_rn(hi[m][c], s[c]));
        offset_term(acc, xg, g_hi, o);
      }
    }
  }
  if (reduce_slices(acc, red, slice, tx, live) && live) store(a.dst, acc, a.M, a.d_out, m0, n0);
}

// _kernel_v2p: group size 16. A unit is a pair of adjacent groups (2u,
// 2u + 1) of byte codes, or such a pair of low nibbles and its high-nibble
// mirror (groups 8 + 2u, 9 + 2u). Each pair adds s_even * part_even +
// s_odd * part_odd to the accumulator, as JAX's pair dot does.
template <bool BF16, int PB, bool HAS_MIN, int MT, int VEC>
__global__ void __launch_bounds__(kThreads) v2p_kernel(V2Args a) {
  constexpr int GS = 16, GPSG = kQK / GS;
  constexpr int UPS = (PB == 2 ? kHalf : kQK) / kUnit / kSlices;
  __shared__ __align__(16) float xs[kQK * MT];
  __shared__ float xg[GPSG * MT];
  __shared__ __align__(16) float red[(kSlices - 1) * MT * kColT * VEC];

  const int tx = threadIdx.x % kColT, slice = threadIdx.x / kColT;
  const int n0 = (blockIdx.x * kColT + tx) * VEC, m0 = blockIdx.y * MT;
  const int n_sg = a.d_in / kQK;
  const int sg_begin = blockIdx.z * a.sg_per_split;
  const int sg_end = min(n_sg, sg_begin + a.sg_per_split);
  const bool live = n0 < a.d_out;
  const size_t ldo = static_cast<size_t>(a.d_out);
  const GroupPlanes<HAS_MIN, VEC> planes{a.d_sg, a.dmin_sg, a.sc_q, a.mn_q, ldo, a.d_rep,
                                         a.shift};

  float acc[MT][VEC];
  zero(acc);
  for (int sg = sg_begin; sg < sg_end; ++sg) {
    stage_x<BF16, GS, MT>(a.x, a.x_bf16, a.M, a.d_in, m0, sg, xs, xg);
    if (!live) continue;
    const uint8_t* qrow = a.qs + static_cast<size_t>(sg) * (kQK / PB) * ldo + n0;
#pragma unroll 1
    for (int u = slice * UPS; u < (slice + 1) * UPS; ++u) {
      // the even groups' partials first, scaled into t; then the odd ones
      float lo[MT][VEC], hi[MT][VEC], t_lo[MT][VEC], t_hi[MT][VEC];
      float s[VEC], o[VEC];
      const int ge = 2 * u;  // the low half's even group
      unit_dot<PB, GS, MT, VEC>(qrow, ldo, xs, u * kUnit, lo, hi);
      planes.get(sg, sg * GPSG + ge, n0, s, o);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c) t_lo[m][c] = __fmul_rn(lo[m][c], s[c]);
      offset_term(acc, xg, ge, o);
      if constexpr (PB == 2) {
        planes.get(sg, sg * GPSG + ge + GPSG / 2, n0, s, o);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < VEC; ++c) t_hi[m][c] = __fmul_rn(hi[m][c], s[c]);
        offset_term(acc, xg, ge + GPSG / 2, o);
      }
      unit_dot<PB, GS, MT, VEC>(qrow, ldo, xs, u * kUnit + GS, lo, hi);
      planes.get(sg, sg * GPSG + ge + 1, n0, s, o);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          acc[m][c] = __fadd_rn(acc[m][c], __fadd_rn(t_lo[m][c], __fmul_rn(lo[m][c], s[c])));
      offset_term(acc, xg, ge + 1, o);
      if constexpr (PB == 2) {
        planes.get(sg, sg * GPSG + ge + 1 + GPSG / 2, n0, s, o);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[m][c] = __fadd_rn(acc[m][c], __fadd_rn(t_hi[m][c], __fmul_rn(hi[m][c], s[c])));
        offset_term(acc, xg, ge + 1 + GPSG / 2, o);
      }
    }
  }
  if (reduce_slices(acc, red, slice, tx, live) && live) store(a.dst, acc, a.M, a.d_out, m0, n0);
}

// _kernel_v2t: group size 32, two passes per supergroup. Pass 1: each
// slice's units write their groups' partial sums to pp[g][m][col]. Pass 2:
// thread t owns column t % COLS of the block and rows t / COLS + i * RS
// and adds, for each of them, sum_g pp[g] * scale_g (from 0, group order)
// to its accumulator, then the offset terms; the slices need no final
// exchange.
template <bool BF16, int PB, bool HAS_MIN, int MT, int VEC>
__global__ void __launch_bounds__(kThreads) v2t_kernel(V2Args a) {
  constexpr int GS = 32, GPSG = kQK / GS;
  constexpr int UPS = (PB == 2 ? kHalf : kQK) / kUnit / kSlices;
  constexpr int COLS = kColT * VEC;      // columns of the block
  constexpr int RS = kThreads / COLS;    // row stride of pass 2 (1 or 4)
  constexpr int NR = (MT + RS - 1) / RS;  // rows per thread in pass 2
  __shared__ __align__(16) float xs[kQK * MT];
  __shared__ float xg[GPSG * MT];
  __shared__ float pp[GPSG * MT * COLS];  // pp[(g * MT + m) * COLS + col]

  const int tx = threadIdx.x % kColT, slice = threadIdx.x / kColT;
  const int n0 = (blockIdx.x * kColT + tx) * VEC, m0 = blockIdx.y * MT;
  const int col = threadIdx.x % COLS, r0 = threadIdx.x / COLS;
  const int n = blockIdx.x * COLS + col;  // pass 2's column
  const int n_sg = a.d_in / kQK;
  const int sg_begin = blockIdx.z * a.sg_per_split;
  const int sg_end = min(n_sg, sg_begin + a.sg_per_split);
  const size_t ldo = static_cast<size_t>(a.d_out);
  const GroupPlanes<HAS_MIN, 1> planes{a.d_sg, a.dmin_sg, a.sc_q, a.mn_q, ldo, a.d_rep,
                                       a.shift};

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  for (int sg = sg_begin; sg < sg_end; ++sg) {
    stage_x<BF16, GS, MT>(a.x, a.x_bf16, a.M, a.d_in, m0, sg, xs, xg);
    if (n0 < a.d_out) {  // pass 1
      const uint8_t* qrow = a.qs + static_cast<size_t>(sg) * (kQK / PB) * ldo + n0;
#pragma unroll 1
      for (int u = slice * UPS; u < (slice + 1) * UPS; ++u) {
        float lo[MT][VEC], hi[MT][VEC];
        unit_dot<PB, kUnit, MT, VEC>(qrow, ldo, xs, u * kUnit, lo, hi);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            pp[(u * MT + m) * COLS + tx * VEC + c] = lo[m][c];
            if constexpr (PB == 2) pp[((u + GPSG / 2) * MT + m) * COLS + tx * VEC + c] = hi[m][c];
          }
      }
    }
    __syncthreads();
    if (n < a.d_out) {  // pass 2
      float s[GPSG], o[GPSG];
#pragma unroll
      for (int g = 0; g < GPSG; ++g) {
        float sv[1], ov[1];
        planes.get(sg, sg * GPSG + g, n, sv, ov);
        s[g] = sv[0];
        o[g] = ov[0];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int m = r0 + i * RS;
        if (m >= MT) break;
        float t = 0.f;
#pragma unroll
        for (int g = 0; g < GPSG; ++g)
          t = __fadd_rn(t, __fmul_rn(pp[(g * MT + m) * COLS + col], s[g]));
        acc[i] = __fadd_rn(acc[i], t);
#pragma unroll
        for (int g = 0; g < GPSG; ++g) acc[i] = fmaf(-xg[g * MT + m], o[g], acc[i]);
      }
    }
  }
  if (n >= a.d_out) return;
  float* out = a.dst + static_cast<size_t>(blockIdx.z) * a.M * ldo;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int m = r0 + i * RS, row = m0 + m;
    if (m >= MT || row >= a.M) break;
    out[static_cast<size_t>(row) * ldo + n] = acc[i];
  }
}

enum Body { kV2m = 0, kV2t = 1, kV2p = 2 };

template <int BODY, bool BF16, int PB, bool HAS_MIN, int MT, int VEC>
void launch_body(const V2Args& a) {
  const dim3 grid((a.d_out + kColT * VEC - 1) / (kColT * VEC), (a.M + MT - 1) / MT, a.splits);
  if constexpr (BODY == kV2m)
    v2m_kernel<BF16, PB, HAS_MIN, MT, VEC><<<grid, kThreads, 0, a.stream>>>(a);
  else if constexpr (BODY == kV2t)
    v2t_kernel<BF16, PB, HAS_MIN, MT, VEC><<<grid, kThreads, 0, a.stream>>>(a);
  else
    v2p_kernel<BF16, PB, HAS_MIN, MT, VEC><<<grid, kThreads, 0, a.stream>>>(a);
}

// the tensor-core tiles of one body (bf16 operands), bm rows per block
// (32, 64 or 128); false for another bm
template <int BODY, int PB, bool HAS_MIN>
bool launch_body_mma(const V2Args& a, int bm) {
  if constexpr (BODY == kV2t) return launch_mma_tiles<GroupSumMma<PB, HAS_MIN>>(a, bm);
  else return launch_mma_tiles<GroupDotMma<PB, BODY == kV2p ? 16 : 32, HAS_MIN>>(a, bm);
}

// row tiles: MT in {1, 2, 4, 8} for VEC 4, {1, 8} for VEC 1 on the CUDA
// cores; mt of 32, 64 or 128 (VEC 4, bf16 operands) the tensor-core tiles
// with mt rows per block; kDecodeMmaTile (VEC 4, bf16 operands, v2p and
// v2t) the tensor-core decode tile (qmatmul_decode_mma.cuh, M <= 8)
template <int BODY, bool BF16, int PB, bool HAS_MIN>
bool launch_body_tile(const V2Args& a, int mt, int vec) {
  if (vec == 4) {
    switch (mt) {
      case 1: launch_body<BODY, BF16, PB, HAS_MIN, 1, 4>(a); return true;
      case 2: launch_body<BODY, BF16, PB, HAS_MIN, 2, 4>(a); return true;
      case 4: launch_body<BODY, BF16, PB, HAS_MIN, 4, 4>(a); return true;
      case 8: launch_body<BODY, BF16, PB, HAS_MIN, 8, 4>(a); return true;
      case kDecodeMmaTile:
        if constexpr (BF16 && BODY == kV2p) {
          launch_decode_mma_tile<GroupDotMma<PB, 16, HAS_MIN, kDecodePitch>>(a);
          return true;
        } else if constexpr (BF16 && BODY == kV2t) {
          launch_decode_mma_tile<GroupSumMma<PB, HAS_MIN, kDecodePitch>>(a);
          return true;
        }
        return false;
      default:
        if constexpr (BF16) return launch_body_mma<BODY, PB, HAS_MIN>(a, mt);
        return false;
    }
  }
  if (vec == 1) {
    switch (mt) {
      case 1: launch_body<BODY, BF16, PB, HAS_MIN, 1, 1>(a); return true;
      case 8: launch_body<BODY, BF16, PB, HAS_MIN, 8, 1>(a); return true;
      default: return false;
    }
  }
  return false;
}

template <bool BF16>
bool launch_body_format(const V2Args& a, int body, int per_byte, int group_size, int has_min,
                        int mt, int vec) {
  if (body == kV2m || body == kV2t) {
    if (group_size != 32 || !has_min) return false;
    if (per_byte == 2)  // Q4_K
      return body == kV2m ? launch_body_tile<kV2m, BF16, 2, true>(a, mt, vec)
                          : launch_body_tile<kV2t, BF16, 2, true>(a, mt, vec);
    if (per_byte == 1)  // Q5_K
      return body == kV2m ? launch_body_tile<kV2m, BF16, 1, true>(a, mt, vec)
                          : launch_body_tile<kV2t, BF16, 1, true>(a, mt, vec);
    return false;
  }
  if (body != kV2p || group_size != 16) return false;
  if (per_byte == 2 && has_min) return launch_body_tile<kV2p, BF16, 2, true>(a, mt, vec);  // Q2_K
  if (per_byte == 2 && !has_min)  // Q3_K
    return launch_body_tile<kV2p, BF16, 2, false>(a, mt, vec);
  if (per_byte == 1 && !has_min)  // Q6_K
    return launch_body_tile<kV2p, BF16, 1, false>(a, mt, vec);
  return false;
}

}  // namespace

// Returns 0 on success, else a cudaError_t value (cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a body, format or tile this
// file does not instantiate). body: 0 v2m, 1 v2t, 2 v2p. x is bf16 when
// x_bf16 != 0, else f32; the staged x is rounded to bf16 when
// mxu_bf16 != 0 (the codes are exact in either type). partials is
// (splits, M, d_out) f32 scratch when splits > 1, ignored otherwise. mt is
// the rows per block: 1, 2, 4, 8 on the CUDA cores; 32, 64, 128 on the
// tensor cores (vec 4 and bf16 operands only); kDecodeMmaTile (16) the
// tensor-core decode tile of v2p or v2t over all M <= 8 rows (vec 4, bf16
// operands). vec 4 needs
// d_out % 4 == 0 and 16-byte-aligned planes (the tensor-core tiles a
// 16-byte-aligned x too). Every pointer is a device pointer of contiguous
// data.
extern "C" int gg_v2m_matmul(int body, const void* x, int x_bf16, int mxu_bf16,
                             const uint8_t* qs, const float* d_sg, const float* dmin_sg,
                             const uint8_t* sc_q, const uint8_t* mn_q,
                             float* partials, float* out, int M, int d_in,
                             int d_out, int per_byte, int group_size,
                             int has_min, int shift, int d_rep, int mt, int vec,
                             int sg_per_split, int splits, void* stream) {
  const V2Args a{x, x_bf16, qs, d_sg, dmin_sg, sc_q, mn_q, splits > 1 ? partials : out,
                 M, d_in, d_out, d_rep, static_cast<float>(shift), sg_per_split,
                 splits, static_cast<cudaStream_t>(stream)};
  const bool ok = mxu_bf16
      ? launch_body_format<true>(a, body, per_byte, group_size, has_min, mt, vec)
      : launch_body_format<false>(a, body, per_byte, group_size, has_min, mt, vec);
  return finish_launch(ok, partials, out, splits, static_cast<size_t>(M) * d_out, a.stream);
}
