// Timing probes of v2g's tensor-core decode tile (qmatmul_decode_mma.cuh):
// the same kernel with parts of its work left out, for Q4_K and Q6_K
// weights (every call of a Llama-3-8B decode step). Its results are wrong
// by design: no path of the package binds this library, and only
// tools/time_v2_kernels.py --probe builds and times it, beside the tile, to
// split the tile's time into its parts (PERF.md). Probe 1 takes raw code
// words as the A fragments (no dequantization); probe 2 also stages no
// planes (x is still staged, its group sums still taken).

#include "qmatmul_v2_weight.cuh"
#include "qmatmul_v2_mma.cuh"

namespace {

template <int PROBE>
bool launch_probe(const V2Args& a, int per_byte, int group_size, int has_min) {
  if (per_byte == 2 && group_size == 32 && has_min) {  // Q4_K
    launch_decode_mma_tile<V2Mma<kV2g, 2, 32, true, kDecodePitch>, PROBE>(a);
    return true;
  }
  if (per_byte == 1 && group_size == 16 && !has_min) {  // Q6_K
    launch_decode_mma_tile<V2Mma<kV2g, 1, 16, false, kDecodePitch>, PROBE>(a);
    return true;
  }
  return false;
}

}  // namespace

// The signature of GG_V2_WEIGHT_ENTRY (qmatmul_v2_weight.cuh); build is the
// probe (1 or 2), and only the decode tile's launch (mt kDecodeMmaTile, vec
// 4, bf16 operands) is taken. Returns 0 on success, else a cudaError_t.
extern "C" int gg_v2g_probe_matmul(int build, const void* x, int x_bf16, int mxu_bf16,
                                   const uint8_t* qs, const float* d_sg, const float* dmin_sg,
                                   const uint8_t* sc_q, const uint8_t* mn_q, float* partials,
                                   float* out, int M, int d_in, int d_out, int per_byte,
                                   int group_size, int has_min, int shift, int d_rep, int mt,
                                   int vec, int sg_per_split, int splits, void* stream) {
  const V2Args a{x, x_bf16, qs, d_sg, dmin_sg, sc_q, mn_q, splits > 1 ? partials : out,
                 M, d_in, d_out, d_rep, static_cast<float>(shift), sg_per_split,
                 splits, static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (mt == kDecodeMmaTile && vec == 4 && mxu_bf16) {
    if (build == 1) ok = launch_probe<1>(a, per_byte, group_size, has_min);
    if (build == 2) ok = launch_probe<2>(a, per_byte, group_size, has_min);
  }
  return finish_launch(ok, partials, out, splits, static_cast<size_t>(M) * d_out, a.stream);
}
