// The v2g and v2s kernel variants: builds kV2g and kV2s of the per-weight
// dequant-matmul kernel in qmatmul_v2_weight.cuh (what each computes, and
// why it is exact, is written there), the tensor-core prefill tiles of
// both (qmatmul_v2_mma.cuh) and v2g's tensor-core decode tile
// (qmatmul_decode_mma.cuh, through the same header). Built by
// gptq_gguf_tpu_torch/ops/cuda_build.py into a shared library with a plain
// C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmatmul.py::dequant_matmul_v2g / _v2s.
//
// Replaces: gptq_gguf_tpu/ops/qmatmul.py::_kernel_v2g (the default variant
// of dequant_matmul_pallas_v2, which carries every projection and the
// lm_head of the serving path) and ::_kernel_v2s (GG_PALLAS_V2_VARIANT=v2s:
// v2g's weights with the nibble halves dotted apart).

#include "qmatmul_v2_weight.cuh"
#include "qmatmul_v2_mma.cuh"

GG_V2_WEIGHT_ENTRY(gg_v2g_matmul, kV2g, kV2s)
