// The v2 and v2f kernel variants: builds kV2 and kV2f of the per-weight
// dequant-matmul kernel in qmatmul_v2_weight.cuh (what each computes, and
// why its f32 weight equals dequantize_runtime_v2 bit for bit, is written
// there), their tensor-core prefill tiles (qmatmul_v2_mma.cuh) and v2's
// tensor-core decode tile (qmatmul_decode_mma.cuh, through the same
// header; v2f's decode steps stay on the CUDA-core tile). Built
// by gptq_gguf_tpu_torch/ops/cuda_build.py into a shared library with a
// plain C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmatmul.py::dequant_matmul_v2_exact / _v2f.
//
// Replaces: gptq_gguf_tpu/ops/qmatmul.py::_kernel_v2 (GG_PALLAS_V2_VARIANT=v2:
// the build bit-matched to the f32 reference, offset in every weight) and
// ::_kernel_v2f (GG_PALLAS_V2_VARIANT=v2f: the signed shift folded into the
// group offset, scale * q - off2 per weight).

#include "qmatmul_v2_weight.cuh"
#include "qmatmul_v2_mma.cuh"

GG_V2_WEIGHT_ENTRY(gg_v2_matmul, kV2, kV2f)
