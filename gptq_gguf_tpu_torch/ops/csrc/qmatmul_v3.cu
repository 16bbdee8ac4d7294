// The v3 and v2h kernel variants: builds kV3 and kV2h of the per-weight
// dequant-matmul kernel in qmatmul_v2_weight.cuh (what each computes is
// written there), their tensor-core prefill tiles (qmatmul_v2_mma.cuh) and
// their tensor-core decode tiles (qmatmul_decode_mma.cuh, through the same
// header; both form their weights in packed bf16 arithmetic there).
// Built by gptq_gguf_tpu_torch/ops/cuda_build.py into a shared library with
// a plain C interface, bound with ctypes by
// gptq_gguf_tpu_torch/ops/qmatmul.py::dequant_matmul_v3 / _v2h.
//
// Replaces: gptq_gguf_tpu/ops/qmatmul.py::_kernel_v3 (GG_PALLAS_V2_VARIANT=v3:
// the weight as T(q) * T(scale) in the operand type, the offset as the xsum
// term; JAX forms xsum by an in-kernel 0/1 dot, this kernel while staging
// x) and ::_kernel_v2h (GG_PALLAS_V2_VARIANT=v2h: the affine
// T(scale) * T(q) - T(off2) in the operand type, each step rounded).

#include "qmatmul_v2_weight.cuh"
#include "qmatmul_v2_mma.cuh"

GG_V2_WEIGHT_ENTRY(gg_v3_matmul, kV3, kV2h)
