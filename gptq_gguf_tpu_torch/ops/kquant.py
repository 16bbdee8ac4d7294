"""K-quant parameter container of the port.

``SuperGroupParams`` has the same fields, in the same order, as
``gptq_gguf_tpu/ops/kquant.py::SuperGroupParams`` (which lives in a jax
module, so the port keeps its own). The fields may be numpy arrays or torch
tensors; ``qmatmul.pack_runtime_v2`` reads them through numpy.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class SuperGroupParams(NamedTuple):
    """Two-level quantization parameters of a (d_row, d_col) weight:
      super_scale: (d_row, n_sg) fp16 — per-supergroup scale of scales
      super_zero:  (d_row, n_sg) fp16 — per-supergroup scale of mins
      scale_q:     (d_row, n_groups) int — quantized group scales
      zero_q:      (d_row, n_groups) int — quantized group mins
    """

    super_scale: Any
    super_zero: Any
    scale_q: Any
    zero_q: Any
