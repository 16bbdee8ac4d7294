"""GGML K-quant blocks -> layer codes and two-level scales.

Copy of ``gptq_gguf_tpu/formats/convert.py::unpack_layer``; the packing
direction stays in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import ggml
from .ggml import GGMLQuantizationType, KQUANT_SPECS, QK_K


def unpack_layer(
    blocks: np.ndarray, qtype: GGMLQuantizationType, shape: Tuple[int, int]
):
    """GGML blocks of a (d_row, d_col) K-quant tensor -> (qweight,
    super_scale, scale_q, super_zero, zero_q) in layer layout:
    qweight (d_row, d_col); super_* (d_row, n_sg) fp16; *_q (d_row, n_groups).
    super_zero/zero_q are zeros for the signed types."""
    spec = KQUANT_SPECS[qtype]
    d_row, d_col = shape
    n_sg = d_col // QK_K
    ng = n_sg * spec.num_groups
    flat = np.ascontiguousarray(blocks).view(np.uint8).reshape(-1, ggml.type_size(qtype))
    if qtype == GGMLQuantizationType.Q2_K:
        q, d, sc, dmin, mn = ggml.unpack_q2_k(flat)
    elif qtype == GGMLQuantizationType.Q3_K:
        q, d, sc = ggml.unpack_q3_k(flat)
        dmin = np.zeros_like(d)
        mn = np.zeros_like(sc)
    elif qtype == GGMLQuantizationType.Q4_K:
        q, d, sc, dmin, mn = ggml.unpack_q4_k(flat)
    elif qtype == GGMLQuantizationType.Q5_K:
        q, d, sc, dmin, mn = ggml.unpack_q5_k(flat)
    elif qtype == GGMLQuantizationType.Q6_K:
        q, d, sc = ggml.unpack_q6_k(flat)
        dmin = np.zeros_like(d)
        mn = np.zeros_like(sc)
    else:
        raise NotImplementedError(f"unpack_layer: {qtype!r}")
    return (
        q.reshape(d_row, d_col),
        d.astype(np.float16).reshape(d_row, n_sg),
        sc.reshape(d_row, ng),
        dmin.astype(np.float16).reshape(d_row, n_sg),
        mn.reshape(d_row, ng),
    )
