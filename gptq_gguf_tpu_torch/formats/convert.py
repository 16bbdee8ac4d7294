"""Layer codes and two-level scales <-> GGML K-quant blocks.

Copy of ``gptq_gguf_tpu/formats/convert.py``: ``pack_layer`` writes a
quantized layer's artifact as GGML blocks (what ``pack`` puts in a GGUF),
``unpack_layer`` reads them back bit-exactly, and ``gqa_permute_rows`` is
the q / k row order that a llama GGUF stores (``pack`` applies it, the
serving loader undoes it). Large layers are packed in chunks of rows on
host threads (``by_row_chunks``): rows are independent, so the chunks'
blocks are the whole's, byte for byte.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Tuple

import numpy as np

from . import ggml
from .ggml import GGMLQuantizationType, KQUANT_SPECS, QK_K


# rows of one chunk of host work on a large tensor, a thread each (numpy
# releases the interpreter lock in its loops)
CHUNK_ROWS = 4096


def by_row_chunks(fn: Callable[[int, int], object], n_rows: int) -> List:
    """[fn(a, b)] over the row spans [a, b) of CHUNK_ROWS rows, a thread each."""
    spans = [(a, min(a + CHUNK_ROWS, n_rows)) for a in range(0, n_rows, CHUNK_ROWS)]
    if len(spans) == 1:
        return [fn(*spans[0])]
    with ThreadPoolExecutor(min(len(spans), os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda span: fn(*span), spans))


def gqa_permute_rows(n_rows: int, n_head: int) -> np.ndarray:
    """Row permutation from HF's rotate-half rope layout to GGML's
    interleaved layout (llama.cpp LlamaModel.permute): ``w_gguf =
    w_hf[perm]``; ``np.argsort(perm)`` undoes it."""
    idx = np.arange(n_rows)
    return idx.reshape(n_head, 2, n_rows // n_head // 2).swapaxes(1, 2).reshape(n_rows)


def pack_layer(qweight: np.ndarray, super_scale: np.ndarray, scale_q: np.ndarray,
               super_zero: np.ndarray, zero_q: np.ndarray,
               qtype: GGMLQuantizationType) -> np.ndarray:
    """A quantized (d_row, d_col) layer -> (n_blocks, type_size) uint8 GGML
    blocks. qweight (d_row, d_col) int codes; super_scale / super_zero
    (d_row, n_sg); scale_q / zero_q (d_row, n_groups) (the zeros are unused
    by the signed types)."""
    spec = KQUANT_SPECS[qtype]
    if qweight.shape[1] % QK_K != 0:
        raise ValueError(f"d_col {qweight.shape[1]} not divisible by {QK_K}")
    if qweight.shape[0] > CHUNK_ROWS:
        parts = by_row_chunks(lambda a, b: pack_layer(
            qweight[a:b], super_scale[a:b], scale_q[a:b], super_zero[a:b], zero_q[a:b], qtype),
            qweight.shape[0])
        return np.concatenate(parts)
    q = np.asarray(qweight).reshape(-1, QK_K)
    d = np.asarray(super_scale, dtype=np.float32).reshape(-1)
    sc = np.asarray(scale_q).reshape(-1, spec.num_groups)
    if qtype == GGMLQuantizationType.Q3_K:
        return ggml.pack_q3_k(q, d, sc)
    if qtype == GGMLQuantizationType.Q6_K:
        return ggml.pack_q6_k(q, d, sc)
    pack = {GGMLQuantizationType.Q2_K: ggml.pack_q2_k, GGMLQuantizationType.Q4_K: ggml.pack_q4_k,
            GGMLQuantizationType.Q5_K: ggml.pack_q5_k}.get(qtype)
    if pack is None:
        raise NotImplementedError(f"pack_layer: {qtype!r}")
    dmin = np.asarray(super_zero, dtype=np.float32).reshape(-1)
    mn = np.asarray(zero_q).reshape(-1, spec.num_groups)
    return pack(q, d, sc, dmin, mn)


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
