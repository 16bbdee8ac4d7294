"""GGML quantization types and bit-exact K-quant block unpackers.

Trimmed copy of ``gptq_gguf_tpu/formats/ggml.py``: the type table, the
K-quant specs, the unpackers/dequantizers of Q2_K..Q6_K and Q8_0, and the
float passthroughs that ``GGUFReader.tensor_float`` needs. Pure numpy; the
packers, the IQ codecs and the native C++ branch stay in the JAX package.

Block layouts (QK_K = 256):
  Q2_K  84B: scales u8[16] | qs u8[64] | d f16 | dmin f16
  Q3_K 110B: hmask u8[32] | qs u8[64] | scales u8[12] | d f16
  Q4_K 144B: d f16 | dmin f16 | scales u8[12] | qs u8[128]
  Q5_K 176B: d f16 | dmin f16 | scales u8[12] | qh u8[32] | qs u8[128]
  Q6_K 210B: ql u8[128] | qh u8[64] | scales i8[16] | d f16
  Q8_0  34B: d f16 | qs i8[32]
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Dict, Tuple

import numpy as np

QK_K = 256


class GGMLQuantizationType(IntEnum):
    """GGML tensor dtypes (ids follow the GGML on-disk format)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


# (elements per block, bytes per block) — every type a GGUF may hold, so
# the reader can size tensors it cannot decode
GGML_BLOCK_SIZES: Dict[GGMLQuantizationType, Tuple[int, int]] = {
    GGMLQuantizationType.F32: (1, 4),
    GGMLQuantizationType.F16: (1, 2),
    GGMLQuantizationType.BF16: (1, 2),
    GGMLQuantizationType.F64: (1, 8),
    GGMLQuantizationType.I8: (1, 1),
    GGMLQuantizationType.I16: (1, 2),
    GGMLQuantizationType.I32: (1, 4),
    GGMLQuantizationType.I64: (1, 8),
    GGMLQuantizationType.Q4_0: (32, 18),
    GGMLQuantizationType.Q4_1: (32, 20),
    GGMLQuantizationType.Q5_0: (32, 22),
    GGMLQuantizationType.Q5_1: (32, 24),
    GGMLQuantizationType.Q8_0: (32, 34),
    GGMLQuantizationType.Q8_1: (32, 36),
    GGMLQuantizationType.Q2_K: (QK_K, 84),
    GGMLQuantizationType.Q3_K: (QK_K, 110),
    GGMLQuantizationType.Q4_K: (QK_K, 144),
    GGMLQuantizationType.Q5_K: (QK_K, 176),
    GGMLQuantizationType.Q6_K: (QK_K, 210),
    GGMLQuantizationType.Q8_K: (QK_K, 292),
    GGMLQuantizationType.IQ4_NL: (32, 18),
    GGMLQuantizationType.IQ4_XS: (QK_K, 136),
    GGMLQuantizationType.IQ2_XXS: (QK_K, 66),
    GGMLQuantizationType.IQ2_XS: (QK_K, 74),
    GGMLQuantizationType.IQ2_S: (QK_K, 82),
    GGMLQuantizationType.IQ3_XXS: (QK_K, 98),
    GGMLQuantizationType.IQ3_S: (QK_K, 110),
    GGMLQuantizationType.IQ1_S: (QK_K, 50),
    GGMLQuantizationType.IQ1_M: (QK_K, 56),
}


@dataclasses.dataclass(frozen=True)
class KQuantSpec:
    """Parameters of one K-quant type."""

    bits: int
    qmin: int  # clamp range for quantized weights
    qmax: int
    scale_maxq: int  # max value of the quantized group scale
    group_size: int  # elements sharing one quantized scale
    super_group_size: int  # elements sharing one fp16 super-scale
    signed: bool  # signed qweights (Q3_K / Q6_K) vs unsigned

    @property
    def num_groups(self) -> int:
        return self.super_group_size // self.group_size


KQUANT_SPECS: Dict[GGMLQuantizationType, KQuantSpec] = {
    GGMLQuantizationType.Q2_K: KQuantSpec(2, 0, 3, 15, 16, QK_K, False),
    GGMLQuantizationType.Q3_K: KQuantSpec(3, -4, 3, 31, 16, QK_K, True),
    GGMLQuantizationType.Q4_K: KQuantSpec(4, 0, 15, 63, 32, QK_K, False),
    GGMLQuantizationType.Q5_K: KQuantSpec(5, 0, 31, 63, 32, QK_K, False),
    GGMLQuantizationType.Q6_K: KQuantSpec(6, -32, 31, 63, 16, QK_K, True),
}

K_QUANT_TYPES = tuple(KQUANT_SPECS)


def type_size(qtype: GGMLQuantizationType) -> int:
    return GGML_BLOCK_SIZES[qtype][1]


def row_nbytes(qtype: GGMLQuantizationType, n_elems: int) -> int:
    be, ts = GGML_BLOCK_SIZES[qtype]
    if n_elems % be != 0:
        raise ValueError(f"{n_elems} not divisible by block size {be} for {qtype.name}")
    return n_elems // be * ts


def _f16_from_bytes(b: np.ndarray) -> np.ndarray:
    """(n, 2) uint8 -> (n,) float32."""
    return np.ascontiguousarray(b).view(np.float16).reshape(-1).astype(np.float32)


def unpack_scale_min_k4(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 12) uint8 -> ((n, 8), (n, 8)) uint8 scales and mins in [0, 63]
    (llama.cpp get_scale_min_k4, shared by Q4_K / Q5_K)."""
    b = packed.astype(np.uint8)
    sc = np.empty((b.shape[0], 8), dtype=np.uint8)
    mn = np.empty_like(sc)
    sc[:, 0:4] = b[:, 0:4] & 63
    mn[:, 0:4] = b[:, 4:8] & 63
    sc[:, 4:8] = (b[:, 8:12] & 0x0F) | ((b[:, 0:4] >> 6) << 4)
    mn[:, 4:8] = (b[:, 8:12] >> 4) | ((b[:, 4:8] >> 6) << 4)
    return sc, mn


def _unpack_2bit_lanes(b: np.ndarray) -> np.ndarray:
    """(n, 64) bytes -> (n, 256) values in [0,3]; position
    chunk*128 + sub*32 + l sits in byte [chunk*32 + l] at bits 2*sub."""
    v = b.reshape(-1, 2, 1, 32)
    shifts = (2 * np.arange(4))[None, None, :, None]
    return ((v >> shifts) & 3).reshape(-1, 256).astype(np.uint8)


def _unpack_q3_scales(b: np.ndarray) -> np.ndarray:
    """(n, 12) bytes -> (n, 16) 6-bit values."""
    b = b.astype(np.uint8)
    lo = np.concatenate([b[:, 0:8] & 0x0F, b[:, 0:8] >> 4], axis=1)
    hi = np.empty_like(lo)
    for j in range(16):
        hi[:, j] = (b[:, 8 + (j % 4)] >> (2 * (j // 4))) & 0x03
    return lo | (hi << 4)


def _unpack_nibble_pairs(b: np.ndarray) -> np.ndarray:
    """(n, 128) -> (n, 256) 4-bit values: per 64-chunk, 32 low nibbles then
    32 high nibbles."""
    v = b.reshape(-1, 4, 1, 32)
    out = np.concatenate([v & 0x0F, v >> 4], axis=2)
    return out.reshape(-1, 256).astype(np.uint8)


def unpack_q2_k(blocks: np.ndarray):
    """(n, 84) uint8 -> (q (n,256) u8, d (n,) f32, sc (n,16) u8, dmin (n,), mn (n,16) u8)."""
    b = blocks.reshape(-1, 84)
    sc = b[:, 0:16] & 0x0F
    mn = b[:, 0:16] >> 4
    q = _unpack_2bit_lanes(b[:, 16:80])
    d = _f16_from_bytes(b[:, 80:82])
    dmin = _f16_from_bytes(b[:, 82:84])
    return q, d, sc, dmin, mn


def dequant_q2_k(blocks: np.ndarray) -> np.ndarray:
    q, d, sc, dmin, mn = unpack_q2_k(blocks)
    scale = d[:, None] * sc.astype(np.float32)
    off = dmin[:, None] * mn.astype(np.float32)
    qv = q.reshape(-1, 16, 16).astype(np.float32)
    return (scale[:, :, None] * qv - off[:, :, None]).reshape(-1, QK_K).astype(np.float32)


def unpack_q3_k(blocks: np.ndarray):
    """(n, 110) -> (q_signed (n,256) i8, d (n,) f32, sc (n,16) i8 in [-32,31])."""
    b = blocks.reshape(-1, 110)
    hmask = b[:, 0:32]
    shifts = np.arange(8)[None, :, None]
    hbit = ((hmask[:, None, :] >> shifts) & 1).reshape(-1, 256)
    low = _unpack_2bit_lanes(b[:, 32:96])
    q = low.astype(np.int8) + (hbit.astype(np.int8) - 1) * 4  # low + (bit?0:-4)
    sc = (_unpack_q3_scales(b[:, 96:108]).astype(np.int16) - 32).astype(np.int8)
    d = _f16_from_bytes(b[:, 108:110])
    return q, d, sc


def dequant_q3_k(blocks: np.ndarray) -> np.ndarray:
    q, d, sc = unpack_q3_k(blocks)
    scale = d[:, None] * sc.astype(np.float32)
    qv = q.reshape(-1, 16, 16).astype(np.float32)
    return (scale[:, :, None] * qv).reshape(-1, QK_K).astype(np.float32)


def unpack_q4_k(blocks: np.ndarray):
    b = blocks.reshape(-1, 144)
    d = _f16_from_bytes(b[:, 0:2])
    dmin = _f16_from_bytes(b[:, 2:4])
    sc, mn = unpack_scale_min_k4(b[:, 4:16])
    q = _unpack_nibble_pairs(b[:, 16:144])
    return q, d, sc, dmin, mn


def dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    q, d, sc, dmin, mn = unpack_q4_k(blocks)
    scale = d[:, None] * sc.astype(np.float32)
    off = dmin[:, None] * mn.astype(np.float32)
    qv = q.reshape(-1, 8, 32).astype(np.float32)
    return (scale[:, :, None] * qv - off[:, :, None]).reshape(-1, QK_K).astype(np.float32)


def unpack_q5_k(blocks: np.ndarray):
    b = blocks.reshape(-1, 176)
    d = _f16_from_bytes(b[:, 0:2])
    dmin = _f16_from_bytes(b[:, 2:4])
    sc, mn = unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]
    ql = _unpack_nibble_pairs(b[:, 48:176]).reshape(-1, 4, 2, 32)
    shifts = (2 * np.arange(4))[None, :, None, None] + np.arange(2)[None, None, :, None]
    hi = ((qh[:, None, None, :] >> shifts) & 1).astype(np.uint8)
    q = (ql | (hi << 4)).reshape(-1, 256)
    return q, d, sc, dmin, mn


def dequant_q5_k(blocks: np.ndarray) -> np.ndarray:
    q, d, sc, dmin, mn = unpack_q5_k(blocks)
    scale = d[:, None] * sc.astype(np.float32)
    off = dmin[:, None] * mn.astype(np.float32)
    qv = q.reshape(-1, 8, 32).astype(np.float32)
    return (scale[:, :, None] * qv - off[:, :, None]).reshape(-1, QK_K).astype(np.float32)


def unpack_q6_k(blocks: np.ndarray):
    b = blocks.reshape(-1, 210)
    ql = b[:, 0:128].reshape(-1, 2, 2, 32)
    lo = np.stack(
        [ql[:, :, 0, :] & 0x0F, ql[:, :, 1, :] & 0x0F, ql[:, :, 0, :] >> 4, ql[:, :, 1, :] >> 4],
        axis=2,
    )  # (n, 2, 4, 32)
    qh = b[:, 128:192].reshape(-1, 2, 1, 32)
    shifts = (2 * np.arange(4))[None, None, :, None]
    hi = ((qh >> shifts) & 3).astype(np.uint8)
    q = (lo | (hi << 4)).reshape(-1, 256).astype(np.int16) - 32
    sc = np.ascontiguousarray(b[:, 192:208]).view(np.int8)
    d = _f16_from_bytes(b[:, 208:210])
    return q.astype(np.int8), d, sc.reshape(-1, 16)


def dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    q, d, sc = unpack_q6_k(blocks)
    scale = d[:, None] * sc.astype(np.float32)
    qv = q.reshape(-1, 16, 16).astype(np.float32)
    return (scale[:, :, None] * qv).reshape(-1, QK_K).astype(np.float32)


def unpack_q8_0(blocks: np.ndarray):
    b = blocks.reshape(-1, 34)
    d = _f16_from_bytes(b[:, 0:2])
    q = np.ascontiguousarray(b[:, 2:34]).view(np.int8)
    return q, d


def dequant_q8_0(blocks: np.ndarray) -> np.ndarray:
    q, d = unpack_q8_0(blocks)
    return (d[:, None] * q.astype(np.float32)).astype(np.float32)


_DEQUANT = {
    GGMLQuantizationType.Q2_K: dequant_q2_k,
    GGMLQuantizationType.Q3_K: dequant_q3_k,
    GGMLQuantizationType.Q4_K: dequant_q4_k,
    GGMLQuantizationType.Q5_K: dequant_q5_k,
    GGMLQuantizationType.Q6_K: dequant_q6_k,
    GGMLQuantizationType.Q8_0: dequant_q8_0,
}


def dequantize(data: np.ndarray, qtype: GGMLQuantizationType, shape: Tuple[int, ...]) -> np.ndarray:
    """Dequantize raw GGML bytes to float32 of the given numpy-order shape
    (last axis = GGML's contiguous ne[0])."""
    if qtype == GGMLQuantizationType.F32:
        return np.ascontiguousarray(data).view(np.float32).reshape(shape).copy()
    if qtype == GGMLQuantizationType.F16:
        return np.ascontiguousarray(data).view(np.float16).reshape(shape).astype(np.float32)
    if qtype == GGMLQuantizationType.BF16:
        raw = np.ascontiguousarray(data).view(np.uint16).astype(np.uint32) << 16
        return raw.view(np.float32).reshape(shape)
    fn = _DEQUANT.get(qtype)
    if fn is None:
        raise NotImplementedError(f"dequantize not implemented for {qtype!r}")
    flat = np.ascontiguousarray(data).view(np.uint8).reshape(-1, type_size(qtype))
    return fn(flat).reshape(shape)
