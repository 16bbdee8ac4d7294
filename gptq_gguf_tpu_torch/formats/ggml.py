"""GGML quantization types and bit-exact K-quant block unpackers.

Trimmed copy of ``gptq_gguf_tpu/formats/ggml.py``: the type table, the
K-quant specs, the packers and unpackers/dequantizers of Q2_K..Q6_K and
Q8_0 (with Q8_0's round-to-nearest quantizer, for ``pack --outtype
q8_0``), and the float passthroughs that ``GGUFReader.tensor_float``
needs. Pure numpy, byte-identical to the JAX package's blocks; the IQ
codecs and the native C++ branch stay in the JAX package.

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

# Nominal bit widths by type name, the layer database's and the search's
# budget unit (the reference's mapper/gguf_splitter.py:52-93): Q2_K and Q8_K
# differ slightly from the bits their blocks hold, as there.
NOMINAL_BITS: Dict[str, float] = {
    "F32": 32.0, "F16": 16.0, "BF16": 16.0,
    "I8": 8.0, "I16": 16.0, "I32": 32.0, "I64": 64.0,
    "Q4_0": 4.5, "Q4_1": 5.0, "Q5_0": 5.5, "Q5_1": 6.0,
    "Q8_0": 8.5, "Q8_1": 9.0,
    "Q2_K": 2.5625, "Q3_K": 3.4375, "Q4_K": 4.5, "Q5_K": 5.5,
    "Q6_K": 6.5625, "Q8_K": 8.5,
    "IQ2_XXS": 2.0625, "IQ2_XS": 2.3125, "IQ2_S": 2.5, "IQ2_M": 2.7,
    "IQ3_XXS": 3.0625, "IQ3_S": 3.44, "IQ3_M": 3.66,
    "IQ4_NL": 4.56, "IQ4_XS": 4.25, "IQ1_S": 1.5625, "IQ1_M": 1.75,
}


# llama.cpp LLAMA_FTYPE ids for general.file_type: what ``pack`` writes for
# its dominant type, and what the stitcher writes for a majority type.
FILE_TYPE_IDS: Dict[GGMLQuantizationType, int] = {
    GGMLQuantizationType.Q2_K: 10,
    GGMLQuantizationType.Q3_K: 12,  # MOSTLY_Q3_K_M
    GGMLQuantizationType.Q4_K: 15,  # MOSTLY_Q4_K_M
    GGMLQuantizationType.Q5_K: 17,  # MOSTLY_Q5_K_M
    GGMLQuantizationType.Q6_K: 18,
    GGMLQuantizationType.F16: 1,
    GGMLQuantizationType.F32: 0,
    GGMLQuantizationType.BF16: 32,
    GGMLQuantizationType.Q8_0: 7,
}


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


# ---------------------------------------------------------------------------
# Packers: the inverse of the unpackers above (llama.cpp block layouts)
# ---------------------------------------------------------------------------


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    """(n,) float -> (n, 2) uint8 little-endian fp16 bytes."""
    return np.ascontiguousarray(x.astype(np.float16)).view(np.uint8).reshape(-1, 2)


def pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """(n, 8) 6-bit scales and mins -> (n, 12) bytes: bytes 0-3 hold sc[0:4]
    with sc[4:8]'s high 2 bits in bits 6-7, bytes 4-7 likewise for mn,
    bytes 8-11 sc[4:8]'s low nibble | mn[4:8]'s low nibble << 4."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros((sc.shape[0], 12), dtype=np.uint8)
    out[:, 0:4] = (sc[:, 0:4] & 63) | ((sc[:, 4:8] >> 4) << 6)
    out[:, 4:8] = (mn[:, 0:4] & 63) | ((mn[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:8] & 0x0F) | ((mn[:, 4:8] & 0x0F) << 4)
    return out


def _pack_2bit_lanes(q: np.ndarray) -> np.ndarray:
    """(n, 256) values in [0,3] -> (n, 64) bytes (the layout
    ``_unpack_2bit_lanes`` reads)."""
    v = q.reshape(-1, 2, 4, 32).astype(np.uint16)
    shifts = (2 * np.arange(4, dtype=np.uint16))[None, None, :, None]
    return (v << shifts).sum(axis=2).astype(np.uint8).reshape(-1, 64)


def pack_q2_k(q: np.ndarray, d: np.ndarray, sc: np.ndarray, dmin: np.ndarray,
              mn: np.ndarray) -> np.ndarray:
    """q (n, 256) in [0,3]; d / dmin (n,) stored fp16; sc / mn (n, 16)
    4-bit group scales / mins -> (n, 84) bytes."""
    scales = (sc.astype(np.uint8) & 0x0F) | ((mn.astype(np.uint8) & 0x0F) << 4)
    return np.concatenate([scales, _pack_2bit_lanes(q), _f16_bytes(d), _f16_bytes(dmin)],
                          axis=1)


def _pack_q3_scales(sc6: np.ndarray) -> np.ndarray:
    """(n, 16) 6-bit values -> (n, 12) bytes: low nibbles in bytes 0-7, the
    high 2 bits of value j in byte 8 + j % 4 at bit 2 * (j // 4)."""
    sc6 = sc6.astype(np.uint8)
    out = np.zeros((sc6.shape[0], 12), dtype=np.uint8)
    lo = sc6 & 0x0F
    hi = (sc6 >> 4) & 0x03
    out[:, 0:8] = lo[:, 0:8] | (lo[:, 8:16] << 4)
    for j in range(16):
        out[:, 8 + (j % 4)] |= hi[:, j] << (2 * (j // 4))
    return out


def pack_q3_k(q_signed: np.ndarray, d: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """q_signed (n, 256) in [-4, 3]; d (n,); sc (n, 16) in [-32, 31], stored
    + 32 -> (n, 110) bytes."""
    L = (q_signed.astype(np.int16) + 4).astype(np.uint8)  # 0..7
    hbit = (L > 3).astype(np.uint8)
    low = np.where(L > 3, L - 4, L)
    shifts = np.arange(8, dtype=np.uint16)[None, :, None]
    hmask = (hbit.reshape(-1, 8, 32).astype(np.uint16) << shifts).sum(axis=1).astype(np.uint8)
    scales = _pack_q3_scales(sc.astype(np.int16) + 32)
    return np.concatenate([hmask, _pack_2bit_lanes(low), scales, _f16_bytes(d)], axis=1)


def _pack_nibble_pairs(q: np.ndarray) -> np.ndarray:
    """(n, 256) 4-bit values -> (n, 128): per 64-chunk, the first 32 in the
    low nibbles."""
    v = q.reshape(-1, 4, 2, 32).astype(np.uint8)
    return (v[:, :, 0, :] | (v[:, :, 1, :] << 4)).reshape(-1, 128)


def pack_q4_k(q: np.ndarray, d: np.ndarray, sc: np.ndarray, dmin: np.ndarray,
              mn: np.ndarray) -> np.ndarray:
    """q (n, 256) in [0,15]; d / dmin (n,); sc / mn (n, 8) 6-bit -> (n, 144)."""
    return np.concatenate([_f16_bytes(d), _f16_bytes(dmin), pack_scale_min_k4(sc, mn),
                           _pack_nibble_pairs(q)], axis=1)


def pack_q5_k(q: np.ndarray, d: np.ndarray, sc: np.ndarray, dmin: np.ndarray,
              mn: np.ndarray) -> np.ndarray:
    """q (n, 256) in [0,31]: bit 4 in qh (chunk c, half h -> bit 2c + h),
    the low nibbles in ql -> (n, 176)."""
    hi = (q.reshape(-1, 4, 2, 32).astype(np.uint8) >> 4).astype(np.uint16)
    shifts = (2 * np.arange(4, dtype=np.uint16))[None, :, None, None] + np.arange(
        2, dtype=np.uint16)[None, None, :, None]
    qh = (hi << shifts).sum(axis=(1, 2)).astype(np.uint8)
    return np.concatenate([_f16_bytes(d), _f16_bytes(dmin), pack_scale_min_k4(sc, mn), qh,
                           _pack_nibble_pairs(q & 0x0F)], axis=1)


def pack_q6_k(q_signed: np.ndarray, d: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """q_signed (n, 256) in [-32, 31]; sc (n, 16) int8, stored raw ->
    (n, 210)."""
    v = (q_signed.astype(np.int16) + 32).astype(np.uint8).reshape(-1, 2, 4, 32)  # 0..63
    lo = v & 0x0F
    hi = (v >> 4).astype(np.uint16)  # 2 bits
    # ql, per 128-chunk: [l] = lo0 | lo2 << 4, [32 + l] = lo1 | lo3 << 4
    ql = np.concatenate([lo[:, :, 0, :] | (lo[:, :, 2, :] << 4),
                         lo[:, :, 1, :] | (lo[:, :, 3, :] << 4)], axis=2).reshape(-1, 128)
    shifts = (2 * np.arange(4, dtype=np.uint16))[None, None, :, None]
    qh = (hi << shifts).sum(axis=2).astype(np.uint8).reshape(-1, 64)
    return np.concatenate([ql, qh, sc.astype(np.int8).view(np.uint8), _f16_bytes(d)], axis=1)


def pack_q8_0(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """q (n, 32) int8, d (n,) -> (n, 34)."""
    return np.concatenate([_f16_bytes(d), q.astype(np.int8).view(np.uint8)], axis=1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest Q8_0 of (n, 32) floats -> (n, 34) bytes."""
    d = (np.abs(x).max(axis=1) / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(np.round(x * inv[:, None]), -128, 127).astype(np.int8)
    return pack_q8_0(q, d)


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
