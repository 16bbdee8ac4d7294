"""GGUF v2/v3 container reader (memory-mapped, little-endian).

Copy of the reader half of ``gptq_gguf_tpu/formats/gguf.py``: header,
typed KV metadata, tensor infos and aligned tensor data. The serving path
only reads GGUFs; the writer stays in the JAX package.
"""

from __future__ import annotations

import dataclasses
import struct
from enum import IntEnum
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .ggml import GGMLQuantizationType, dequantize, row_nbytes

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclasses.dataclass
class GGUFValue:
    """A typed metadata value."""

    type: GGUFValueType
    value: Any
    elem_type: Optional[GGUFValueType] = None  # for arrays


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]  # numpy order (row-major, last axis contiguous)
    ggml_type: GGMLQuantizationType
    offset: int  # relative to start of tensor-data section
    nbytes: int


class _Cursor:
    def __init__(self, buf: np.memmap):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def string(self) -> str:
        n = self.u64()
        return self.read(n).decode("utf-8", errors="replace")


class GGUFReader:
    """Memory-mapped GGUF reader: ``metadata`` (name -> GGUFValue),
    ``tensors`` (name -> GGUFTensorInfo), ``tensor_order``, raw byte access
    and dequantized float32 access."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._mm = np.memmap(self.path, mode="r", dtype=np.uint8)
        cur = _Cursor(self._mm)
        magic = cur.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.u32()
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = cur.u64()
        n_kv = cur.u64()
        self.metadata: Dict[str, GGUFValue] = {}
        for _ in range(n_kv):
            key = cur.string()
            vtype = GGUFValueType(cur.u32())
            self.metadata[key] = self._read_value(cur, vtype)
        self.alignment = int(self.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        order: List[str] = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.u32()
            # GGUF stores dims as ne[0..n) with ne[0] the contiguous axis;
            # numpy order is the reverse.
            ne = [cur.u64() for _ in range(n_dims)]
            ggml_type = GGMLQuantizationType(cur.u32())
            offset = cur.u64()
            shape = tuple(reversed(ne))
            nbytes = self._tensor_nbytes(ggml_type, ne)
            self.tensors[name] = GGUFTensorInfo(name, shape, ggml_type, offset, nbytes)
            order.append(name)
        self.tensor_order = order
        self.data_start = cur.pos + (-cur.pos % self.alignment)

    @staticmethod
    def _tensor_nbytes(ggml_type: GGMLQuantizationType, ne: Sequence[int]) -> int:
        rows = 1
        for s in ne[1:]:
            rows *= int(s)
        return rows * row_nbytes(ggml_type, int(ne[0]) if ne else 1)

    def _read_value(self, cur: _Cursor, vtype: GGUFValueType) -> GGUFValue:
        if vtype == GGUFValueType.STRING:
            return GGUFValue(vtype, cur.string())
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(cur.u32())
            n = cur.u64()
            if etype == GGUFValueType.STRING:
                vals = [cur.string() for _ in range(n)]
            elif etype == GGUFValueType.ARRAY:
                vals = [self._read_value(cur, GGUFValueType.ARRAY) for _ in range(n)]
            else:
                fmt = _SCALAR_FMT[etype]
                raw = cur.read(struct.calcsize(fmt) * n)
                vals = [v[0] for v in struct.iter_unpack(fmt, raw)]
            return GGUFValue(vtype, vals, elem_type=etype)
        fmt = _SCALAR_FMT[vtype]
        (val,) = struct.unpack(fmt, cur.read(struct.calcsize(fmt)))
        return GGUFValue(vtype, val)

    def get(self, key: str, default: Any = None) -> Any:
        v = self.metadata.get(key)
        return default if v is None else v.value

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw GGML bytes of a tensor as a zero-copy uint8 view."""
        info = self.tensors[name]
        start = self.data_start + info.offset
        return self._mm[start : start + info.nbytes]

    def tensor_float(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in numpy (row-major) shape."""
        info = self.tensors[name]
        return dequantize(self.tensor_bytes(name), info.ggml_type, info.shape)

    def close(self) -> None:
        del self._mm
