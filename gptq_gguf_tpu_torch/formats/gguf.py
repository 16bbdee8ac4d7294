"""GGUF v2/v3 container reader (memory-mapped) and v3 writer, little-endian.

Copy of ``gptq_gguf_tpu/formats/gguf.py``: header, typed KV metadata,
tensor infos and aligned tensor data. The writer streams payloads of
1 MiB or more through a spill file beside the output, so a multi-GB model
never sits in host memory whole, and writes the JAX package's bytes for
the same calls.
"""

from __future__ import annotations

import dataclasses
import struct
from enum import IntEnum
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ggml import GGMLQuantizationType, dequantize, row_nbytes

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
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


def _guess_value_type(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        if value < 0:
            return GGUFValueType.INT64 if value < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if value >= 2**32 else GGUFValueType.UINT32
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, (str, bytes)):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


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


# numpy dtype -> the GGML type of an unquantized tensor
_FLOAT_TYPES = {np.dtype(np.float32): GGMLQuantizationType.F32,
                np.dtype(np.float16): GGMLQuantizationType.F16,
                np.dtype(np.int32): GGMLQuantizationType.I32,
                np.dtype(np.int64): GGMLQuantizationType.I64}


class GGUFWriter:
    """Streaming GGUF v3 writer: add metadata (``add_kv``) and tensors
    (``add_tensor``), then ``write()``. Keys keep their first insertion's
    position; adding a key again replaces its value there."""

    SPILL_THRESHOLD = 1 << 20  # payloads >= 1 MiB stream to a temp data file

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._kv: Dict[str, GGUFValue] = {}
        # payload: uint8 bytes (small) or (spill offset, nbytes)
        self._tensors: List[Tuple[str, Tuple[int, ...], GGMLQuantizationType, Any]] = []
        self._spill_path = self.path.with_name(self.path.name + ".data.tmp")
        self._spill_file: Optional[BinaryIO] = None
        self._spill_offset = 0

    def _spill(self, payload: np.ndarray) -> Tuple[int, int]:
        if self._spill_file is None:
            self._spill_path.parent.mkdir(parents=True, exist_ok=True)
            self._spill_file = open(self._spill_path, "wb")
        off = self._spill_offset
        self._spill_file.write(payload.tobytes())
        self._spill_offset += payload.nbytes
        return (off, payload.nbytes)

    def add_kv(self, key: str, value: Any) -> None:
        """A GGUFValue is stored as given; other values get the type
        ``_guess_value_type`` infers (an array's from its first element, INT32
        if it is empty or holds a negative int)."""
        if isinstance(value, GGUFValue):
            self._kv[key] = value
            return
        vtype = _guess_value_type(value)
        elem_type = None
        if vtype == GGUFValueType.ARRAY:
            if len(value) == 0:
                elem_type = GGUFValueType.INT32
            else:
                elem_type = _guess_value_type(value[0])
                if elem_type == GGUFValueType.UINT32 and any(
                        isinstance(v, int) and v < 0 for v in value):
                    elem_type = GGUFValueType.INT32
        self._kv[key] = GGUFValue(vtype, value, elem_type=elem_type)

    def add_tensor(self, name: str, data, raw_dtype: Optional[GGMLQuantizationType] = None,
                   raw_shape: Optional[Tuple[int, ...]] = None) -> None:
        """Declare a tensor. With ``raw_dtype``, ``data`` is GGML bytes (or
        their bits, as BF16's uint16) of the numpy-order shape ``raw_shape``
        (default: data's). Otherwise the type follows the dtype: f32, f16,
        i32, i64, and bf16 as a ``torch.bfloat16`` tensor."""
        if isinstance(data, torch.Tensor):
            if data.dtype == torch.bfloat16:
                raw_shape = tuple(data.shape) if raw_shape is None else raw_shape
                raw_dtype = GGMLQuantizationType.BF16
                data = data.contiguous().view(torch.int16).numpy()
            else:
                data = data.numpy()
        if raw_dtype is not None:
            shape = tuple(int(s) for s in (raw_shape if raw_shape is not None else data.shape))
            ggml_type = raw_dtype
            payload = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
            expected = GGUFReader._tensor_nbytes(ggml_type, list(reversed(shape)))
            if payload.nbytes != expected:
                raise ValueError(
                    f"tensor {name}: raw bytes {payload.nbytes} != expected {expected} "
                    f"for {ggml_type.name} shape {shape}")
        else:
            ggml_type = _FLOAT_TYPES.get(data.dtype)
            if ggml_type is None:
                raise TypeError(f"tensor {name}: unsupported dtype {data.dtype}")
            shape = tuple(int(s) for s in data.shape)
            payload = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        if payload.nbytes >= self.SPILL_THRESHOLD:
            payload = self._spill(payload)
        self._tensors.append((name, shape, ggml_type, payload))

    @staticmethod
    def _write_string(f: BinaryIO, s: Union[str, bytes]) -> None:
        b = s.encode("utf-8") if isinstance(s, str) else s
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, v: GGUFValue) -> None:
        if v.type == GGUFValueType.STRING:
            self._write_string(f, v.value)
        elif v.type == GGUFValueType.ARRAY:
            f.write(struct.pack("<I", int(v.elem_type)))
            f.write(struct.pack("<Q", len(v.value)))
            if v.elem_type == GGUFValueType.STRING:
                for s in v.value:
                    self._write_string(f, s)
            elif v.elem_type == GGUFValueType.ARRAY:
                for sub in v.value:
                    self._write_value(f, sub)
            else:
                fmt = _SCALAR_FMT[v.elem_type]
                f.write(b"".join(struct.pack(fmt, x) for x in v.value))
        else:
            f.write(struct.pack(_SCALAR_FMT[v.type], v.value))

    def write(self) -> None:
        """Header, metadata, tensor infos at aligned offsets, then the data;
        the spill file is deleted afterwards."""
        align = GGUF_DEFAULT_ALIGNMENT

        def nbytes(payload) -> int:
            return payload[1] if isinstance(payload, tuple) else payload.nbytes

        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors),
                                len(self._kv)))
            for key, val in self._kv.items():
                self._write_string(f, key)
                f.write(struct.pack("<I", int(val.type)))
                self._write_value(f, val)
            if self._spill_file is not None:
                self._spill_file.close()
                self._spill_file = None
            offset = 0
            for name, shape, ggml_type, payload in self._tensors:
                self._write_string(f, name)
                f.write(struct.pack("<I", len(shape)))
                for s in reversed(shape):  # ne[0] is the contiguous axis
                    f.write(struct.pack("<Q", s))
                f.write(struct.pack("<I", int(ggml_type)))
                f.write(struct.pack("<Q", offset))
                offset += nbytes(payload)
                offset += -offset % align
            f.write(b"\x00" * (-f.tell() % align))
            spill = open(self._spill_path, "rb") if self._spill_path.exists() else None
            try:
                for name, shape, ggml_type, payload in self._tensors:
                    if isinstance(payload, tuple):
                        spill.seek(payload[0])
                        remaining = payload[1]
                        while remaining:
                            chunk = spill.read(min(remaining, 64 << 20))
                            f.write(chunk)
                            remaining -= len(chunk)
                    else:
                        f.write(payload.tobytes())
                    f.write(b"\x00" * (-nbytes(payload) % align))
            finally:
                if spill is not None:
                    spill.close()
                    self._spill_path.unlink(missing_ok=True)
