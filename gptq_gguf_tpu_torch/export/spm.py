"""Reader of a SentencePiece ``tokenizer.model`` (no sentencepiece package).

Copy of the reading half of ``gptq_gguf_tpu/export/spm.py``: the ModelProto
protobuf is parsed from its wire format (the schema is tiny and stable).

ModelProto fields used:
  field 1 (repeated message) SentencePiece { piece=1 str, score=2 float,
                                             type=3 enum (default NORMAL=1) }
  field 2 (message) TrainerSpec { unk_id=40, bos_id=41, eos_id=42, pad_id=43 }

The SentencePiece type enum (NORMAL=1, UNKNOWN=2, CONTROL=3, USER_DEFINED=4,
UNUSED=5, BYTE=6) numerically matches GGUF's tokenizer.ggml.token_type.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Optional, Tuple


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's wire bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val = buf[i : i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wt == 5:
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fnum, wt, val


def _to_int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


@dataclasses.dataclass
class Piece:
    piece: str
    score: float
    type: int  # 1..6, GGUF-compatible


@dataclasses.dataclass
class SpmModel:
    pieces: List[Piece]
    unk_id: Optional[int] = None
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None
    pad_id: Optional[int] = None


def parse_model(data: bytes) -> SpmModel:
    pieces: List[Piece] = []
    model = SpmModel(pieces)
    for fnum, wt, val in _iter_fields(data):
        if fnum == 1 and wt == 2:  # SentencePiece
            piece, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8", errors="replace")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = int(v2)
            pieces.append(Piece(piece, score, ptype))
        elif fnum == 2 and wt == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if w2 != 0:
                    continue
                v2 = _to_int64(int(v2))
                if f2 == 40:
                    model.unk_id = v2
                elif f2 == 41:
                    model.bos_id = v2
                elif f2 == 42:
                    model.eos_id = v2
                elif f2 == 43:
                    model.pad_id = v2
    return model
