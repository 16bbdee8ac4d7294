"""llama.cpp ``.imatrix`` files (the legacy binary layout).

Copy of ``gptq_gguf_tpu/quant/imatrix_io.py``: ``llama-imatrix`` writes
importance matrices that ``llama-quantize --imatrix`` reads; this module
reads and writes that file, so importance data flows both ways between the
toolkit and llama.cpp:

    int32 n_entries
    n_entries x { int32 len; bytes name; int32 ncall; int32 nval;
                  float32 values[nval] }   # sums over ncall batches
    int32 last_call
    int32 len; bytes dataset_name          # trailer (optional on read)

Entries are keyed by GGUF weight-tensor names (``blk.0.ffn_up.weight``);
stored values are per-column squared-activation sums over ``ncall``
batches, which readers divide by ncall (as llama.cpp's load_imatrix does).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np

__all__ = ["load_imatrix", "save_imatrix"]


def save_imatrix(imatrix: Dict[str, np.ndarray], path: Union[str, Path],
                 *, ncall: int = 1, dataset: str = "synthetic") -> Path:
    """Write mean per-column importances as a llama.cpp .imatrix file.

    Values are stored as sums over ``ncall`` calls, so means are
    multiplied back up (llama.cpp divides by ncall on load).
    """
    path = Path(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(imatrix)))
        for name, vec in imatrix.items():
            b = name.encode("utf-8")
            vec = np.asarray(vec, dtype=np.float32).reshape(-1) * ncall
            f.write(struct.pack("<i", len(b)))
            f.write(b)
            f.write(struct.pack("<ii", ncall, vec.size))
            f.write(vec.tobytes())
        f.write(struct.pack("<i", ncall))
        db = dataset.encode("utf-8")
        f.write(struct.pack("<i", len(db)))
        f.write(db)
    return path


def load_imatrix(path: Union[str, Path]
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, int], str]:
    """Read a llama.cpp .imatrix file.

    Returns (mean importances by tensor name, ncall by name, dataset name).
    Means are the stored sums divided by each entry's ncall.
    """
    raw = Path(path).read_bytes()
    off = 0

    def i32():
        nonlocal off
        (v,) = struct.unpack_from("<i", raw, off)
        off += 4
        return v

    n = i32()
    if not (0 < n < 1_000_000):
        raise ValueError(f"{path}: not a llama.cpp imatrix file "
                         f"(n_entries={n})")
    out: Dict[str, np.ndarray] = {}
    ncalls: Dict[str, int] = {}
    for _ in range(n):
        ln = i32()
        name = raw[off:off + ln].decode("utf-8")
        off += ln
        ncall = i32()
        nval = i32()
        vals = np.frombuffer(raw, dtype="<f4", count=nval, offset=off).copy()
        off += 4 * nval
        out[name] = vals / max(ncall, 1)
        ncalls[name] = ncall
    dataset = ""
    if off + 8 <= len(raw):  # optional trailer
        i32()  # last_call
        ln = i32()
        dataset = raw[off:off + ln].decode("utf-8", errors="replace")
    return out, ncalls, dataset
