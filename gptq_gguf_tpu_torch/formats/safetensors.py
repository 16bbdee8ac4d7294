"""Reader and writer of the safetensors container.

The port's counterpart of the JAX package's use of the ``safetensors``
package (``models/loader.py::_iter_safetensors``, and ``save_pretrained``
through ``transformers`` for the synthetic checkpoints), which the port does
not depend on. A file is: a little-endian u64 header length N, N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``, then the raw little-endian tensor bytes, offsets relative to the
end of the header.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# safetensors dtype -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),  # numpy has no bf16: read the bits
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}


def write_safetensors(tensors: Dict[str, torch.Tensor], path: Union[str, Path]) -> None:
    """Write CPU tensors as one safetensors file, names sorted, the header
    padded with spaces to 8 bytes."""
    dtype_names = {t_dt: name for name, (_, t_dt) in _DTYPES.items()}
    names = sorted(tensors)
    header, off = {}, 0
    for name in names:
        t = tensors[name]
        nb = t.numel() * t.element_size()
        header[name] = {"dtype": dtype_names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nb]}
        off += nb
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(tensors[name].contiguous().view(torch.uint8).numpy())


def read_header(path: Union[str, Path]) -> Tuple[Dict, int]:
    """(header without ``__metadata__``, byte offset of the data section)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_file(path: Union[str, Path], names: Optional[Sequence[str]] = None
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for every tensor of one file in header order, or
    for ``names`` in their order. The tensors are copies: nothing stays
    mapped."""
    header, base = read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    try:
        for name in header if names is None else names:
            info = header[name]
            if info["dtype"] not in _DTYPES:
                raise NotImplementedError(f"{path}: tensor {name} has dtype {info['dtype']}")
            np_dt, t_dt = _DTYPES[info["dtype"]]
            b0, b1 = info["data_offsets"]
            arr = np.array(mm[base + b0: base + b1]).view(np_dt).reshape(info["shape"])
            t = torch.from_numpy(arr)
            yield name, (t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t)
    finally:
        del mm


def iter_dir(model_dir: Union[str, Path]) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor of every ``*.safetensors`` file of a checkpoint directory:
    files sorted by name, each file's tensors sorted by name (the order of
    the JAX package's walk, whose ``safe_open(...).keys()`` are sorted)."""
    files = sorted(Path(model_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    for path in files:
        yield from iter_file(path, sorted(read_header(path)[0]))

