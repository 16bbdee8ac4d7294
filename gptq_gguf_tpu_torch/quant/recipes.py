"""llama-quantize-style GGUF -> GGUF requantization with mixed-type recipes.

Port of ``gptq_gguf_tpu/quant/recipes.py``. The reference wraps llama.cpp's
``llama-quantize``: an F16 / BF16 / F32 GGUF goes in, a quantized GGUF
comes out, and the *recipe* (ftype, e.g. Q4_K_M) gives each tensor its
GGML type (output.weight Q6_K, some ffn_down / attn_v layers a bigger
type, ...):

* the per-tensor types follow llama.cpp's ``llama_tensor_get_type`` for
  the dense llama-family tensor names (``use_more_bits``'s layer striping
  included);
* K-quant tensors are fitted by ``ops.kquant.quantize_rtn`` on the device
  the caller names (the card by default; imatrix-weighted when given) and
  packed on the host by ``formats.convert.pack_layer``;
* Q4_0 / Q8_0 / IQ4_NL / IQ4_XS tensors are quantized on the host by the
  round-to-nearest codecs of ``formats.ggml``.

``pure`` (llama-quantize ``--pure``) applies the base type to every
quantizable tensor. Rows that do not tile the chosen type's blocks fall
back to F16, as llama.cpp does. The output keeps the source's metadata
(but general.file_type), tensor order and the bytes of every tensor it
does not quantize.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..formats import convert, ggml
from ..formats.ggml import GGMLQuantizationType as T
from ..formats.gguf import GGUFReader, GGUFWriter
from ..ops import kquant

# LLAMA_FTYPE ids (llama.h) for general.file_type
FTYPE_IDS: Dict[str, int] = {
    "F32": 0, "F16": 1, "Q4_0": 2, "Q8_0": 7,
    "Q2_K": 10, "Q2_K_S": 21,
    "Q3_K_S": 11, "Q3_K_M": 12, "Q3_K_L": 13,
    "Q4_K_S": 14, "Q4_K_M": 15,
    "Q5_K_S": 16, "Q5_K_M": 17,
    "Q6_K": 18,
    "IQ4_NL": 25, "IQ4_XS": 30,
}

# base (default) tensor type per recipe
_BASE_TYPE: Dict[str, T] = {
    "F32": T.F32, "F16": T.F16, "Q4_0": T.Q4_0, "Q8_0": T.Q8_0,
    "Q2_K": T.Q2_K, "Q2_K_S": T.Q2_K,
    "Q3_K_S": T.Q3_K, "Q3_K_M": T.Q3_K, "Q3_K_L": T.Q3_K,
    "Q4_K_S": T.Q4_K, "Q4_K_M": T.Q4_K,
    "Q5_K_S": T.Q5_K, "Q5_K_M": T.Q5_K,
    "Q6_K": T.Q6_K,
    "IQ4_NL": T.IQ4_NL, "IQ4_XS": T.IQ4_XS,
}

# elements of one K-quant fit on the device: row chunks of a large tensor
# (token_embd, output) are fitted in turn, which bounds the fit's memory;
# rows are fitted independently, so the chunks' codes are the whole's
FIT_CHUNK_ELEMS = 1 << 26


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's layer striping: the first and last eighth and every third
    layer between get the bigger type in the _M recipes."""
    return (
        i_layer < n_layers // 8
        or i_layer >= 7 * n_layers // 8
        or (i_layer - n_layers // 8) % 3 == 2
    )


def recipe_tensor_type(ftype: str, tensor_name: str, i_layer: int, n_layers: int,
                       n_gqa: int = 1) -> T:
    """Per-tensor GGML type of a recipe (llama.cpp llama_tensor_get_type,
    reduced to the dense llama-family tensor names ``pack`` writes)."""
    base = _BASE_TYPE[ftype]
    if ftype in ("F32", "F16"):
        return base
    t = tensor_name
    if t == "output.weight":
        return T.Q8_0 if base in (T.Q4_0, T.Q8_0) else T.Q6_K
    if t == "token_embd.weight":
        if ftype in ("Q2_K", "Q2_K_S"):
            return T.Q2_K
        return base
    if ".attn_v.weight" in t:
        if ftype == "Q2_K":
            return T.Q4_K if n_gqa >= 4 else T.Q3_K
        if ftype == "Q2_K_S":
            return T.Q4_K if n_gqa >= 4 else T.Q2_K
        if ftype == "Q3_K_M":
            return T.Q5_K if i_layer < 2 else T.Q4_K
        if ftype == "Q3_K_L":
            return T.Q5_K
        if ftype in ("Q4_K_M", "Q5_K_M") and use_more_bits(i_layer, n_layers):
            return T.Q6_K
        if ftype == "Q4_K_S" and i_layer < 4:
            return T.Q5_K
        return base
    if ".ffn_down" in t:
        if ftype == "Q2_K":
            return T.Q3_K if i_layer < n_layers // 8 else T.Q2_K
        if ftype == "Q3_K_M":
            if i_layer < n_layers // 16:
                return T.Q5_K
            return T.Q4_K if use_more_bits(i_layer, n_layers) else T.Q3_K
        if ftype == "Q3_K_L":
            return T.Q5_K
        if ftype in ("Q4_K_M", "Q5_K_M") and use_more_bits(i_layer, n_layers):
            return T.Q6_K
        if ftype == "Q4_K_S" and i_layer < n_layers // 8:
            return T.Q5_K
        if ftype == "IQ4_NL" and i_layer < n_layers // 8:
            return T.Q5_K
        return base
    if ".attn_output.weight" in t:
        if ftype in ("Q2_K", "Q2_K_S"):
            return T.Q3_K
        if ftype == "Q3_K_M":
            return T.Q4_K
        if ftype == "Q3_K_L":
            return T.Q5_K
        return base
    if ".attn_qkv.weight" in t:
        if ftype == "Q3_K_M":
            return T.Q4_K
        if ftype == "Q4_K_M":
            return T.Q5_K
        if ftype == "Q5_K_M":
            return T.Q6_K
        return base
    return base


@contextlib.contextmanager
def _stage(times: Optional[Dict[str, float]], name: str, dev: torch.device):
    """Adds the wall time of the block into ``times[name]``, the card
    synchronised at its end; no synchronisation when ``times`` is None."""
    t0 = time.perf_counter()
    yield
    if times is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def quantize_tensor_blocks(
    w: np.ndarray,
    qtype: T,
    imatrix_row: Optional[np.ndarray] = None,
    scale_cfg: Optional[kquant.ScaleSearchConfig] = None,
    device="cuda",
    stage_times: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """RTN-quantize a float (d_out, d_in) tensor to GGML blocks (uint8).

    K-quant types are fitted on ``device`` ("cuda", the default, raises
    without a card; or "cpu") in row chunks of FIT_CHUNK_ELEMS and packed on
    the host; the other types run the host codecs. stage_times: when a dict
    is passed, the seconds of the K-quant fits ("fit") and their packing
    ("pack"), or of a host codec ("codec"), are added into it."""
    host = torch.device("cpu")
    if qtype in (T.F32, T.F16):
        with _stage(stage_times, "codec", host):
            dt = np.float32 if qtype == T.F32 else np.float16
            return np.ascontiguousarray(w.astype(dt)).view(np.uint8)
    if qtype in ggml.KQUANT_SPECS:
        dev = resolve_device(device)
        cfg = scale_cfg if scale_cfg is not None else kquant.ScaleSearchConfig()
        im = None
        if imatrix_row is not None:
            im = torch.from_numpy(np.asarray(imatrix_row, np.float32)).to(dev)
        rows = max(1, FIT_CHUNK_ELEMS // w.shape[1])
        out = []
        for r0 in range(0, w.shape[0], rows):
            with _stage(stage_times, "fit", dev):
                x = torch.from_numpy(np.ascontiguousarray(w[r0:r0 + rows], np.float32)).to(dev)
                q, p = kquant.quantize_rtn(x, qtype, cfg, im)
                q, p = q.cpu().numpy(), [a.cpu().numpy() for a in p]
            with _stage(stage_times, "pack", host):
                out.append(convert.pack_layer(q, p[0], p[2], p[1], p[3], qtype))
        return out[0] if len(out) == 1 else np.concatenate(out)
    if qtype not in (T.Q8_0, T.Q4_0, T.IQ4_NL, T.IQ4_XS):
        raise NotImplementedError(f"quantize_tensor_blocks: {qtype!r}")
    rows = w.astype(np.float32)
    with _stage(stage_times, "codec", host):
        if qtype == T.Q8_0:
            return ggml.quantize_q8_0(rows.reshape(-1, 32))
        if qtype == T.Q4_0:
            return ggml.quantize_q4_0(rows.reshape(-1, 32))
        be = ggml.block_elems(qtype)
        qw = None
        if imatrix_row is not None:
            qw = np.tile(np.asarray(imatrix_row, np.float32), w.shape[0]).reshape(-1, be)
        fn = ggml.quantize_iq4_nl if qtype == T.IQ4_NL else ggml.quantize_iq4_xs
        return fn(rows.reshape(-1, be), qw)


def _is_quantizable(name: str, shape) -> bool:
    if len(shape) < 2:
        return False
    return name.endswith(".weight") and (
        name.startswith("blk.") or name in ("token_embd.weight", "output.weight")
    ) and "norm" not in name


def llama_quantize(
    in_path: Union[str, Path],
    out_path: Union[str, Path],
    ftype: str,
    *,
    imatrix: Optional[Dict[str, np.ndarray]] = None,
    pure: bool = False,
    scale_cfg: Optional[kquant.ScaleSearchConfig] = None,
    progress: Optional[Callable[[str, str], None]] = None,
    device="cuda",
    stage_times: Optional[Dict[str, float]] = None,
) -> Path:
    """Requantize a GGUF with a llama.cpp-style recipe.

    in_path: the source .gguf (any type ``formats.ggml.dequantize`` reads;
    typically F16 or BF16). ftype: a recipe of FTYPE_IDS (e.g. "Q4_K_M",
    "IQ4_XS"). imatrix: per-tensor importance vectors keyed by GGUF tensor
    name. pure: the base type for every quantizable tensor. device: where
    the K-quant fits run ("cuda", the default, or "cpu"). stage_times: when
    a dict is passed, the seconds of the host reads ("read"), the K-quant
    fits ("fit"), their host packing ("pack"), the host codecs ("codec")
    and the writing ("write") are added into it.
    """
    ftype = ftype.upper()
    if ftype not in _BASE_TYPE:
        raise ValueError(f"unknown recipe {ftype!r}; known: {sorted(_BASE_TYPE)}")
    dev = resolve_device(device)
    host = torch.device("cpu")
    r = GGUFReader(in_path)
    arch = r.get("general.architecture", "llama")
    n_layers = int(r.get(f"{arch}.block_count", 0) or 0)
    n_head = r.get(f"{arch}.attention.head_count", 1)
    n_kv = r.get(f"{arch}.attention.head_count_kv", n_head)
    n_gqa = max(1, (n_head or 1) // max(n_kv or 1, 1))

    w = GGUFWriter(out_path)
    for key, val in r.metadata.items():
        if key == "general.file_type":
            continue
        w.add_kv(key, val)
    w.add_kv("general.file_type", FTYPE_IDS[ftype])

    for name in r.tensor_order:
        info = r.tensors[name]
        if not _is_quantizable(name, info.shape):
            # passthrough, the original encoding byte for byte
            w.add_tensor(name, np.asarray(r.tensor_bytes(name)),
                         raw_dtype=info.ggml_type, raw_shape=info.shape)
            continue
        i_layer = int(name.split(".")[1]) if name.startswith("blk.") else 0
        if pure:
            qtype = _BASE_TYPE[ftype]
        else:
            qtype = recipe_tensor_type(ftype, name, i_layer, n_layers, n_gqa)
        be = ggml.block_elems(qtype)
        if info.shape[-1] % be != 0 or (
            qtype in ggml.KQUANT_SPECS and info.shape[-1] % ggml.QK_K != 0
        ):
            qtype = T.F16  # llama.cpp falls back when rows don't tile
        with _stage(stage_times, "read", host):
            data = r.tensor_float(name)
        im = imatrix.get(name) if imatrix is not None else None
        blocks = quantize_tensor_blocks(data, qtype, im, scale_cfg, dev, stage_times)
        del data
        with _stage(stage_times, "write", host):
            w.add_tensor(name, blocks, raw_dtype=qtype, raw_shape=info.shape)
        if progress is not None:
            progress(name, qtype.name)
    with _stage(stage_times, "write", host):
        w.write()
    return Path(out_path)
