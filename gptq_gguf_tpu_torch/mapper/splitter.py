"""GGUF model -> per-tensor layer database, in two layouts.

Copy of ``gptq_gguf_tpu/mapper/splitter.py``; it writes the same files:

  <out>/<tensor_name>/<bits>-<QTYPE>.pth        raw GGML block bytes
  <out>/<tensor_name>/<bits>-<QTYPE>-metadata.json
  <out>/manifest.json, gguf_layer_database.json          (split_gguf)

  <out>/<hf_layer>/<bits>-<QTYPE>.pth           torch-saved f16 weight
  <out>/<hf_layer>/<bits>-<QTYPE>-metadata.json
  <out>/manifest.json, hf_to_gguf_mapping.json            (split_hf)

The GGUF layout's ``.pth`` files are raw bytes (not torch pickles); the HF
layout holds each block linear dequantized by ``formats.ggml``, q / k rows
put back in HF's rotate-half order. Host code: numpy, no card.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..formats.convert import gqa_permute_rows
from ..formats.ggml import GGMLQuantizationType, NOMINAL_BITS
from ..formats.gguf import GGUFReader

QTYPE_NAMES = {t.value: t.name for t in GGMLQuantizationType}


def _bits_prefix(bits: float) -> str:
    return str(bits) if bits != int(bits) else str(int(bits))


def quantization_name(ggml_type: GGMLQuantizationType) -> str:
    return ggml_type.name


def nominal_bits(qname: str) -> float:
    return NOMINAL_BITS.get(qname, 32.0)


# GGUF -> HF layer names: the dense block, qk norms, fused and MLA projections
_GGUF_TO_HF = {
    "attn_q": "self_attn.q_proj",
    "attn_k": "self_attn.k_proj",
    "attn_v": "self_attn.v_proj",
    "attn_output": "self_attn.o_proj",
    "ffn_gate": "mlp.gate_proj",
    "ffn_up": "mlp.up_proj",
    "ffn_down": "mlp.down_proj",
    "attn_q_norm": "self_attn.q_norm",
    "attn_k_norm": "self_attn.k_norm",
    "attn_qkv": "self_attn.qkv_proj",
    "attn_q_a": "self_attn.q_a_proj",
    "attn_q_b": "self_attn.q_b_proj",
    "attn_kv_a_mqa": "self_attn.kv_a_proj_with_mqa",
    "attn_kv_b": "self_attn.kv_b_proj",
    "attn_k_b": "self_attn.k_b_proj",
    "attn_v_b": "self_attn.v_b_proj",
}

# MoE tensors: *_exps are stacked (n_expert, rows, cols); the HF side names
# each expert through the {e} placeholder
_GGUF_TO_HF_MOE = {
    "ffn_gate_exps": "mlp.experts.{e}.gate_proj",
    "ffn_up_exps": "mlp.experts.{e}.up_proj",
    "ffn_down_exps": "mlp.experts.{e}.down_proj",
    "ffn_gate_shexp": "mlp.shared_expert.gate_proj",
    "ffn_up_shexp": "mlp.shared_expert.up_proj",
    "ffn_down_shexp": "mlp.shared_expert.down_proj",
    "ffn_gate_inp": "mlp.gate",
    "ffn_gate_inp_shexp": "mlp.shared_expert_gate",
}


def gguf_to_hf_name(name: str) -> Optional[str]:
    if name == "token_embd.weight":
        return "model.embed_tokens.weight"
    if name == "output.weight":
        return "lm_head.weight"
    if name == "output_norm.weight":
        return "model.norm.weight"
    if name.startswith("blk."):
        parts = name.split(".")
        i, comp = parts[1], parts[2]
        if comp in _GGUF_TO_HF:
            return f"model.layers.{i}.{_GGUF_TO_HF[comp]}.weight"
        if comp in _GGUF_TO_HF_MOE:
            return f"model.layers.{i}.{_GGUF_TO_HF_MOE[comp]}.weight"
    return None


def _serialize_metadata(reader: GGUFReader) -> Dict[str, Any]:
    """key -> {"types": [type(, elem_type)], "value": value}: what the
    stitcher needs to write each value back with its exact GGUF type."""
    md = {}
    for key, val in reader.metadata.items():
        md[key] = {
            "types": [int(val.type)] + ([int(val.elem_type)] if val.elem_type is not None else []),
            "value": val.value,
        }
    return md


def _prefix(info, overwrite_bitwidth: Optional[str]):
    """(type name, nominal bits, ``<bits>-<QTYPE>`` file prefix) of a
    tensor; an unknown type takes ``overwrite_bitwidth``'s name where one
    is given."""
    qname = QTYPE_NAMES.get(int(info.ggml_type), f"UNKNOWN_{int(info.ggml_type)}")
    if qname.startswith("UNKNOWN") and overwrite_bitwidth:
        qname = overwrite_bitwidth
    bits = nominal_bits(qname)
    prefix = _bits_prefix(bits)
    return qname, bits, f"{prefix}-{qname}"


def split_gguf(gguf_path: Union[str, Path], out_dir: Union[str, Path], *,
               overwrite_bitwidth: Optional[str] = None) -> Dict[str, Any]:
    """Every tensor of a GGUF file as raw bytes in the layer database."""
    gguf_path, out_dir = Path(gguf_path), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    reader = GGUFReader(gguf_path)
    manifest: Dict[str, Any] = {
        "model_info": {
            "original_file": gguf_path.name,
            "total_tensors": len(reader.tensors),
            "split_timestamp": None,
            "use_exact_bitwidth": True,
        },
        "metadata": _serialize_metadata(reader),
        "layers": {},
    }
    db: Dict[str, Any] = {}
    for name in reader.tensor_order:
        info = reader.tensors[name]
        qname, bits, prefix = _prefix(info, overwrite_bitwidth)
        n_elements = math.prod(info.shape)
        layer_dir = out_dir / name
        layer_dir.mkdir(parents=True, exist_ok=True)
        data = np.asarray(reader.tensor_bytes(name))
        (layer_dir / f"{prefix}.pth").write_bytes(data.tobytes())
        ne = list(reversed(info.shape))  # GGML dim order
        meta = {
            "tensor_info": {
                "name": name,
                "type": int(info.ggml_type),
                "quantization": qname,
                "bitwidth": bits,
                "exact_bitwidth": bits,
                "shape": ne,
                "n_elements": n_elements,
                "n_bytes": info.nbytes,
                "data_offset_original": info.offset,
                "data_filename": f"{prefix}.pth",
                "np_dtype": "uint8",
                "np_shape": [int(data.size)],
            }
        }
        with open(layer_dir / f"{prefix}-metadata.json", "w") as f:
            json.dump(meta, f, indent=2)
        manifest["layers"].setdefault(
            name, {"original_name": name, "dims": ne, "bitwidths": {}}
        )["bitwidths"][str(bits)] = {
            "filename": f"{prefix}.pth",
            "metadata_filename": f"{prefix}-metadata.json",
            "type": int(info.ggml_type),
            "quantization": qname,
            "bitwidth": bits,
            "exact_bitwidth": bits,
            "size_bytes": info.nbytes,
            "shape": ne,
            "n_elements": n_elements,
            "data_offset": info.offset,
        }
        db[name] = {"quantization": qname, "bitwidth": bits, "type": int(info.ggml_type),
                    "shape": ne}
    manifest["model_info"]["split_timestamp"] = time.time()
    manifest["model_info"]["processed_tensors"] = len(reader.tensor_order)
    with open(out_dir / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    with open(out_dir / "gguf_layer_database.json", "w") as f:
        json.dump(db, f, indent=2)
    return manifest


def split_hf(gguf_path: Union[str, Path], out_dir: Union[str, Path], *,
             dtype: str = "float16", overwrite_bitwidth: Optional[str] = None) -> Dict[str, Any]:
    """The block linears of a GGUF dequantized, under their HF names: q / k
    projections of llama / mistral go back to HF's rotate-half row order
    (the inverse of ``gqa_permute_rows``), and stacked MoE expert tensors
    fan out to one file per expert."""
    gguf_path, out_dir = Path(gguf_path), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    reader = GGUFReader(gguf_path)
    arch = reader.get("general.architecture", "llama")
    n_head = reader.get(f"{arch}.attention.head_count")
    n_kv = reader.get(f"{arch}.attention.head_count_kv", n_head)
    permute_qk = arch in ("llama", "mistral")
    hf_manifest: Dict[str, Any] = {
        "model_info": {
            "original_file": gguf_path.name,
            "dtype": dtype,
            "bitwidth": overwrite_bitwidth,
            "use_exact_bitwidth": True,
            "split_timestamp": time.time(),
        },
        "layers": {},
        "mapping_stats": {"total_layers": 0, "mapped_layers": 0, "unmapped_layers": 0},
    }
    mapping: Dict[str, Optional[str]] = {}
    np_dtype = np.float16 if dtype == "float16" else np.float32
    linear_markers = tuple(_GGUF_TO_HF.values()) + tuple(
        v for v in _GGUF_TO_HF_MOE.values() if "proj" in v)

    count = 0
    for name in reader.tensor_order:
        hf_name = gguf_to_hf_name(name)
        if hf_name is None or not any(s.split("{e}")[-1] in hf_name for s in linear_markers):
            continue
        info = reader.tensors[name]
        _, bits, prefix = _prefix(info, None)
        w = reader.tensor_float(name)
        if permute_qk and (".attn_q." in name or ".attn_k." in name):
            heads = n_head if ".attn_q." in name else n_kv
            w = w[np.argsort(gqa_permute_rows(w.shape[0], heads))]
        if "{e}" in hf_name and w.ndim == 3:
            emit = [(hf_name.format(e=e), w[e]) for e in range(w.shape[0])]
        else:
            emit = [(hf_name, w)]
        for out_name, w2 in emit:
            count += 1
            mapping[out_name] = name
            layer_dir_name = out_name.replace(".weight", "")
            layer_dir = out_dir / layer_dir_name
            layer_dir.mkdir(parents=True, exist_ok=True)
            t = torch.from_numpy(np.ascontiguousarray(w2.astype(np_dtype)))
            torch.save(t, layer_dir / f"{prefix}.pth")
            meta = {
                "tensor_info": {
                    "name": out_name,
                    "gguf_mapped_name": name,
                    "bitwidth": bits,
                    "dtype": str(t.dtype),
                    "shape": list(w2.shape),
                    "n_elements": int(w2.size),
                    "n_bytes": int(w2.size * t.element_size()),
                    "data_filename": f"{prefix}.pth",
                }
            }
            with open(layer_dir / f"{prefix}-metadata.json", "w") as f:
                json.dump(meta, f, indent=2)
            hf_manifest["layers"][out_name] = {
                "original_name": out_name,
                "gguf_mapped_name": name,
                "layer_directory": layer_dir_name,
                "dims": list(w2.shape),
                "bitwidth": bits,
                "filename": f"{prefix}.pth",
                "metadata_filename": f"{prefix}-metadata.json",
                "dtype": str(t.dtype),
                "shape": list(w2.shape),
                "n_elements": int(w2.size),
            }
    hf_manifest["mapping_stats"]["total_layers"] = count
    hf_manifest["mapping_stats"]["mapped_layers"] = count
    with open(out_dir / "manifest.json", "w") as f:
        json.dump(hf_manifest, f, indent=2)
    with open(out_dir / "hf_to_gguf_mapping.json", "w") as f:
        json.dump(mapping, f, indent=2)
    return hf_manifest


def list_bitwidths(db_dir: Union[str, Path]) -> Dict[str, list]:
    """layer -> the sorted bit widths of its ``.pth`` files."""
    out = {}
    for layer_dir in sorted(Path(db_dir).iterdir()):
        if not layer_dir.is_dir():
            continue
        opts = []
        for f in sorted(layer_dir.glob("*.pth")):
            try:
                opts.append(float(f.name.split("-")[0].replace(".pth", "")))
            except ValueError:
                pass
        if opts:
            out[layer_dir.name] = sorted(opts)
    return out
