"""Layer database + per-tensor config -> one GGUF model.

Copy of ``gptq_gguf_tpu/mapper/stitcher.py``: finds each tensor's
``<bits>[-QTYPE].pth`` variants in a ``split_gguf`` database, takes a
config's choice for each (the search's output, after ``convert-config``)
or the closest match to a default, and writes the chosen raw GGML blocks
with the source's metadata, each value in its exact GGUF type, through the
port's ``GGUFWriter``.

One departure: ``general.file_type`` is the id ``pack`` writes for the
type that most tensors hold (``formats.ggml.FILE_TYPE_IDS``: 15 for
Q4_K, 18 for Q6_K), where the JAX stitcher maps the majority bit width
through llama.cpp ids that name other types (4 bits -> 12, Q3_K_M). So a
uniform database stitches back to ``pack``'s file byte for byte. Without a
majority, or for a type ``pack`` does not write, the JAX table stands.
Host code: numpy, no card.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..formats.ggml import FILE_TYPE_IDS, GGMLQuantizationType
from ..formats.gguf import GGUFValue, GGUFValueType, GGUFWriter

_FILE_RE_TYPED = re.compile(r"^([\d.]+)-([^.]+)\.pth$")
_FILE_RE_PLAIN = re.compile(r"^([\d.]+)\.pth$")
_CONFIG_LINE_RE = re.compile(r"^([\d.]+)\s*\(([\d.]+-[^)]+\.pth)\)$")


@dataclasses.dataclass
class QuantizationConfig:
    bitwidth: float
    filename: Optional[str]
    quant_type: Optional[str]
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def filename_prefix(self) -> str:
        if self.filename:
            return self.filename[: -len(".pth")]
        return str(self.bitwidth)


def discover_layers(split_dir: Union[str, Path]) -> Dict[str, List[Dict[str, Any]]]:
    """Every layer directory's ``<bits>[-QTYPE].pth`` variants."""
    discovered: Dict[str, List[Dict[str, Any]]] = {}
    split_dir = Path(split_dir)
    for layer_dir in sorted(split_dir.rglob("*")):
        if not layer_dir.is_dir():
            continue
        configs = []
        for f in layer_dir.glob("*.pth"):
            m = _FILE_RE_TYPED.match(f.name)
            if m:
                configs.append({"bitwidth": float(m.group(1)), "filename": f.name,
                                "quant_type": m.group(2)})
                continue
            m = _FILE_RE_PLAIN.match(f.name)
            if m:
                configs.append({"bitwidth": float(m.group(1)), "filename": f.name,
                                "quant_type": None})
        if configs:
            discovered[str(layer_dir.relative_to(split_dir))] = configs
    return discovered


def find_best_match(configs: List[Dict[str, Any]], bitwidth: float,
                    quant_type: Optional[str]) -> Dict[str, Any]:
    """Exact (bits, type), then exact bits, then the closest bits of that
    type, then the closest bits."""
    if quant_type:
        for c in configs:
            if c["bitwidth"] == bitwidth and c["quant_type"] == quant_type:
                return c
    for c in configs:
        if c["bitwidth"] == bitwidth:
            return c
    by_dist = sorted(configs, key=lambda c: abs(c["bitwidth"] - bitwidth))
    if quant_type:
        for c in by_dist:
            if c["quant_type"] == quant_type:
                return c
    return by_dist[0]


def parse_config_file(path: Union[str, Path],
                      available: Dict[str, List[Dict[str, Any]]]) -> Dict[str, QuantizationConfig]:
    """``tensor: bits (file.pth)`` lines, or ``tensor: bits [QTYPE]`` matched
    against the database."""
    out: Dict[str, QuantizationConfig] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or ":" not in line:
                continue
            name, rest = line.split(":", 1)
            name, rest = name.strip(), rest.strip()
            m = _CONFIG_LINE_RE.match(rest)
            if m:
                bw, filename = float(m.group(1)), m.group(2)
                qm = _FILE_RE_TYPED.match(filename)
                out[name] = QuantizationConfig(bw, filename, qm.group(2) if qm else None)
                continue
            parts = rest.split()
            try:
                bw = float(parts[0])
            except (ValueError, IndexError):
                continue
            qt = parts[1] if len(parts) > 1 else None
            if name in available:
                best = find_best_match(available[name], bw, qt)
                out[name] = QuantizationConfig(best["bitwidth"], best["filename"],
                                               best["quant_type"])
            else:
                fn = f"{parts[0]}-{qt}.pth" if qt else f"{parts[0]}.pth"
                out[name] = QuantizationConfig(bw, fn, qt)
    return out


# the JAX stitcher's ids by whole bits, kept where no type decides
_FILE_TYPE_BY_BITS = {32: 0, 16: 1, 8: 7, 6: 14, 5: 13, 4: 12, 3: 11, 2: 10}


def calculate_file_type(config: Dict[str, QuantizationConfig]) -> int:
    """``general.file_type`` of a stitched model: ``pack``'s id for the type
    more than half of the tensors hold, else 12 (see the module's note)."""
    counts: Dict[Tuple[Optional[str], float], int] = {}
    for c in config.values():
        key = (c.quant_type, c.bitwidth)
        counts[key] = counts.get(key, 0) + 1
    if not counts:
        return 12
    dominant = max(counts, key=counts.get)
    if counts[dominant] / len(config) <= 0.5:
        return 12
    qtype = GGMLQuantizationType.__members__.get(dominant[0] or "")
    if qtype in FILE_TYPE_IDS:
        return FILE_TYPE_IDS[qtype]
    return _FILE_TYPE_BY_BITS.get(int(dominant[1]), 12)


class GGUFStitcher:
    """Assemble a GGUF from a ``split_gguf`` database."""

    def __init__(self, split_dir: Union[str, Path], config_path: Optional[Union[str, Path]] = None,
                 default_bitwidth: float = 4.5, default_quant_type: Optional[str] = "Q4_K"):
        self.split_dir = Path(split_dir)
        self.manifest = self._load_manifest()
        self.available = discover_layers(self.split_dir)
        user_cfg = parse_config_file(config_path, self.available) if config_path else {}
        self.config: Dict[str, QuantizationConfig] = {}
        for name, configs in self.available.items():
            if name in user_cfg:
                self.config[name] = user_cfg[name]
            else:
                best = find_best_match(configs, default_bitwidth, default_quant_type)
                self.config[name] = QuantizationConfig(best["bitwidth"], best["filename"],
                                                       best["quant_type"])

    def _load_manifest(self) -> Dict[str, Any]:
        p = self.split_dir / "manifest.json"
        if p.exists():
            with open(p) as f:
                return json.load(f)
        return {}

    def validate(self) -> List[str]:
        """Problems with the configured files (empty when valid)."""
        problems = []
        if not self.available:
            problems.append(
                f"no layer directories with <bits>[-QTYPE].pth files found under {self.split_dir}")
        for name, cfg in self.config.items():
            f = self.split_dir / name / (cfg.filename or f"{cfg.bitwidth}.pth")
            if not f.exists() and not (self.split_dir / name / "32-F32.pth").exists():
                problems.append(f"{name}: missing {f.name}")
            meta = self.split_dir / name / f"{cfg.filename_prefix}-metadata.json"
            if not meta.exists() and not (self.split_dir / name / "32-F32-metadata.json").exists():
                problems.append(f"{name}: missing metadata {meta.name}")
        return problems

    def list_tensors(self) -> Dict[str, Dict[str, Any]]:
        return {name: {"bitwidth": c.bitwidth, "quant_type": c.quant_type,
                       "filename": c.filename}
                for name, c in self.config.items()}

    def _load_tensor(self, name: str, cfg: QuantizationConfig) -> Tuple[np.ndarray, Dict[str, Any]]:
        layer_dir = self.split_dir / name
        f = layer_dir / (cfg.filename or f"{cfg.bitwidth}.pth")
        meta_f = layer_dir / f"{cfg.filename_prefix}-metadata.json"
        if not f.exists():  # the f32 variant stands in for a missing one
            fb = layer_dir / "32-F32.pth"
            if not fb.exists():
                raise FileNotFoundError(f"tensor file not found: {f}")
            f, meta_f = fb, layer_dir / "32-F32-metadata.json"
        with open(meta_f) as mf:
            info = json.load(mf)["tensor_info"]
        data = np.frombuffer(f.read_bytes(), dtype=np.dtype(info["np_dtype"]))
        return data.reshape(tuple(info["np_shape"])), info

    def stitch(self, out_path: Union[str, Path]) -> Path:
        problems = self.validate()
        if problems:
            raise FileNotFoundError("; ".join(problems))
        writer = GGUFWriter(out_path)
        # the source's metadata, each value with its exact GGUF type
        for key, entry in self.manifest.get("metadata", {}).items():
            if key == "general.file_type":
                continue
            types = entry.get("types") or []
            value = entry.get("value")
            if isinstance(value, str) and value.startswith("<serialization_error"):
                continue
            if not types:
                writer.add_kv(key, value)
                continue
            vtype = GGUFValueType(types[0])
            elem = (GGUFValueType(types[1])
                    if len(types) > 1 and vtype == GGUFValueType.ARRAY else None)
            writer.add_kv(key, GGUFValue(vtype, value, elem_type=elem)
                          if elem or vtype != GGUFValueType.ARRAY else value)
        writer.add_kv("general.file_type", calculate_file_type(self.config))
        # tensors in the source's order where the manifest has it
        order = list(self.manifest.get("layers", {}).keys()) or sorted(self.config)
        for name in order:
            if name not in self.config:
                continue
            data, info = self._load_tensor(name, self.config[name])
            writer.add_tensor(name, data.view(np.uint8), raw_dtype=GGMLQuantizationType(info["type"]),
                              raw_shape=tuple(reversed(info["shape"])))
        writer.write()
        return Path(out_path)
