"""Model surgery for evaluating compressed models.

Port of ``gptq_gguf_tpu/evals/compress.py``:

* layer drops: a block's attention or MLP is dropped by zeroing its output
  projection, which in a pre-norm residual block passes the residual stream
  through unchanged (the reference's ZeroAttention / ZeroMLP);
* ``load_compressed_weights``: swap layer weights in from a multi-level
  database (``<hf_layer_name>/<level>.pth`` files, as ``build-db`` or the
  ladders write them), per config line or at one level for every layer;
* ``load_sparse_weights``: the same mechanism.

Weights are swapped through ``models.llama.get_linear`` / ``set_linear`` and
take the dtype and device of the weight they replace.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Union

import torch

from ..models import llama


def apply_layer_drops(params, drop_config: List[str]):
    """drop_config[i] in {none, mlp, attn, attn+mlp} (model_utils.py:215-238)."""
    assert len(drop_config) == len(params["layers"])
    layers = []
    for layer, mode in zip(params["layers"], drop_config):
        new_layer = dict(layer)
        if mode in ("attn", "attn+mlp"):
            new_layer["o_proj"] = torch.zeros_like(layer["o_proj"])
        if mode in ("mlp", "attn+mlp"):
            new_layer["down_proj"] = torch.zeros_like(layer["down_proj"])
        if mode not in ("none", "attn", "mlp", "attn+mlp"):
            raise ValueError(f"bad drop mode {mode!r}")
        layers.append(new_layer)
    return {**params, "layers": layers}


def load_drop_config(path: Union[str, Path]) -> List[str]:
    """One drop mode per line, blank lines skipped (model_utils.py:232-238)."""
    with open(path) as f:
        return [line.strip("\n") for line in f if line.strip("\n") != ""]


def _load_weight_file(path: Path) -> torch.Tensor:
    return torch.load(path, map_location="cpu", weights_only=True).float()


def _swap(params, name: str, w: torch.Tensor):
    old = llama.get_linear(params, name)
    return llama.set_linear(params, name, w.to(device=old.device, dtype=old.dtype))


def load_compressed_weights(
    params,
    compressed_weights_path: Union[str, Path],
    compressed_config_path: Optional[Union[str, Path]] = None,
    default_level: Union[int, str] = 0,
):
    """Swap layer weights from a multi-level database (ppleval.py:124-152).

    Config lines: ``<hf_layer_name>: <level>``; a numeric level ("4",
    "4.0") names ``4.pth``, any other (a database's ``4.5-Q4_K``) its own
    file. Without a config, every layer directory is loaded at
    ``default_level``.
    """
    root = Path(compressed_weights_path)
    if compressed_config_path:
        with open(compressed_config_path) as f:
            for line in f:
                if ":" not in line:
                    continue
                name, level = line.split(":")
                name = name.strip()
                level = level.strip().split(" ")[0]
                level = str(int(float(level))) if level.replace(".", "").isdigit() else level
                params = _swap(params, name, _load_weight_file(root / name / f"{level}.pth"))
    else:
        for name in sorted(os.listdir(root)):
            if not (root / name).is_dir():
                continue
            params = _swap(params, name, _load_weight_file(root / name / f"{default_level}.pth"))
    return params


load_sparse_weights = load_compressed_weights  # the same mechanism (model_utils.py:337-362)
