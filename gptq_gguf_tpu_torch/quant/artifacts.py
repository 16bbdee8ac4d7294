"""Per-layer quantization artifacts.

Port of ``gptq_gguf_tpu/quant/artifacts.py``: one
``<save_dir>/<hf_module_name>/data.npz`` per quantized linear holding
q_type, qweight, super_group_scale / super_group_zero (fp16) and
group_scale_quant / group_zero_quant, the same file layout and dtypes as
the JAX package, so each package reads the other's files; the reference's
torch ``data.pth`` flavour is read too.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from ..formats.ggml import GGMLQuantizationType
from ..ops.kquant import SuperGroupParams


@dataclasses.dataclass
class LayerArtifact:
    q_type: GGMLQuantizationType
    qweight: np.ndarray  # (d_row, d_col) int codes
    super_group_scale: np.ndarray  # (d_row, n_sg) fp16
    super_group_zero: np.ndarray
    group_scale_quant: np.ndarray  # (d_row, n_groups) u8/i8
    group_zero_quant: np.ndarray

    @staticmethod
    def from_result(q_type: GGMLQuantizationType, qweight, params: SuperGroupParams):
        def host(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        return LayerArtifact(q_type, host(qweight), host(params.super_scale),
                             host(params.super_zero), host(params.scale_q), host(params.zero_q))

    def params(self, device="cpu") -> SuperGroupParams:
        return SuperGroupParams(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
            self.super_group_scale, self.super_group_zero, self.group_scale_quant,
            self.group_zero_quant)))

    def dequantize(self, device="cpu") -> torch.Tensor:
        from ..ops import kquant

        q = torch.from_numpy(np.ascontiguousarray(self.qweight)).to(device)
        return kquant.dequantize(q, self.params(device), self.q_type)


def save_layer(save_dir: Union[str, Path], layer_name: str, art: LayerArtifact) -> Path:
    d = Path(save_dir) / layer_name
    d.mkdir(parents=True, exist_ok=True)
    np.savez(
        d / "data.npz",
        q_type=np.int32(int(art.q_type)),
        qweight=art.qweight,
        super_group_scale=art.super_group_scale.astype(np.float16),
        super_group_zero=art.super_group_zero.astype(np.float16),
        group_scale_quant=art.group_scale_quant,
        group_zero_quant=art.group_zero_quant,
    )
    return d / "data.npz"


def load_layer(save_dir: Union[str, Path], layer_name: str) -> LayerArtifact:
    d = Path(save_dir) / layer_name
    npz = d / "data.npz"
    if npz.exists():
        z = np.load(npz)
        return LayerArtifact(
            q_type=GGMLQuantizationType(int(z["q_type"])),
            qweight=z["qweight"],
            super_group_scale=z["super_group_scale"],
            super_group_zero=z["super_group_zero"],
            group_scale_quant=z["group_scale_quant"],
            group_zero_quant=z["group_zero_quant"],
        )
    pth = d / "data.pth"
    if pth.exists():
        return _load_pth(pth)
    raise FileNotFoundError(f"no artifact for layer {layer_name} in {save_dir}")


def _load_pth(path: Path) -> LayerArtifact:
    """Read a reference-format torch data.pth artifact."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return LayerArtifact(
        q_type=GGMLQuantizationType(int(obj["q_type"])),
        qweight=obj["qweight"].numpy(),
        super_group_scale=obj["super_group_scale"].numpy(),
        super_group_zero=obj["super_group_zero"].numpy(),
        group_scale_quant=obj["group_scale_quant"].numpy(),
        group_zero_quant=obj["group_zero_quant"].numpy(),
    )


def list_layers(save_dir: Union[str, Path]) -> Dict[str, Path]:
    """All layer artifact dirs under save_dir (name -> dir)."""
    out = {}
    root = Path(save_dir)
    if not root.exists():
        return out
    for data in sorted(root.rglob("data.npz")) + sorted(root.rglob("data.pth")):
        out.setdefault(str(data.parent.relative_to(root)), data.parent)
    return out
