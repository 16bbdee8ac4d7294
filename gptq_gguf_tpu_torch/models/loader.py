"""HF checkpoint -> the port's param dict (dense llama, mistral, qwen2, qwen3).

Port of the dense part of ``gptq_gguf_tpu/models/loader.py``: reads
``config.json`` and ``*.safetensors`` (through the port's own container
reader) into the ``models.llama`` layout, attention biases and per-head
q / k norms included. Other model types raise ``NotImplementedError``
naming the type.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from ..formats import safetensors
from .llama import FAMILIES, LlamaConfig

SUPPORTED_MODEL_TYPES = FAMILIES

_TOP = {"model.embed_tokens.weight": "embed_tokens", "model.norm.weight": "norm",
        "lm_head.weight": "lm_head"}
_LAYER = {
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "self_attn.q_proj.bias": "q_bias",
    "self_attn.k_proj.bias": "k_bias",
    "self_attn.v_proj.bias": "v_bias",
    "self_attn.o_proj.bias": "o_bias",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
}


def load_config(model_dir: Union[str, Path], dtype=torch.float32) -> LlamaConfig:
    with open(Path(model_dir) / "config.json") as f:
        d = json.load(f)
    if d.get("model_type") not in SUPPORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {d.get('model_type')!r} is not ported yet; supported: "
            f"{SUPPORTED_MODEL_TYPES}")
    return LlamaConfig.from_hf_dict(d, dtype=dtype)


def _host_value(t: torch.Tensor) -> torch.Tensor:
    """bf16 widens to f32 on the host (exact); fp16 stays fp16 until the
    walk stages it; everything else becomes f32."""
    return t if t.dtype == torch.float16 else t.float()


def load_params(model_dir: Union[str, Path], cfg: Optional[LlamaConfig] = None) -> Dict[str, Any]:
    """Load a checkpoint into the ``models.llama`` param dict, every
    weight in host memory (the JAX loader's ``host=True``): the calibration
    walk stages one block onto the card at a time."""
    model_dir = Path(model_dir)
    cfg = cfg or load_config(model_dir)
    layers = [dict() for _ in range(cfg.num_hidden_layers)]
    params: Dict[str, Any] = {"layers": layers}
    for name, t in safetensors.iter_dir(model_dir):
        val = _host_value(t)
        if name in _TOP:
            params[_TOP[name]] = val
        elif name.startswith("model.layers."):
            parts = name.split(".")
            rest = ".".join(parts[3:])
            if rest.endswith("rotary_emb.inv_freq"):
                continue  # derived from the config
            if rest not in _LAYER:
                raise NotImplementedError(f"checkpoint tensor {name} is not ported yet")
            layers[int(parts[2])][_LAYER[rest]] = val
    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    return params
