"""HF checkpoint -> the port's param dict (dense llama, mistral, qwen2, qwen3,
gemma, gemma2, phi3).

Port of the dense part of ``gptq_gguf_tpu/models/loader.py``: reads
``config.json`` and ``*.safetensors`` (through the port's own container
reader) into the ``models.llama`` layout, attention biases, per-head q / k
norms and gemma2's pre / post feed-forward norms included. phi3's fused
``qkv_proj`` and ``gate_up_proj`` are split by rows into q / k / v (q the
first nH * hd rows, then k and v of nKV * hd each) and gate / up (gate
first). Other model types raise ``NotImplementedError`` naming the type.
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
    "pre_feedforward_layernorm.weight": "pre_feedforward_layernorm",
    "post_feedforward_layernorm.weight": "post_feedforward_layernorm",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
}


# phi3's fused projections and the layer keys of their row blocks
_FUSED = {"self_attn.qkv_proj.weight": ("q_proj", "k_proj", "v_proj"),
          "mlp.gate_up_proj.weight": ("gate_proj", "up_proj")}


def _fused_rows(val: torch.Tensor, rest: str, cfg: LlamaConfig):
    """The row blocks of a fused phi3 projection, each a contiguous copy."""
    if rest.startswith("self_attn."):
        hd = cfg.head_dim_
        sizes = [cfg.num_attention_heads * hd] + [cfg.num_key_value_heads * hd] * 2
    else:
        sizes = [cfg.intermediate_size] * 2
    if sum(sizes) != val.shape[0]:
        raise ValueError(f"{rest}: {val.shape[0]} rows, the config gives {sum(sizes)}")
    return [t.contiguous() for t in torch.split(val, sizes)]


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
            if rest in _FUSED:
                for key, part in zip(_FUSED[rest], _fused_rows(val, rest, cfg)):
                    layers[int(parts[2])][key] = part
                continue
            if rest not in _LAYER:
                raise NotImplementedError(f"checkpoint tensor {name} is not ported yet")
            layers[int(parts[2])][_LAYER[rest]] = val
    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    return params
