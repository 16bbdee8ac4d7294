"""Dense Llama building blocks in PyTorch.

Port of the dense-Llama subset of ``gptq_gguf_tpu/models/llama.py``:
the config, RMSNorm, RoPE (default / linear / llama3 / gguf_factors), the
SwiGLU activation and the chunked online-softmax attention the serving
path uses on long caches. Other model families, rope types and attention
variants raise ``NotImplementedError`` naming what is missing.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # frozen item-tuple (or dict) of HF-style rope_scaling keys
    rope_scaling: Optional[Any] = None
    dtype: torch.dtype = torch.float32

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


# JAX LlamaConfig fields the dense path does not implement, with the value
# that means "feature off"; config_from_reference refuses anything else
_NEUTRAL = {
    "arch": "llama", "norm_type": "rmsnorm", "act_fn": "silu",
    "rms_add_unit": False, "embed_scale": False, "partial_rotary_factor": 1.0,
    "rope_interleaved": False, "parallel_blocks": False, "sliding_window": None,
    "sliding_layers": None, "rope_local_theta": None, "rope_sliding_only": False,
    "rope_layers": None, "qk_norm": False, "qk_norm_after_rope": False,
    "clip_qkv": None, "pos_type": "rope", "attn_logit_softcap": None,
    "final_logit_softcap": None, "query_pre_attn_scalar": None,
    "embedding_multiplier": None, "attention_scale": None,
    "residual_multiplier": None, "logits_multiplier": None,
    "moe_num_experts": None, "kv_lora_rank": None, "attention_bias": False,
    "mlp_bias": False,
}


def config_from_reference(ref) -> LlamaConfig:
    """The port's config from a ``gptq_gguf_tpu`` LlamaConfig (read by
    attribute, so this module needs no JAX). Raises NotImplementedError for
    a feature outside the dense Llama path."""
    for name, off in _NEUTRAL.items():
        if getattr(ref, name, off) != off:
            raise NotImplementedError(
                f"LlamaConfig.{name}={getattr(ref, name)!r} is not ported yet")
    kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(LlamaConfig)
          if f.name != "dtype"}
    return LlamaConfig(**kw, dtype=_DTYPES[np.dtype(ref.dtype).name])


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(dt)


def apply_norm(x: torch.Tensor, cfg: LlamaConfig, weight: torch.Tensor) -> torch.Tensor:
    """Config-selected norm: RMSNorm on the dense Llama path."""
    return rms_norm(x, weight, cfg.rms_norm_eps)


def _rope_params(cfg: LlamaConfig) -> Tuple[np.ndarray, float]:
    """(inv_freq, attention_scaling) following HF transformers'
    modeling_rope_utils for default / linear / llama3, plus llama.cpp's
    per-dim frequency factors (``gguf_factors``, rope_freqs.weight)."""
    hd = cfg.head_dim_  # full rotary on the dense Llama path
    base = cfg.rope_theta
    inv_freq = 1.0 / (base ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    rs = cfg.rope_scaling
    rs = dict(rs) if rs is not None and not isinstance(rs, dict) else (rs or {})
    rope_type = rs.get("rope_type", rs.get("type"))
    if rope_type == "llama3":
        factor = rs["factor"]
        low_factor = rs["low_freq_factor"]
        high_factor = rs["high_freq_factor"]
        old_len = rs["original_max_position_embeddings"]
        low_wavelen = old_len / low_factor
        high_wavelen = old_len / high_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_mid = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        inv_freq = np.where(is_mid, smoothed, scaled)
    elif rope_type in (None, "default"):
        pass
    elif rope_type == "linear":
        inv_freq = inv_freq / rs["factor"]
    elif rope_type == "gguf_factors":
        inv_freq = inv_freq / np.asarray(rs["factors"], dtype=np.float64)
    else:
        raise NotImplementedError(f"rope_type {rope_type!r} is not ported yet")
    return inv_freq.astype(np.float32), 1.0


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: LlamaConfig, device: torch.device) -> Tuple[torch.Tensor, float]:
    """The rope frequencies on ``device``, copied there once: a copy from
    host memory on every step would make the host wait for the card."""
    inv_freq, scaling = _rope_params(cfg)
    return torch.from_numpy(inv_freq).to(device), scaling


def rope_cos_sin(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: (..., seq, head_dim) f32."""
    inv_freq, scaling = _inv_freq(cfg, positions.device)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * scaling, torch.sin(emb) * scaling


def rope_cos_sin_all(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin for the forward pass (one rope base on the dense path)."""
    return rope_cos_sin(cfg, positions)


def is_sliding_layer(cfg: LlamaConfig, layer_idx: int) -> bool:
    """Dense Llama has no sliding-window layers."""
    return False


def select_rope(cos, sin, cfg: LlamaConfig, layer_idx: int):
    """Per-layer rope tables: every dense Llama layer uses the global ones."""
    return cos, sin


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q, k, cos, sin):
    """HF-convention RoPE. q/k: (B, n_heads, S, hd); cos/sin: (B, S, hd)."""
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    qr = q * cos + _rotate_half(q) * sin
    kr = k * cos + _rotate_half(k) * sin
    return qr.to(q.dtype), kr.to(k.dtype)


# KV-chunk size for the online-softmax attention; caches at least twice
# this long stream chunks instead of materializing (S, L) scores
FLASH_CHUNK = 512


def flash_attention(q, k, v, qpos, scale=None, chunk: int = FLASH_CHUNK,
                    dynamic_length: bool = False,
                    n_live: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (plain PyTorch; the JAX
    package writes it as XLA code, not as a kernel).

    q: (B, nH, S, hd); k/v: (B, nKV, L, hd); qpos: (B, S) absolute position
    of each query (keys live at positions 0..L). Causal masking; GQA by
    head grouping. Peak memory is (S, chunk) scores per head.

    dynamic_length=True reads only the chunks up to the live fill level:
    ``n_live`` chunks when the caller knows the count (the engine does, from
    its host mirror of the fill), else max(qpos) // chunk + 1 from one
    readback. Chunks past the fill are masked entirely, so a count that is
    too high changes nothing.
    """
    B, nH, S, hd = q.shape
    nKV, L = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = nH // nKV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, nKV, G, S, hd).float() * scale

    n_chunks = -(-L // chunk)
    if dynamic_length:
        if n_live is None:
            n_live = int(qpos.max()) // chunk + 1
        n_chunks = min(n_chunks, n_live)

    m = torch.full((B, nKV, G, S), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nKV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nKV, G, S, vd), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, L)
        kc = k[:, :, lo:hi].float()
        vc = v[:, :, lo:hi].float()
        kp = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("bkgsh,bkth->bkgst", qg, kc)
        vmask = (kp[None, None, :] <= qpos[:, :, None])[:, None, None]  # (B,1,1,S,t)
        s = torch.where(vmask, s, -1e30)
        m2 = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m2)
        p = torch.where(vmask, torch.exp(s - m2[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,bkth->bkgsh", p, vc)
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, nH, S, vd).to(v.dtype)


def _act_only(x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """SiLU in f32, cast back (the dense Llama activation)."""
    return torch.nn.functional.silu(x.float()).to(x.dtype)


def _mlp_act(gate: torch.Tensor, up: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return _act_only(gate, cfg) * up


# Param dict layout (what serving/model.py builds):
# {"embed_tokens": (V, H), "norm": (H,), "lm_head": packed (absent if tied),
#  "layers": [{"input_layernorm", "post_attention_layernorm": (H,),
#              "qkv_proj" | "q_proj"/"k_proj"/"v_proj", "o_proj",
#              "gateup_proj" | "gate_proj"/"up_proj", "down_proj"}, ...]}
