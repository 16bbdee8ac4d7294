"""Dense Llama building blocks in PyTorch.

Port of the dense-Llama subset of ``gptq_gguf_tpu/models/llama.py``:
the config, RMSNorm (gemma's (1 + w) form too), RoPE (default / linear /
llama3 / longrope / gguf_factors), the SwiGLU and GELU-tanh activations,
the chunked online-softmax attention the serving path uses on long caches,
and the non-cached block the calibration walk runs (``block_capture``: the
block and the inputs of its linears). The block covers the llama, mistral,
qwen2, qwen3, gemma, gemma2 and phi3 families: qwen2's q / k / v biases,
qwen3's per-head q / k RMSNorm before rope and gemma2's extra norms
("sandwich" norms around attention and MLP) ride along as float params;
gemma2's attention logit softcap, sliding-window layers and
``query_pre_attn_scalar``, gemma's embedding scale and the final logit
softcap are config fields. Other model families, rope types and attention
variants raise ``NotImplementedError`` naming what is missing.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

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
    attention_bias: bool = False
    qk_norm: bool = False  # qwen3-style per-head q/k RMSNorm before rope
    # frozen item-tuple (or dict) of HF-style rope_scaling keys
    rope_scaling: Optional[Any] = None
    # gemma family: RMSNorm scales by (1 + w), embeddings by sqrt(hidden)
    rms_add_unit: bool = False
    embed_scale: bool = False
    act_fn: str = "silu"  # silu | gelu_tanh
    # gemma2: tanh softcaps of the attention scores and the final logits,
    # the score scale query_pre_attn_scalar ** -0.5
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    # sliding-window attention: the even layers slide, or those the
    # per-layer flags mark (HF layer_types)
    sliding_window: Optional[int] = None
    sliding_layers: Optional[Tuple[bool, ...]] = None
    dtype: torch.dtype = torch.float32

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf_dict(d: Dict[str, Any], dtype: torch.dtype = torch.float32) -> "LlamaConfig":
        """Build from a HF transformers config.json dict of the families the
        port covers (``FAMILIES``), by the JAX package's rules: mistral's,
        qwen2's and phi3's ``sliding_window`` is dropped (gemma2 keeps its
        own, sliding on the layers ``layer_types`` marks, else on even
        layers), qwen3 has the per-head q/k norm, the gemma types the (1 + w)
        norm, the embedding scale and GELU-tanh, phi3's top-level
        ``original_max_position_embeddings`` joins its ``rope_scaling``, and
        ``attention_bias`` is read as given (qwen2's biases are found by
        their tensors)."""
        mt = d.get("model_type", "llama")
        if mt not in FAMILIES:
            raise NotImplementedError(
                f"model_type {mt!r} is not ported yet (supported: {', '.join(FAMILIES)})")
        if d.get("mlp_bias"):
            raise NotImplementedError(f"{mt} with mlp_bias=True is not ported yet")
        rs = d.get("rope_scaling")
        if rs and "original_max_position_embeddings" not in rs \
                and d.get("original_max_position_embeddings"):
            rs = {**rs, "original_max_position_embeddings": d["original_max_position_embeddings"]}
        gemma = mt in ("gemma", "gemma2")
        sliding_layers = None
        if mt == "gemma2" and d.get("layer_types"):
            sliding_layers = tuple(t == "sliding_attention" for t in d["layer_types"])
        return LlamaConfig(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"), rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            attention_bias=bool(d.get("attention_bias", False)),
            qk_norm=mt == "qwen3",
            rope_scaling=_freeze_value(rs), rms_add_unit=gemma, embed_scale=gemma,
            act_fn="gelu_tanh" if gemma else "silu",
            attn_logit_softcap=d.get("attn_logit_softcapping"),
            final_logit_softcap=d.get("final_logit_softcapping"),
            query_pre_attn_scalar=d.get("query_pre_attn_scalar"),
            sliding_window=d.get("sliding_window") if mt == "gemma2" else None,
            sliding_layers=sliding_layers, dtype=dtype)


# the HF model types whose dense blocks the port runs
FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2", "phi3")


def _freeze_value(v):
    """Nested dict/list -> hashable item-tuples (the config is hashed)."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze_value(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_value(x) for x in v)
    return v


# JAX LlamaConfig fields the dense path does not implement, with the value
# that means "feature off"; config_from_reference refuses anything else
_NEUTRAL = {
    "norm_type": "rmsnorm", "partial_rotary_factor": 1.0,
    "rope_interleaved": False, "parallel_blocks": False,
    "rope_local_theta": None, "rope_sliding_only": False,
    "rope_layers": None, "qk_norm_after_rope": False,
    "clip_qkv": None, "pos_type": "rope", "sliding_pattern": 2,
    "embedding_multiplier": None, "attention_scale": None,
    "residual_multiplier": None, "logits_multiplier": None,
    "moe_num_experts": None, "kv_lora_rank": None, "mlp_bias": False,
}
# the activations the port runs
ACT_FNS = ("silu", "gelu_tanh")


def config_from_reference(ref) -> LlamaConfig:
    """The port's config from a ``gptq_gguf_tpu`` LlamaConfig (read by
    attribute, so this module needs no JAX). Raises NotImplementedError for
    a feature outside the dense Llama path."""
    for name, off in _NEUTRAL.items():
        if getattr(ref, name, off) != off:
            raise NotImplementedError(
                f"LlamaConfig.{name}={getattr(ref, name)!r} is not ported yet")
    if ref.act_fn not in ACT_FNS:
        raise NotImplementedError(f"LlamaConfig.act_fn={ref.act_fn!r} is not ported yet")
    kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(LlamaConfig)
          if f.name != "dtype"}
    return LlamaConfig(**kw, dtype=_DTYPES[np.dtype(ref.dtype).name])


# the keys of a dense block (qwen2's attention biases, qwen3's per-head
# q / k norms and gemma2's pre / post feed-forward norms among them), and
# the module-level keys of the params
_LAYER_KEYS = frozenset(("input_layernorm", "post_attention_layernorm", "q_proj", "k_proj",
                         "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
                         "q_bias", "k_bias", "v_bias", "o_bias", "q_norm", "k_norm",
                         "pre_feedforward_layernorm", "post_feedforward_layernorm"))
_TOP_KEYS = frozenset(("embed_tokens", "norm", "lm_head", "layers"))


def check_dense_layer(layer: Dict[str, Any]) -> None:
    """Raise NotImplementedError for a block that is not a dense block of
    the ported families (MoE, MLA, MLP biases, extra norms), naming the keys
    it refuses."""
    extra = sorted(set(layer) - _LAYER_KEYS)
    if extra:
        raise NotImplementedError(
            f"block params {extra} are not ported yet (dense llama / mistral / qwen2 / "
            "qwen3 / gemma / gemma2 / phi3 blocks only)")


def dense_params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig, device="cuda"):
    """The JAX package's dense param tree (numpy arrays, as its
    ``loader.load_params(host=True)`` gives) as the port's: the same keys,
    each array a tensor on ``device`` with its dtype kept."""
    from .. import resolve_device

    dev = resolve_device(device)
    extra = sorted(set(tree) - _TOP_KEYS)
    if extra:
        raise NotImplementedError(f"params {extra} are not ported yet (dense Llama only)")

    def conv(a):
        a = np.array(a, order="C")  # writable copy: arrays from JAX are read-only
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = []
    for layer in tree["layers"]:
        check_dense_layer(layer)
        out["layers"].append({k: conv(v) for k, v in layer.items()})
    if len(out["layers"]) != cfg.num_hidden_layers:
        raise ValueError("layer count does not match the config")
    return out


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             add_unit: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back; ``add_unit`` scales by (1 + w) (gemma)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if add_unit:
        w = 1.0 + w
    return (normed * w).to(dt)


def apply_norm(x: torch.Tensor, cfg: LlamaConfig, weight: torch.Tensor) -> torch.Tensor:
    """Config-selected norm: RMSNorm, (1 + w) for the gemma family."""
    return rms_norm(x, weight, cfg.rms_norm_eps, cfg.rms_add_unit)


def _rope_params(cfg: LlamaConfig, seq_len: Optional[float] = None) -> Tuple[np.ndarray, float]:
    """(inv_freq, attention_scaling) following HF transformers'
    modeling_rope_utils for default / linear / llama3 / longrope, plus
    llama.cpp's per-dim frequency factors (``gguf_factors``,
    rope_freqs.weight). ``seq_len`` picks longrope's long factors when it
    passes ``original_max_position_embeddings`` (short ones without it)."""
    hd = cfg.head_dim_  # full rotary on the dense Llama path
    base = cfg.rope_theta
    inv_freq = 1.0 / (base ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    rs = cfg.rope_scaling
    rs = dict(rs) if rs is not None and not isinstance(rs, dict) else (rs or {})
    rope_type = rs.get("rope_type", rs.get("type"))
    scaling = 1.0
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
    elif rope_type == "longrope":
        # phi3's per-dim long / short factors and the attention scaling
        old_len = rs.get("original_max_position_embeddings", cfg.max_position_embeddings)
        use_long = seq_len is not None and seq_len > old_len
        ext = np.asarray(rs["long_factor"] if use_long else rs["short_factor"],
                         dtype=np.float64)
        factor = cfg.max_position_embeddings / old_len
        if rs.get("attention_factor") is not None:
            scaling = rs["attention_factor"]
        elif factor > 1.0:
            scaling = math.sqrt(1 + math.log(factor) / math.log(old_len))
        inv_freq = 1.0 / (ext * base ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    elif rope_type == "gguf_factors":
        inv_freq = inv_freq / np.asarray(rs["factors"], dtype=np.float64)
    else:
        raise NotImplementedError(f"rope_type {rope_type!r} is not ported yet")
    return inv_freq.astype(np.float32), float(scaling)


def uses_long_factors(cfg: LlamaConfig, seq_len: Optional[int]) -> bool:
    """Does ``seq_len`` select longrope's long factors (False for every
    other rope type)?"""
    rs = cfg.rope_scaling
    rs = dict(rs) if rs is not None and not isinstance(rs, dict) else (rs or {})
    if rs.get("rope_type", rs.get("type")) != "longrope" or seq_len is None:
        return False
    return seq_len > rs.get("original_max_position_embeddings", cfg.max_position_embeddings)


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: LlamaConfig, device: torch.device,
              long: bool = False) -> Tuple[torch.Tensor, float]:
    """The rope frequencies on ``device`` (longrope's long factors when
    ``long``), copied there once: a copy from host memory on every step
    would make the host wait for the card."""
    inv_freq, scaling = _rope_params(cfg, math.inf if long else None)
    return torch.from_numpy(inv_freq).to(device), scaling


def rope_cos_sin(cfg: LlamaConfig, positions: torch.Tensor,
                 seq_len: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: (..., seq, head_dim) f32.
    ``seq_len`` picks longrope's factors (``_rope_params``)."""
    inv_freq, scaling = _inv_freq(cfg, positions.device, uses_long_factors(cfg, seq_len))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * scaling, torch.sin(emb) * scaling


def rope_cos_sin_all(cfg: LlamaConfig, positions: torch.Tensor, seq_len: Optional[int] = None):
    """cos/sin for the forward pass (one rope base on the dense path)."""
    return rope_cos_sin(cfg, positions, seq_len)


def is_sliding_layer(cfg: LlamaConfig, layer_idx: int) -> bool:
    """Does this layer use sliding-window attention?"""
    if not cfg.sliding_window:
        return False
    if cfg.sliding_layers is not None:
        return bool(cfg.sliding_layers[layer_idx])
    return layer_idx % 2 == 0


def layer_window(cfg: LlamaConfig, layer_idx: int) -> Optional[int]:
    """The layer's sliding window, or None for full attention."""
    return cfg.sliding_window if is_sliding_layer(cfg, layer_idx) else None


def attention_scale(cfg: LlamaConfig) -> Optional[float]:
    """The score scale: ``query_pre_attn_scalar ** -0.5`` (gemma2), or None
    for the default 1 / sqrt(head_dim)."""
    if cfg.query_pre_attn_scalar is not None:
        return cfg.query_pre_attn_scalar ** -0.5
    return None


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(x / cap), or x unchanged without a cap."""
    return cap * torch.tanh(x / cap) if cap else x


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

# int4 KV group size: one symmetric f32 scale per KV_Q4_GROUP consecutive
# head-dim features
KV_Q4_GROUP = 32


def dequant_kv_q4(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Unpack split-layout int4 KV: (..., hd//2) u8 codes (low nibbles hold
    the first hd/2 features, high nibbles the rest; codes carry +8) and
    (..., hd//KV_Q4_GROUP) f32 group scales -> (..., hd) f32."""
    lo = (codes & 0xF).to(torch.int32) - 8
    hi = (codes >> 4).to(torch.int32) - 8
    w = torch.cat([lo, hi], dim=-1).float()
    return w * torch.repeat_interleave(scales.float(), KV_Q4_GROUP, dim=-1)


def flash_attention(q, k, v, qpos, scale=None, logit_softcap=None, sliding_window=None,
                    chunk: int = FLASH_CHUNK, dynamic_length: bool = False,
                    n_live: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (plain PyTorch; the JAX
    package writes it as XLA code, not as a kernel).

    q: (B, nH, S, hd); k/v: (B, nKV, L, hd); qpos: (B, S) absolute position
    of each query (keys live at positions 0..L). Causal masking; GQA by
    head grouping. Peak memory is (S, chunk) scores per head.
    logit_softcap caps the scores before masking; sliding_window keeps the
    keys with qpos - kpos < window.

    dynamic_length=True reads only the chunks up to the live fill level:
    ``n_live`` chunks when the caller knows the count (the engine does, from
    its host mirror of the fill), else max(qpos) // chunk + 1 from one
    readback. Chunks past the fill are masked entirely, so a count that is
    too high changes nothing.

    k_scale / v_scale: (B, nKV, L) per-entry scales of an int8 cache, or
    (B, nKV, L, hd // KV_Q4_GROUP) group scales of a packed int4 cache (k / v
    then hold two codes per byte); each chunk is dequantized as it is cast
    to f32, and the output is f32.
    """
    B, nH, S, hd = q.shape
    nKV, L = k.shape[1], k.shape[2]
    q4 = k_scale is not None and k_scale.ndim == 4
    vd = v.shape[-1] * (2 if q4 else 1)
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
        if q4:
            kc = dequant_kv_q4(k[:, :, lo:hi], k_scale[:, :, lo:hi])
            vc = dequant_kv_q4(v[:, :, lo:hi], v_scale[:, :, lo:hi])
        else:
            kc = k[:, :, lo:hi].float()
            vc = v[:, :, lo:hi].float()
            if k_scale is not None:
                kc = kc * k_scale[:, :, lo:hi, None]
                vc = vc * v_scale[:, :, lo:hi, None]
        kp = torch.arange(lo, hi, device=q.device)
        s = softcap(torch.einsum("bkgsh,bkth->bkgst", qg, kc), logit_softcap)
        valid = kp[None, None, :] <= qpos[:, :, None]
        if sliding_window:
            valid = valid & ((qpos[:, :, None] - kp[None, None, :]) < sliding_window)
        vmask = valid[:, None, None]  # (B,1,1,S,t)
        s = torch.where(vmask, s, -1e30)
        m2 = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m2)
        p = torch.where(vmask, torch.exp(s - m2[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,bkth->bkgsh", p, vc)
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, nH, S, vd).to(v.dtype if k_scale is None else torch.float32)


def _act_only(x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """SiLU, or GELU's tanh form (gemma), in f32, cast back."""
    if cfg.act_fn == "gelu_tanh":
        return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)
    return torch.nn.functional.silu(x.float()).to(x.dtype)


def _mlp_act(gate: torch.Tensor, up: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return _act_only(gate, cfg) * up


# ---------------------------------------------------------------------------
# The non-cached block (calibration and propagation)
# ---------------------------------------------------------------------------


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w^T with f32 accumulation, cast back to x's dtype."""
    y = torch.matmul(x.float(), w.float().T)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def add_qkv_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 layer: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qwen2's q / k / v biases added to the projections' outputs (the
    serving forwards, whose kernels take no bias). An f32 bias makes a bf16
    output f32, as the JAX package's promotion does."""
    if layer.get("q_bias") is None:
        return q, k, v
    return q + layer["q_bias"], k + layer["k_bias"], v + layer["v_bias"]


def head_qk_norm(q: torch.Tensor, k: torch.Tensor, layer: Dict[str, Any],
                 cfg: LlamaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwen3's per-head q / k RMSNorm over the last (head_dim) axis, applied
    after the head split and before rope; q and k unchanged without
    ``cfg.qk_norm``. The flat (olmo2) form, one norm over all heads, is
    refused."""
    if not cfg.qk_norm:
        return q, k
    if layer["q_norm"].shape[0] != cfg.head_dim_:
        raise NotImplementedError(
            "the flat (olmo2-style) q / k norm over all heads is not ported yet")
    return (rms_norm(q, layer["q_norm"], cfg.rms_norm_eps),
            rms_norm(k, layer["k_norm"], cfg.rms_norm_eps))


def attention_scores(q, k, v, mask, scale=None, logit_softcap=None) -> torch.Tensor:
    """Plain attention: q (B, nH, S, hd), k/v (B, nKV, S, hd), mask (B, S, S)
    bool; GQA by head grouping; the softcap goes before the mask. Returns
    f32 (B, nH, S, hd)."""
    B, nH, S, hd = q.shape
    nKV = k.shape[1]
    qg = q.reshape(B, nKV, nH // nKV, S, hd)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgsh,bkth->bkgst", qg.float(), k.float()) * scale
    scores = softcap(scores, logit_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,bkth->bkgsh", probs.float(), v.float())
    return out.reshape(B, nH, S, v.shape[-1])


def causal_mask(B: int, S: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((S, S), dtype=torch.bool, device=device)).expand(B, S, S)


def _sliding_mask(mask: torch.Tensor, window: int) -> torch.Tensor:
    """``mask`` with the keys at window or more positions back cut off."""
    S = mask.shape[-1]
    pos = torch.arange(S, device=mask.device)
    return mask & ((pos[:, None] - pos[None, :]) < window)[None]


def block_capture(layer: Dict[str, torch.Tensor], x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, mask: torch.Tensor, cfg: LlamaConfig,
                  layer_idx: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One dense block, also returning the inputs of its quantizable
    linears: (out, {"qkv", "o", "gateup", "down"}). x: (B, S, H); cos/sin:
    (B, S, hd); mask: (B, S, S) causal. Attention biases are added inside
    the linears (f32, before the cast back), and the per-head q / k norm
    runs before rope, as in the JAX package's block. gemma2's block
    (``pre_feedforward_layernorm`` present) normalizes the attention output
    by ``post_attention_layernorm`` before the residual add, the MLP input
    by ``pre_feedforward_layernorm`` and its output by
    ``post_feedforward_layernorm``; a sliding layer masks keys at
    ``sliding_window`` or more positions back."""
    check_dense_layer(layer)
    B, S, H = x.shape
    hd = cfg.head_dim_
    nH, nKV = cfg.num_attention_heads, cfg.num_key_value_heads
    window = layer_window(cfg, layer_idx)
    scale = attention_scale(cfg)
    h1 = apply_norm(x, cfg, layer["input_layernorm"])
    q = _linear(h1, layer["q_proj"], layer.get("q_bias")).reshape(B, S, nH, hd).transpose(1, 2)
    k = _linear(h1, layer["k_proj"], layer.get("k_bias")).reshape(B, S, nKV, hd).transpose(1, 2)
    v = _linear(h1, layer["v_proj"], layer.get("v_bias")).reshape(B, S, nKV, hd).transpose(1, 2)
    q, k = head_qk_norm(q, k, layer, cfg)
    q, k = apply_rope(q, k, cos, sin)
    if S >= 2 * FLASH_CHUNK:
        # long sequences stream KV chunks (the causal mask is implied)
        qpos = torch.arange(S, device=x.device).expand(B, S)
        attn = flash_attention(q, k, v, qpos, scale, cfg.attn_logit_softcap, window)
    else:
        attn = attention_scores(q, k, v, mask if window is None else _sliding_mask(mask, window),
                                scale, cfg.attn_logit_softcap)
    attn = attn.transpose(1, 2).reshape(B, S, nH * hd)
    attn_out = _linear(attn, layer["o_proj"], layer.get("o_bias"))
    sandwich = "pre_feedforward_layernorm" in layer
    if sandwich:
        attn_out = apply_norm(attn_out, cfg, layer["post_attention_layernorm"])
    x = x + attn_out
    h2 = apply_norm(x, cfg, layer["pre_feedforward_layernorm" if sandwich
                                  else "post_attention_layernorm"])
    gate = _linear(h2, layer["gate_proj"])
    up = _linear(h2, layer["up_proj"])
    down_in = _mlp_act(gate, up, cfg)
    mlp_out = _linear(down_in, layer["down_proj"])
    if "post_feedforward_layernorm" in layer:
        mlp_out = apply_norm(mlp_out, cfg, layer["post_feedforward_layernorm"])
    x = x + mlp_out
    return x, {"qkv": h1, "o": attn, "gateup": h2, "down": down_in}


def block_forward(layer, x, cos, sin, mask, cfg: LlamaConfig, layer_idx: int = 0) -> torch.Tensor:
    """One dense block: (B, S, H) -> (B, S, H)."""
    return block_capture(layer, x, cos, sin, mask, cfg, layer_idx)[0]


def scale_embeddings(x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """gemma's sqrt(hidden) embedding scale, the factor itself cast to
    ``cfg.dtype`` first (59.75 in bf16, 59.866... in f32 at hidden 3584), as
    the JAX package multiplies."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype, device=x.device)


def final_softcap(logits: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """gemma2's final logit softcap (logits unchanged without one)."""
    return softcap(logits, cfg.final_logit_softcap)


def embed_forward(params, input_ids: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return scale_embeddings(params["embed_tokens"][input_ids].to(cfg.dtype), cfg)


def head_forward(params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Final norm + lm head (+ the final softcap) -> logits (B, S, V) in f32."""
    h = apply_norm(x, cfg, params["norm"])
    w = params.get("lm_head", params["embed_tokens"])
    return final_softcap(torch.matmul(h.float(), w.float().T), cfg)


def forward(params, input_ids: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Full forward pass of dense params: (B, S) ids -> logits (B, S, V) f32.
    Longrope picks its factors by the sequence length S."""
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    cos, sin = rope_cos_sin_all(cfg, positions, seq_len=S)
    mask = causal_mask(B, S, device=input_ids.device)
    x = embed_forward(params, input_ids, cfg)
    for li, layer in enumerate(params["layers"]):
        x = block_forward(layer, x, cos, sin, mask, cfg, li)
    return head_forward(params, x, cfg)


# ---------------------------------------------------------------------------
# Quantizable-layer accounting: the HF module names, so artifact
# directories match the JAX package's
# ---------------------------------------------------------------------------

BLOCK_LINEAR_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
)


def linear_layer_names(cfg: LlamaConfig, include_non_block: bool = False) -> List[str]:
    names = ["model.embed_tokens"] if include_non_block else []
    for i in range(cfg.num_hidden_layers):
        for key in BLOCK_LINEAR_KEYS:
            mod = "self_attn" if key[0] in "qkvo" else "mlp"
            names.append(f"model.layers.{i}.{mod}.{key}")
    if include_non_block and not cfg.tie_word_embeddings:
        names.append("lm_head")
    return names


def get_linear(params, name: str) -> torch.Tensor:
    """A weight matrix by HF module name."""
    if name == "model.embed_tokens":
        return params["embed_tokens"]
    if name == "lm_head":
        return params.get("lm_head", params["embed_tokens"])
    parts = name.split(".")
    return params["layers"][int(parts[2])][parts[4]]


def set_linear(params, name: str, value):
    """A copy of params with one weight matrix replaced (by HF module name)."""
    if name == "model.embed_tokens":
        return {**params, "embed_tokens": value}
    if name == "lm_head":
        return {**params, "lm_head": value}
    parts = name.split(".")
    idx = int(parts[2])
    layers = list(params["layers"])
    layers[idx] = {**layers[idx], parts[4]: value}
    return {**params, "layers": layers}


# Param dict layout (what serving/model.py builds):
# {"embed_tokens": (V, H), "norm": (H,), "lm_head": packed (absent if tied),
#  "layers": [{"input_layernorm", "post_attention_layernorm": (H,),
#              ["pre_feedforward_layernorm", "post_feedforward_layernorm": (H,)],
#              "qkv_proj" | "q_proj"/"k_proj"/"v_proj", "o_proj",
#              "gateup_proj" | "gate_proj"/"up_proj", "down_proj",
#              ["q_bias"/"k_bias"/"v_bias"/"o_bias": (d_out,) f32],
#              ["q_norm"/"k_norm": (hd,)]}, ...]}
