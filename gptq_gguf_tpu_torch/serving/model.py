"""Quantized serving model: a KV-cached dense model over runtime-packed weights.

Port of the dense path of ``gptq_gguf_tpu/serving/model.py`` for the llama,
mistral, qwen2, qwen3, gemma, gemma2 and phi3 families (qwen2's q / k / v
biases, qwen3's per-head q / k norm and gemma2's extra norms ride along as
float params; gemma2's softcaps, sliding windows and score scale, gemma's
embedding scale and phi3's longrope factors come from the config). Every
projection and the lm_head go through ``ops.qmatmul.dequant_matmul``, which routes each packed
weight to its format's CUDA kernel on the card (v1, v2g or v4). The KV
cache is a preallocated per-layer (B, n_kv, max_len + 1, hd) buffer
updated in place: row ``max_len`` is a drop row that absorbs writes
past the end of the cache (the JAX package drops them with
``.at[...].set(mode="drop")``), so retired slots can keep decoding inside a
block without a bounds check on the host. The cache holds bf16 entries
(``KVCache``), int8 codes with per-entry scales (``KVCacheQ8``) or split-nibble
int4 codes with per-group scales (``KVCacheQ4``), the JAX package's layouts.

A model is built from a .gguf file (``load_gguf_for_serving``, packed in
``qmatmul.RUNTIME_FORMAT`` or, with ``dense=True``, dequantized to dense
arrays) or from dense params plus a calibration artifacts tree
(``quantize_params_for_serving``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..formats import convert, ggml
from ..formats.ggml import KQUANT_SPECS, K_QUANT_TYPES, GGMLQuantizationType
from ..mapper.shards import open_gguf
from ..models import llama
from ..models.llama import LlamaConfig
from ..ops import qmatmul, qmv4
from ..ops.kquant import SuperGroupParams
from ..ops.qmatmul import RuntimeQuantLinear, RuntimeQuantLinearV2
from ..ops.qmv4 import RuntimeQuantLinearV4

_QUANT_TYPES = (RuntimeQuantLinear, RuntimeQuantLinearV2, RuntimeQuantLinearV4)


def _dequant_any(w) -> torch.Tensor:
    """(d_out, d_in) f32 of a packed weight of any format."""
    if isinstance(w, RuntimeQuantLinearV4):
        return qmv4.dequantize_runtime_v4(w)
    if isinstance(w, RuntimeQuantLinearV2):
        return qmatmul.dequantize_runtime_v2(w)
    return qmatmul.dequantize_runtime(w)


def _q_linear(x: torch.Tensor, w) -> torch.Tensor:
    """Apply a packed quantized weight (its format's kernel) or a dense matrix."""
    if isinstance(w, _QUANT_TYPES):
        shape = x.shape[:-1]
        y = qmatmul.dequant_matmul(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*shape, w.d_out).to(x.dtype)
    return (x.float() @ w.float().T).to(x.dtype)


class KVCache(NamedTuple):
    k: List[torch.Tensor]  # per layer (B, n_kv, max_len + 1, hd); last row = drop row
    v: List[torch.Tensor]
    lengths: torch.Tensor  # (B,) int32: tokens already cached per slot

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] - 1


class KVCacheQ8(NamedTuple):
    """int8 KV cache: per-(slot, head, position) symmetric f32 scales (the
    JAX package's layout, plus the drop row); llama.cpp's q8_0 KV analogue."""

    k: List[torch.Tensor]    # per layer (B, n_kv, max_len + 1, hd) int8
    v: List[torch.Tensor]
    k_s: List[torch.Tensor]  # per layer (B, n_kv, max_len + 1) f32
    v_s: List[torch.Tensor]
    lengths: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] - 1


# int4 KV group size: one symmetric f32 scale per KV_Q4_GROUP consecutive
# head-dim features (per slot, head, position)
KV_Q4_GROUP = llama.KV_Q4_GROUP


class KVCacheQ4(NamedTuple):
    """int4 KV cache: two codes per byte (split layout: feature j < hd/2 in
    byte j's low nibble, feature j >= hd/2 in byte j - hd/2's high nibble),
    one symmetric f32 scale per KV_Q4_GROUP features (the JAX package's
    layout, plus the drop row)."""

    k: List[torch.Tensor]    # per layer (B, n_kv, max_len + 1, hd // 2) uint8
    v: List[torch.Tensor]
    k_s: List[torch.Tensor]  # per layer (B, n_kv, max_len + 1, hd // 32) f32
    v_s: List[torch.Tensor]
    lengths: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] - 1


_QUANT_CACHES = (KVCacheQ8, KVCacheQ4)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               kv_dtype: Optional[str] = None, device="cuda"):
    """Zeroed contiguous cache with a drop row: kv_dtype None / "bf16" uses
    ``dtype`` (KVCache), "int8" KVCacheQ8, "int4" KVCacheQ4 (head_dim a
    multiple of 2 * KV_Q4_GROUP, as in the JAX package)."""
    dev = resolve_device(device)
    n = cfg.num_hidden_layers
    hd = cfg.head_dim_
    rows = (batch, cfg.num_key_value_heads, max_len + 1)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)

    def bufs(shape, dt):
        return [torch.zeros(shape, dtype=dt, device=dev) for _ in range(n)]

    if kv_dtype in (None, "bf16"):
        return KVCache(bufs(rows + (hd,), dtype), bufs(rows + (hd,), dtype), lengths)
    if kv_dtype == "int8":
        return KVCacheQ8(bufs(rows + (hd,), torch.int8), bufs(rows + (hd,), torch.int8),
                         bufs(rows, torch.float32), bufs(rows, torch.float32), lengths)
    if kv_dtype == "int4":
        if hd % (2 * KV_Q4_GROUP):
            raise NotImplementedError(
                f"int4 KV needs head_dim divisible by {2 * KV_Q4_GROUP}, got {hd}")
        codes, scales = rows + (hd // 2,), rows + (hd // KV_Q4_GROUP,)
        return KVCacheQ4(bufs(codes, torch.uint8), bufs(codes, torch.uint8),
                         bufs(scales, torch.float32), bufs(scales, torch.float32), lengths)
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}")


def slot_view(cache, slot: int, lengths: torch.Tensor):
    """A one-slot cache of views into ``cache``'s buffers (codes and scales
    alike), with ``lengths`` (1,): writes through it land in the slot."""
    def take(bufs):
        return [b[slot:slot + 1] for b in bufs]

    if isinstance(cache, _QUANT_CACHES):
        return type(cache)(take(cache.k), take(cache.v), take(cache.k_s), take(cache.v_s),
                           lengths)
    return KVCache(take(cache.k), take(cache.v), lengths)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 codes, (...) f32 scales), symmetric per entry;
    rounds half to even, as the JAX package does."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(s > 0, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return q.to(torch.int8), s


def _quantize_kv_q4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (u8 packed codes (..., hd//2), f32 group scales
    (..., hd//KV_Q4_GROUP)): symmetric int4 per group of KV_Q4_GROUP
    features, codes + 8, low nibbles holding the first hd/2 features.
    Rounds half to even, as the JAX package does."""
    gs = llama.KV_Q4_GROUP
    hd = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], hd // gs, gs)
    s = xf.abs().amax(dim=-1) / 7.0
    inv = torch.where(s > 0, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(xf * inv[..., None]), -7, 7).to(torch.int32)
    q = (q + 8).reshape(*x.shape[:-1], hd).to(torch.uint8)
    return q[..., : hd // 2] | (q[..., hd // 2:] << 4), s


def _cached_attention(q, k_cache, v_cache, lengths, scale=None, logit_softcap=None,
                      sliding_window=None, n_live: Optional[int] = None, k_scale=None,
                      v_scale=None):
    """q: (B, nH, S, hd); caches (B, nKV, L, hd); slot b's queries sit at
    positions lengths[b] + [0, S). Long caches stream through the
    online-softmax path; decode reads only the ``n_live`` live chunks.
    logit_softcap caps the scores before masking; sliding_window keeps the
    keys fewer than ``sliding_window`` positions back.
    k_scale / v_scale: the per-entry scales of an int8 cache (B, nKV, L) or
    the group scales of an int4 cache (B, nKV, L, hd // KV_Q4_GROUP)."""
    B, nH, S, hd = q.shape
    nKV = k_cache.shape[1]
    L = k_cache.shape[2]
    ar = torch.arange(S, device=q.device)
    if L >= 2 * llama.FLASH_CHUNK:
        qpos = lengths[:, None] + ar[None, :]
        return llama.flash_attention(
            q, k_cache, v_cache, qpos, scale, logit_softcap, sliding_window,
            dynamic_length=(S == 1), n_live=n_live, k_scale=k_scale,
            v_scale=v_scale).to(q.dtype)
    if k_scale is not None and k_scale.ndim == 4:  # int4 packed cache
        k_cache = llama.dequant_kv_q4(k_cache, k_scale)
        v_cache = llama.dequant_kv_q4(v_cache, v_scale)
    elif k_scale is not None:
        k_cache = k_cache.float() * k_scale[..., None]
        v_cache = v_cache.float() * v_scale[..., None]
    groups = nH // nKV
    qg = q.reshape(B, nKV, groups, S, hd)
    scale = scale if scale is not None else 1.0 / float(np.sqrt(hd))
    scores = torch.einsum("bkgsh,bkth->bkgst", qg.float(), k_cache.float()) * scale
    scores = llama.softcap(scores, logit_softcap)
    pos = torch.arange(L, device=q.device)[None, None, :]
    qpos = lengths[:, None, None] + ar[None, :, None]
    mask = pos <= qpos  # (B, S, L) causal per slot
    if sliding_window:
        mask = mask & ((qpos - pos) < sliding_window)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgst,bkth->bkgsh", probs.float(), v_cache.float())
    return out.reshape(B, nH, S, v_cache.shape[-1])


def forward_cached(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    input_ids: torch.Tensor,
    cache: KVCache,
    n_valid: Optional[torch.Tensor] = None,
    fill_max: Optional[int] = None,
    all_logits: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Run S new tokens through the model with the KV cache.

    input_ids: (B, S) — prefill uses S > 1, decode S = 1. Slot b's new
    tokens land at positions cache.lengths[b] + [0, S); the K/V buffers are
    written IN PLACE (writes past max_len land in the drop row). Returns
    (logits of the final position (B, vocab) f32, cache with advanced
    lengths; the K/V buffers are the same tensors).

    n_valid (B,) marks right-padded prefill buckets: logits come from
    position n_valid[b] - 1 and lengths advance by n_valid.

    fill_max: host-side max(cache.lengths), which fixes how many KV chunks
    a decode step reads on a long cache; without it the step reads the
    lengths back once (never once per layer).

    all_logits=True returns the logits of every fed position, (B, S, vocab)
    f32: the lm_head runs once over all B * S rows (perplexity scoring).

    Longrope picks its factors by the cache's capacity (llama.cpp's rule,
    as the JAX package), not by the live length.
    """
    if all_logits and n_valid is not None:
        raise ValueError("all_logits scores every position; n_valid does not apply")
    B, S = input_ids.shape
    hd = cfg.head_dim_
    lengths = cache.lengths
    L = cache.max_len
    dev = input_ids.device

    positions = lengths[:, None] + torch.arange(S, device=dev)[None, :]
    cos, sin = llama.rope_cos_sin_all(cfg, positions, seq_len=L)
    write_pos = torch.where(positions < L, positions, L)  # L = drop row
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    n_live = None
    if L >= 2 * llama.FLASH_CHUNK and S == 1:
        top = int(lengths.max()) if fill_max is None else int(fill_max)
        n_live = top // llama.FLASH_CHUNK + 1

    # int8 / int4 caches: each new entry quantized as it is written
    quant = {KVCacheQ8: _quantize_kv, KVCacheQ4: _quantize_kv_q4}.get(type(cache))
    scale = llama.attention_scale(cfg)
    x = llama.embed_forward(params, input_ids, cfg)
    for li, layer in enumerate(params["layers"]):
        h = llama.apply_norm(x, cfg, layer["input_layernorm"])
        if "qkv_proj" in layer:
            # fused q/k/v: one kernel launch (serving-time fusion)
            qkv = _q_linear(h, layer["qkv_proj"])
            kv_dim = cfg.num_key_value_heads * hd
            d_q = qkv.shape[-1] - 2 * kv_dim
            q, k, v = qkv[..., :d_q], qkv[..., d_q:d_q + kv_dim], qkv[..., d_q + kv_dim:]
        else:
            q = _q_linear(h, layer["q_proj"])
            k = _q_linear(h, layer["k_proj"])
            v = _q_linear(h, layer["v_proj"])
        q, k, v = llama.add_qkv_bias(q, k, v, layer)
        nH = q.shape[-1] // hd
        nKV = k.shape[-1] // hd
        q = q.reshape(B, S, nH, hd).transpose(1, 2)
        k = k.reshape(B, S, nKV, hd).transpose(1, 2)
        v = v.reshape(B, S, nKV, hd).transpose(1, 2)
        q, k = llama.head_qk_norm(q, k, layer, cfg)
        cos_l, sin_l = llama.select_rope(cos, sin, cfg, li)
        q, k = llama.apply_rope(q, k, cos_l, sin_l)

        k_buf, v_buf = cache.k[li], cache.v[li]
        k_new, v_new = k.transpose(1, 2), v.transpose(1, 2)  # (B, S, nKV, hd)
        ks = vs = None
        if quant is not None:
            kq, k_s = quant(k_new)
            vq, v_s = quant(v_new)
            k_buf[bidx, :, write_pos] = kq
            v_buf[bidx, :, write_pos] = vq
            cache.k_s[li][bidx, :, write_pos] = k_s
            cache.v_s[li][bidx, :, write_pos] = v_s
            ks, vs = cache.k_s[li][:, :, :L], cache.v_s[li][:, :, :L]
        else:
            k_buf[bidx, :, write_pos] = k_new.to(k_buf.dtype)
            v_buf[bidx, :, write_pos] = v_new.to(v_buf.dtype)
        attn = _cached_attention(q, k_buf[:, :, :L], v_buf[:, :, :L], lengths, scale,
                                 cfg.attn_logit_softcap, llama.layer_window(cfg, li),
                                 n_live=n_live, k_scale=ks, v_scale=vs)
        attn = attn.transpose(1, 2).reshape(B, S, nH * hd)
        x = _mlp_block(x, _o_proj(attn, layer), layer, cfg)

    if all_logits:
        last = x
        advance = S
    elif n_valid is None:
        last = x[:, -1, :]
        advance = S
    else:
        last = x[torch.arange(B, device=dev), n_valid - 1, :]
        advance = n_valid
    logits = _head_logits(params, cfg, llama.apply_norm(last, cfg, params["norm"]))
    return logits, cache._replace(lengths=(lengths + advance).to(torch.int32))


def _o_proj(attn: torch.Tensor, layer: Dict[str, Any]) -> torch.Tensor:
    """The attention output projection, plus its bias where the layer has one."""
    out = _q_linear(attn, layer["o_proj"])
    return out if layer.get("o_bias") is None else out + layer["o_bias"]


def _mlp_block(x: torch.Tensor, attn_out: torch.Tensor, layer: Dict[str, Any],
               cfg: LlamaConfig) -> torch.Tensor:
    """The rest of a block after the attention output projection: the
    residual add and the MLP with its norms (gemma2's sandwich norms where
    the layer has ``pre_feedforward_layernorm``); fused (``gateup_proj``) or
    apart."""
    sandwich = "pre_feedforward_layernorm" in layer
    if sandwich:
        attn_out = llama.apply_norm(attn_out, cfg, layer["post_attention_layernorm"])
    x = x + attn_out
    h = llama.apply_norm(x, cfg, layer["pre_feedforward_layernorm" if sandwich
                                       else "post_attention_layernorm"])
    if "gateup_proj" in layer:
        gate, up = torch.chunk(_q_linear(h, layer["gateup_proj"]), 2, dim=-1)
    else:
        gate = _q_linear(h, layer["gate_proj"])
        up = _q_linear(h, layer["up_proj"])
    mlp_out = _q_linear(llama._mlp_act(gate, up, cfg), layer["down_proj"])
    if "post_feedforward_layernorm" in layer:
        mlp_out = llama.apply_norm(mlp_out, cfg, layer["post_feedforward_layernorm"])
    return x + mlp_out


def _head_logits(params: Dict[str, Any], cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """(..., vocab) f32 logits of the normed final hidden states (..., H),
    the final softcap applied; a packed head runs once over all leading
    positions."""
    head = params.get("lm_head", params["embed_tokens"])
    if isinstance(head, _QUANT_TYPES):
        logits = qmatmul.dequant_matmul(h.reshape(-1, h.shape[-1]), head)
        logits = logits.reshape(*h.shape[:-1], head.d_out)
        if logits.shape[-1] > cfg.vocab_size:
            logits = logits[..., :cfg.vocab_size]  # drop pad_dout_v2 rows
    else:
        logits = h.float() @ head.float().T  # dense (or tied) head
    return llama.final_softcap(logits, cfg)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _fuse(parts) -> Optional[Any]:
    """One packed weight of the parts concatenated along d_out (v2 or v4),
    or None: v1 weights, mixed formats or layouts (a Q4_K_M layer's Q4_K
    q/k with a Q6_K v) stay apart, as in the JAX package."""
    fused = qmatmul.fuse_rql_v2(parts)
    return fused if fused is not None else qmv4.fuse_rql_v4(parts)


def fuse_layer_projections(layer: Dict[str, Any], cfg: Optional[LlamaConfig] = None) -> Dict[str, Any]:
    """Fuse q/k/v and gate/up packed weights into single kernel launches
    (exact: concatenation along output columns). No-op when the parts do
    not share a fusable format and layout; q/k/v stay apart when the layer
    has attention biases, as in the JAX package (gate/up still fuse)."""
    out = dict(layer)
    if "q_proj" in out and out.get("q_bias") is None and "qkv_proj" not in out:
        fused = _fuse([out["q_proj"], out["k_proj"], out["v_proj"]])
        if fused is not None:
            out["qkv_proj"] = fused
            for k in ("q_proj", "k_proj", "v_proj"):
                del out[k]
    if "gate_proj" in out and "gateup_proj" not in out:
        fused = _fuse([out["gate_proj"], out["up_proj"]])
        if fused is not None:
            out["gateup_proj"] = fused
            del out["gate_proj"]
            del out["up_proj"]
    return out


def fuse_params_for_serving(params: Dict[str, Any], cfg: LlamaConfig) -> Dict[str, Any]:
    return {**params,
            "layers": [fuse_layer_projections(l, cfg) for l in params["layers"]]}


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from JAX
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


# (a plane only that format has, class, plane names, int / str fields) of
# each packed format
_PACKED_DICTS = (
    ("d_sg", RuntimeQuantLinearV2, ("qs", "d_sg", "dmin_sg", "sc_q", "mn_q"),
     ("d_in", "group_size", "per_byte", "shift", "d_rep")),
    ("scale_t", RuntimeQuantLinear, ("qs", "scale_t", "offset_t"),
     ("d_in", "group_size", "per_byte")),
    ("offc", RuntimeQuantLinearV4, ("qs", "scale", "offc"),
     ("d_in", "group_size", "per_byte", "layout")),
)


def params_from_numpy(tree, cfg: LlamaConfig, device="cuda"):
    """Serving params of the JAX package, given as numpy, as the port's
    params. Each packed weight (v1, v2 or v4) arrives as a dict of its
    numpy planes (None where absent) plus its ints (and the v4 layout);
    arrays keep their dtype (a bf16 v4 scale may be an ml_dtypes array)."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict) and "qs" in v:
            for key, cls, planes, fields in _PACKED_DICTS:
                if key in v:
                    return cls(*(None if v[k] is None else _to_tensor(v[k], dev)
                                 for k in planes), *(v[k] for k in fields))
            raise ValueError(f"packed weight of unknown format: {sorted(v)}")
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return _to_tensor(v, dev)

    out = conv(tree)
    emb = out["embed_tokens"]
    if tuple(emb.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f"embed_tokens {tuple(emb.shape)} does not match the config")
    if len(out["layers"]) != cfg.num_hidden_layers:
        raise ValueError("layer count does not match the config")
    return out


def quantize_params_for_serving(params: Dict[str, Any], cfg: LlamaConfig,
                                artifacts_dir: Union[str, Path],
                                device="cuda") -> Dict[str, Any]:
    """Serving params from dense Llama params and a calibration artifacts
    tree: each block linear with an artifact is packed in
    ``qmatmul.RUNTIME_FORMAT`` (``pack_runtime_auto``) on ``device``; every
    other tensor (norms, embeddings, lm_head, linears without an artifact)
    stays dense and moves there. Blocks other than the dense Llama block
    (MLA projections, expert stacks) raise NotImplementedError."""
    from ..quant import artifacts as art_mod

    dev = resolve_device(device)
    available = art_mod.list_layers(artifacts_dir)
    out = {k: v.to(dev) for k, v in params.items() if k != "layers"}
    layers = []
    for li, layer in enumerate(params["layers"]):
        llama.check_dense_layer(layer)
        new_layer = {}
        for key, w in layer.items():
            mod = "self_attn" if key[0] in "qkvo" else "mlp"
            name = f"model.layers.{li}.{mod}.{key}"  # a linear's artifact name
            if name in available:
                art = art_mod.load_layer(artifacts_dir, name)
                new_layer[key] = qmatmul.pack_runtime_auto(art.qweight, art.params(),
                                                           art.q_type, device=dev)
            else:
                new_layer[key] = w.to(dev)
        layers.append(new_layer)
    out["layers"] = layers
    return out


def _packed_to(w, dev: torch.device):
    """A packed weight (v1, v2 or v4) with its planes moved to ``dev``."""
    for _, cls, planes, fields in _PACKED_DICTS:
        if type(w) is cls:
            return cls(*(None if getattr(w, k) is None else getattr(w, k).to(dev)
                         for k in planes), *(getattr(w, k) for k in fields))
    raise TypeError(f"not a packed weight: {type(w).__name__}")


# {arch}.* metadata keys that change the model beyond the dense path
_UNPORTED_KEYS = ("expert_count", "embedding_scale", "residual_scale",
                  "attention.scale", "logit_scale")

# the GGUF architectures the serving loader takes, and those whose q / k
# rows are in llama.cpp's interleaved rope layout (the JAX package's list;
# the packer permutes the same ones)
GGUF_ARCHES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2", "phi3")
PERMUTED_QK_ARCHES = ("llama", "mistral")


def _config_from_gguf(r, arch: str, dtype) -> LlamaConfig:
    """LlamaConfig from a GGUF's {arch}.* metadata; the attention biases and
    the per-head q / k norm are read off the tensors present, phi3's
    longrope from its factor tensors. gemma's norms arrive with their + 1
    folded in and serve as plain RMSNorm weights; gemma2's
    ``query_pre_attn_scalar`` falls back as llama.cpp's (hidden / heads at
    46 blocks, else head_dim); phi3's window of 0 means none (and, as in
    the JAX package, slides only the even layers)."""
    if arch not in GGUF_ARCHES:
        raise NotImplementedError(
            f"GGUF architecture {arch!r} is not supported by the serving "
            f"loader of the port (supported: {', '.join(GGUF_ARCHES)})")
    for key in _UNPORTED_KEYS:
        if r.get(f"{arch}.{key}") is not None:
            raise NotImplementedError(f"GGUF key {arch}.{key} is not ported yet")
    n_head = r.get(f"{arch}.attention.head_count")
    hidden = r.get(f"{arch}.embedding_length")
    head_dim = r.get(f"{arch}.attention.key_length",
                     r.get(f"{arch}.rope.dimension_count", hidden // n_head))
    if r.get(f"{arch}.rope.dimension_count", head_dim) != head_dim:
        raise NotImplementedError("partial rotary embeddings are not ported yet")
    n_layers = r.get(f"{arch}.block_count")
    qpas = None
    if arch == "gemma2":
        qpas = r.get(f"{arch}.attention.query_pre_attn_scalar",
                     hidden / n_head if n_layers == 46 else head_dim)
    rope_scaling = None
    if "rope_factors_long.weight" in r.tensors and "rope_factors_short.weight" in r.tensors:
        rope_scaling = (
            ("rope_type", "longrope"),
            ("long_factor", tuple(float(x) for x in r.tensor_float("rope_factors_long.weight"))),
            ("short_factor", tuple(float(x)
                                   for x in r.tensor_float("rope_factors_short.weight"))),
            ("original_max_position_embeddings",
             int(r.get(f"{arch}.rope.scaling.original_context_length", 4096))),
        )
        if r.get(f"{arch}.rope.scaling.attn_factor") is not None:
            rope_scaling += (("attention_factor",
                              float(r.get(f"{arch}.rope.scaling.attn_factor"))),)
    elif "rope_freqs.weight" in r.tensors:
        rope_scaling = (
            ("factors", tuple(float(x) for x in r.tensor_float("rope_freqs.weight"))),
            ("rope_type", "gguf_factors"),
        )
    elif r.get(f"{arch}.rope.scaling.type") is not None:
        rtype = r.get(f"{arch}.rope.scaling.type")
        if rtype != "linear":
            raise NotImplementedError(f"rope scaling type {rtype!r} is not ported yet")
        rope_scaling = (
            ("factor", float(r.get(f"{arch}.rope.scaling.factor", 1.0))),
            ("rope_type", "linear"),
        )
    gemma = arch in ("gemma", "gemma2")
    return LlamaConfig(
        vocab_size=r.get(f"{arch}.vocab_size") or len(r.get("tokenizer.ggml.tokens", [])),
        hidden_size=hidden,
        intermediate_size=r.get(f"{arch}.feed_forward_length"),
        num_hidden_layers=n_layers,
        num_attention_heads=n_head,
        num_key_value_heads=r.get(f"{arch}.attention.head_count_kv", n_head),
        head_dim=head_dim,
        rms_norm_eps=r.get(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5),
        rope_theta=r.get(f"{arch}.rope.freq_base", 10000.0),
        max_position_embeddings=r.get(f"{arch}.context_length", 4096),
        attention_bias="blk.0.attn_q.bias" in r.tensors,
        qk_norm="blk.0.attn_q_norm.weight" in r.tensors,
        rope_scaling=rope_scaling,
        embed_scale=gemma,
        act_fn="gelu_tanh" if gemma else "silu",
        attn_logit_softcap=(r.get(f"{arch}.attn_logit_softcapping")
                            if arch == "gemma2" else None),
        final_logit_softcap=(r.get(f"{arch}.final_logit_softcapping")
                             if arch == "gemma2" else None),
        query_pre_attn_scalar=qpas,
        sliding_window=(r.get(f"{arch}.attention.sliding_window")
                        if arch in ("gemma2", "phi3") else None) or None,
        dtype=dtype,
    )


_NAME_MAP = {
    "attn_norm": "input_layernorm",
    "ffn_norm": "post_attention_layernorm",
    "attn_q": "q_proj",
    "attn_k": "k_proj",
    "attn_v": "v_proj",
    "attn_output": "o_proj",
    "attn_q_norm": "q_norm",
    "attn_k_norm": "k_norm",
    "ffn_gate": "gate_proj",
    "ffn_up": "up_proj",
    "ffn_down": "down_proj",
}
# gemma2's names are shifted against HF's: ffn_norm is the pre-feed-forward
# norm, post_attention_norm HF's post_attention_layernorm
_GEMMA2_NAME_MAP = {
    **_NAME_MAP,
    "ffn_norm": "pre_feedforward_layernorm",
    "post_attention_norm": "post_attention_layernorm",
    "post_ffw_norm": "post_feedforward_layernorm",
}
# blk.N.<name>.bias of the attention projections -> their layer keys
_BIAS_MAP = {"attn_q": "q_bias", "attn_k": "k_bias", "attn_v": "v_bias",
             "attn_output": "o_bias"}
# layer keys held as f32 vectors
_F32_KEYS = ("input_layernorm", "post_attention_layernorm", "q_norm", "k_norm",
             "pre_feedforward_layernorm", "post_feedforward_layernorm")


def load_gguf_for_serving(gguf_path: Union[str, Path], dtype=torch.bfloat16,
                          device="cuda", dense: bool = False
                          ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """Build a serving model directly from a .gguf (one file or a shard set)
    of an architecture in ``GGUF_ARCHES``. K-quant tensors are unpacked
    bit-exactly to codes and scales and repacked on ``device`` in
    ``qmatmul.RUNTIME_FORMAT`` (``pack_runtime_auto``); other tensors load as
    dense arrays. phi3's fused ``attn_qkv`` / ``ffn_up`` are split by rows
    into q / k / v and gate / up (``fuse_layer_projections`` fuses them
    again for the kernel). Large tensors are prepared in row chunks on host threads
    (``convert.by_row_chunks``). Raises on
    tensor names it does not understand: a silently dropped tensor means
    silently wrong logits.

    dense=True dequantizes every tensor to a dense array instead: the params
    run through ``models.llama.forward`` (full-sequence logits), which is
    how ``ppl --gguf-path dense`` scores a GGUF."""
    dev = resolve_device(device)
    r = open_gguf(gguf_path)
    arch = r.get("general.architecture", "llama")
    cfg = _config_from_gguf(r, arch, dtype)
    n_head, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    permuted_qk = arch in PERMUTED_QK_ARCHES
    name_map = _GEMMA2_NAME_MAP if arch == "gemma2" else _NAME_MAP

    def rows(name: str, a: int, b: int) -> np.ndarray:
        """The raw bytes of rows [a, b) of a 2-D tensor."""
        info = r.tensors[name]
        per_row = info.nbytes // info.shape[0]
        return np.asarray(r.tensor_bytes(name))[a * per_row:b * per_row]

    def dense_tensor(name: str, inv, dt):
        info = r.tensors[name]
        if info.ggml_type == GGMLQuantizationType.BF16:  # raw bits: no f32 copy on the host
            w = np.asarray(r.tensor_bytes(name)).view(np.int16).reshape(info.shape)
            w = w[inv] if inv is not None else w.copy()
            return torch.from_numpy(w).view(torch.bfloat16).to(device=dev).to(dtype=dt)
        if len(info.shape) == 2:
            parts = convert.by_row_chunks(lambda a, b: ggml.dequantize(
                rows(name, a, b), info.ggml_type, (b - a, info.shape[1])), info.shape[0])
            w = parts[0] if len(parts) == 1 else np.concatenate(parts)
        else:
            w = r.tensor_float(name)
        if inv is not None:
            w = w[inv]
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=dev, dtype=dt)

    def load_weight(name: str, lo: int = 0, hi: Optional[int] = None):
        """The tensor ``name`` (rows [lo, hi) of it), packed or dense."""
        info = r.tensors[name]
        hi = info.shape[0] if hi is None else hi
        inv = None
        if permuted_qk and (".attn_q." in name or ".attn_k." in name):  # undo the rope permute
            heads = n_head if ".attn_q." in name else n_kv
            inv = np.argsort(convert.gqa_permute_rows(info.shape[0], heads))
        if dense or info.ggml_type not in K_QUANT_TYPES or info.shape[-1] % 256 != 0:
            w = dense_tensor(name, inv, dtype)
            return w if (lo, hi) == (0, info.shape[0]) else w[lo:hi].contiguous()

        def packed(a: int, b: int, where: torch.device):
            a, b = a + lo, b + lo
            q, ss, sc, sz, zq = convert.unpack_layer(rows(name, a, b), info.ggml_type,
                                                     (b - a, info.shape[1]))
            if inv is not None:
                q, ss, sc, sz, zq = q[inv], ss[inv], sc[inv], sz[inv], zq[inv]
            q = q.astype(np.int8 if KQUANT_SPECS[info.ggml_type].signed else np.uint8)
            return qmatmul.pack_runtime_auto(q, SuperGroupParams(ss, sz, sc, zq),
                                             info.ggml_type, device=where)

        # chunks of convert.CHUNK_ROWS rows packed on host threads and joined
        # along d_out (exact for v2 and v4; v1 and permuted q / k load whole)
        join = {"v2": qmatmul.fuse_rql_v2, "v4": qmv4.fuse_rql_v4}.get(qmatmul.RUNTIME_FORMAT)
        if inv is not None or join is None or hi - lo <= convert.CHUNK_ROWS:
            return packed(0, hi - lo, dev)
        host = torch.device("cpu")
        return _packed_to(join(convert.by_row_chunks(lambda a, b: packed(a, b, host),
                                                     hi - lo)), dev)

    def split_rows(name: str, keys, sizes):
        """A fused tensor's row blocks (phi3), each loaded as its own weight."""
        li = int(name.split(".")[1])
        if sum(sizes) != r.tensors[name].shape[0]:
            raise ValueError(f"{name}: {r.tensors[name].shape[0]} rows, the config gives "
                             f"{sum(sizes)}")
        lo = 0
        for key, n in zip(keys, sizes):
            layers[li][key] = load_weight(name, lo, lo + n)
            lo += n

    params: Dict[str, Any] = {}
    layers: List[Dict[str, Any]] = [dict() for _ in range(cfg.num_hidden_layers)]
    for name in r.tensor_order:
        if name == "token_embd.weight":
            params["embed_tokens"] = dense_tensor(name, None, dtype)  # gathered: keep dense
        elif name == "output.weight":
            head = load_weight(name)
            if isinstance(head, RuntimeQuantLinearV2):
                head = qmatmul.pad_dout_v2(head)  # logits are sliced back
            params["lm_head"] = head
        elif name == "output_norm.weight":
            params["norm"] = dense_tensor(name, None, torch.float32)
        elif name in ("rope_freqs.weight", "rope_factors_long.weight",
                      "rope_factors_short.weight"):
            continue  # folded into cfg.rope_scaling
        elif name.startswith("blk.") and name.endswith(".attn_qkv.weight"):
            hd = cfg.head_dim_
            split_rows(name, ("q_proj", "k_proj", "v_proj"),
                       (n_head * hd, n_kv * hd, n_kv * hd))
        elif (name.startswith("blk.") and name.endswith(".ffn_up.weight")
              and name.replace("ffn_up", "ffn_gate") not in r.tensors
              and r.tensors[name].shape[0] == 2 * cfg.intermediate_size):
            split_rows(name, ("gate_proj", "up_proj"), (cfg.intermediate_size,) * 2)
        elif name.startswith("blk.") and name.endswith(".weight") \
                and name.split(".")[2] in name_map:
            li, comp = int(name.split(".")[1]), name.split(".")[2]
            key = name_map[comp]
            layers[li][key] = (dense_tensor(name, None, torch.float32)
                               if key in _F32_KEYS else load_weight(name))
        elif name.startswith("blk.") and name.endswith(".bias") \
                and name.split(".")[2] in _BIAS_MAP:
            li, comp = int(name.split(".")[1]), name.split(".")[2]
            layers[li][_BIAS_MAP[comp]] = dense_tensor(name, None, torch.float32)
        else:
            raise NotImplementedError(
                f"GGUF tensor {name!r} has no mapping for arch {arch!r} in the "
                "port; refusing to drop it silently")
    params["layers"] = layers
    if "lm_head" not in params:
        cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    return params, cfg
