"""Quantized serving model: KV-cached dense Llama over runtime-packed weights.

Port of the dense-Llama path of ``gptq_gguf_tpu/serving/model.py``. Every
projection and the lm_head go through ``ops.qmatmul.dequant_matmul``, which
routes each packed weight to its format's CUDA kernel on the card (v1, v2g
or v4). The KV cache is a preallocated per-layer (B, n_kv, max_len + 1, hd)
buffer updated in place: row ``max_len`` is a drop row that absorbs writes
past the end of the cache (the JAX package drops them with
``.at[...].set(mode="drop")``), so retired slots can keep decoding inside a
block without a bounds check on the host.

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
from ..formats import convert
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


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               kv_dtype: Optional[str] = None, device="cuda") -> KVCache:
    """Zeroed contiguous cache. kv_dtype None / "bf16" uses ``dtype``; the
    int8 and int4 caches are not ported yet."""
    if kv_dtype not in (None, "bf16"):
        raise NotImplementedError(f"kv_dtype {kv_dtype!r} is not ported yet")
    dev = resolve_device(device)
    shape = (batch, cfg.num_key_value_heads, max_len + 1, cfg.head_dim_)
    n = cfg.num_hidden_layers
    return KVCache(
        [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)],
        [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)],
        torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


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


def _cached_attention(q, k_cache, v_cache, lengths, scale=None,
                      n_live: Optional[int] = None):
    """q: (B, nH, S, hd); caches (B, nKV, L, hd); slot b's queries sit at
    positions lengths[b] + [0, S). Long caches stream through the
    online-softmax path; decode reads only the ``n_live`` live chunks."""
    B, nH, S, hd = q.shape
    nKV = k_cache.shape[1]
    L = k_cache.shape[2]
    ar = torch.arange(S, device=q.device)
    if L >= 2 * llama.FLASH_CHUNK:
        qpos = lengths[:, None] + ar[None, :]
        return llama.flash_attention(
            q, k_cache, v_cache, qpos, scale, dynamic_length=(S == 1),
            n_live=n_live).to(q.dtype)
    groups = nH // nKV
    qg = q.reshape(B, nKV, groups, S, hd)
    scale = scale if scale is not None else 1.0 / float(np.sqrt(hd))
    scores = torch.einsum("bkgsh,bkth->bkgst", qg.float(), k_cache.float()) * scale
    pos = torch.arange(L, device=q.device)[None, None, :]
    qpos = lengths[:, None, None] + ar[None, :, None]
    mask = pos <= qpos  # (B, S, L) causal per slot
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
    """
    if all_logits and n_valid is not None:
        raise ValueError("all_logits scores every position; n_valid does not apply")
    B, S = input_ids.shape
    hd = cfg.head_dim_
    lengths = cache.lengths
    L = cache.max_len
    dev = input_ids.device

    positions = lengths[:, None] + torch.arange(S, device=dev)[None, :]
    cos, sin = llama.rope_cos_sin_all(cfg, positions)
    write_pos = torch.where(positions < L, positions, L)  # L = drop row
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    n_live = None
    if L >= 2 * llama.FLASH_CHUNK and S == 1:
        top = int(lengths.max()) if fill_max is None else int(fill_max)
        n_live = top // llama.FLASH_CHUNK + 1

    x = params["embed_tokens"][input_ids].to(cfg.dtype)
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
        nH = q.shape[-1] // hd
        nKV = k.shape[-1] // hd
        q = q.reshape(B, S, nH, hd).transpose(1, 2)
        k = k.reshape(B, S, nKV, hd).transpose(1, 2)
        v = v.reshape(B, S, nKV, hd).transpose(1, 2)
        cos_l, sin_l = llama.select_rope(cos, sin, cfg, li)
        q, k = llama.apply_rope(q, k, cos_l, sin_l)

        k_buf, v_buf = cache.k[li], cache.v[li]
        k_buf[bidx, :, write_pos] = k.transpose(1, 2).to(k_buf.dtype)
        v_buf[bidx, :, write_pos] = v.transpose(1, 2).to(v_buf.dtype)
        attn = _cached_attention(q, k_buf[:, :, :L], v_buf[:, :, :L], lengths,
                                 n_live=n_live)
        attn = attn.transpose(1, 2).reshape(B, S, nH * hd)
        x = x + _q_linear(attn, layer["o_proj"])

        h = llama.apply_norm(x, cfg, layer["post_attention_layernorm"])
        if "gateup_proj" in layer:
            gate, up = torch.chunk(_q_linear(h, layer["gateup_proj"]), 2, dim=-1)
        else:
            gate = _q_linear(h, layer["gate_proj"])
            up = _q_linear(h, layer["up_proj"])
        x = x + _q_linear(llama._mlp_act(gate, up, cfg), layer["down_proj"])

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
    return logits, KVCache(cache.k, cache.v, (lengths + advance).to(torch.int32))


def _head_logits(params: Dict[str, Any], cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """(..., vocab) f32 logits of the normed final hidden states (..., H);
    a packed head runs once over all leading positions."""
    head = params.get("lm_head", params["embed_tokens"])
    if isinstance(head, _QUANT_TYPES):
        logits = qmatmul.dequant_matmul(h.reshape(-1, h.shape[-1]), head)
        logits = logits.reshape(*h.shape[:-1], head.d_out)
        if logits.shape[-1] > cfg.vocab_size:
            logits = logits[..., :cfg.vocab_size]  # drop pad_dout_v2 rows
        return logits
    return h.float() @ head.float().T  # dense (or tied) head


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
    not share a fusable format and layout."""
    out = dict(layer)
    if "q_proj" in out and "qkv_proj" not in out:
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


# llama.* metadata keys that change the model beyond the dense Llama path
_UNPORTED_KEYS = ("expert_count", "embedding_scale", "residual_scale",
                  "attention.scale", "logit_scale")


def _config_from_gguf(r, arch: str, dtype) -> LlamaConfig:
    """LlamaConfig from a llama-arch GGUF's metadata."""
    if arch != "llama":
        raise NotImplementedError(
            f"GGUF architecture {arch!r} is not supported by the serving "
            "loader of the port (supported: llama)")
    for key in _UNPORTED_KEYS:
        if r.get(f"{arch}.{key}") is not None:
            raise NotImplementedError(f"GGUF key {arch}.{key} is not ported yet")
    n_head = r.get(f"{arch}.attention.head_count")
    hidden = r.get(f"{arch}.embedding_length")
    head_dim = r.get(f"{arch}.attention.key_length",
                     r.get(f"{arch}.rope.dimension_count", hidden // n_head))
    if r.get(f"{arch}.rope.dimension_count", head_dim) != head_dim:
        raise NotImplementedError("partial rotary embeddings are not ported yet")
    rope_scaling = None
    if "rope_freqs.weight" in r.tensors:
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
    return LlamaConfig(
        vocab_size=r.get(f"{arch}.vocab_size") or len(r.get("tokenizer.ggml.tokens", [])),
        hidden_size=hidden,
        intermediate_size=r.get(f"{arch}.feed_forward_length"),
        num_hidden_layers=r.get(f"{arch}.block_count"),
        num_attention_heads=n_head,
        num_key_value_heads=r.get(f"{arch}.attention.head_count_kv", n_head),
        head_dim=head_dim,
        rms_norm_eps=r.get(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5),
        rope_theta=r.get(f"{arch}.rope.freq_base", 10000.0),
        max_position_embeddings=r.get(f"{arch}.context_length", 4096),
        rope_scaling=rope_scaling,
        dtype=dtype,
    )


_NAME_MAP = {
    "attn_norm": "input_layernorm",
    "ffn_norm": "post_attention_layernorm",
    "attn_q": "q_proj",
    "attn_k": "k_proj",
    "attn_v": "v_proj",
    "attn_output": "o_proj",
    "ffn_gate": "gate_proj",
    "ffn_up": "up_proj",
    "ffn_down": "down_proj",
}


def load_gguf_for_serving(gguf_path: Union[str, Path], dtype=torch.bfloat16,
                          device="cuda", dense: bool = False
                          ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """Build a serving model directly from a llama-arch .gguf (one file or a
    shard set). K-quant tensors are unpacked bit-exactly to codes and
    scales and repacked on ``device`` in ``qmatmul.RUNTIME_FORMAT``
    (``pack_runtime_auto``); other tensors load as dense arrays. Raises on
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

    def dense_tensor(name: str, inv, dt):
        info = r.tensors[name]
        if info.ggml_type == GGMLQuantizationType.BF16:  # raw bits: no f32 copy on the host
            w = np.asarray(r.tensor_bytes(name)).view(np.int16).reshape(info.shape)
            w = w[inv] if inv is not None else w.copy()
            return torch.from_numpy(w).view(torch.bfloat16).to(device=dev).to(dtype=dt)
        w = r.tensor_float(name)
        if inv is not None:
            w = w[inv]
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=dev, dtype=dt)

    def load_weight(name: str):
        info = r.tensors[name]
        inv = None
        if ".attn_q." in name or ".attn_k." in name:  # undo llama.cpp's rope permute
            heads = n_head if ".attn_q." in name else n_kv
            inv = np.argsort(convert.gqa_permute_rows(info.shape[0], heads))
        if dense or info.ggml_type not in K_QUANT_TYPES or info.shape[-1] % 256 != 0:
            return dense_tensor(name, inv, dtype)
        q, ss, sc, sz, zq = convert.unpack_layer(
            np.asarray(r.tensor_bytes(name)), info.ggml_type, info.shape)
        if inv is not None:
            q, ss, sc, sz, zq = q[inv], ss[inv], sc[inv], sz[inv], zq[inv]
        q = q.astype(np.int8 if KQUANT_SPECS[info.ggml_type].signed else np.uint8)
        return qmatmul.pack_runtime_auto(q, SuperGroupParams(ss, sz, sc, zq),
                                         info.ggml_type, device=dev)

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
        elif name == "rope_freqs.weight":
            continue  # folded into cfg.rope_scaling
        elif name.startswith("blk.") and name.endswith(".weight") \
                and name.split(".")[2] in _NAME_MAP:
            li, comp = int(name.split(".")[1]), name.split(".")[2]
            key = _NAME_MAP[comp]
            layers[li][key] = (dense_tensor(name, None, torch.float32)
                               if key.endswith("layernorm")
                               else load_weight(name))
        else:
            raise NotImplementedError(
                f"GGUF tensor {name!r} has no mapping for arch {arch!r} in the "
                "port; refusing to drop it silently")
    params["layers"] = layers
    if "lm_head" not in params:
        cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    return params, cfg
