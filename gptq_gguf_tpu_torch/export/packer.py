"""Pack a quantized dense model (HF checkpoint + per-layer artifacts) into a GGUF.

Port of the llama / mistral / qwen2 / qwen3 / gemma / gemma2 / phi3 path of
``gptq_gguf_tpu/export/packer.py``: the same file, byte for byte, from the
same checkpoint and artifacts. It walks the checkpoint's safetensors files
(sorted by name, each file's tensors sorted by name) and, for each tensor,
either packs its GPTQ artifact into exact GGML K-quant blocks or writes the
float tensor in the ``default_float`` type (norms, biases and other 1-D
tensors stay f32). For llama and mistral the q / k rows go from HF's
rotate-half rope layout to GGML's interleaved one (codes and every per-row
scale of an artifact are permuted together); the other families keep HF's
row order, as llama.cpp reads them. gemma and gemma2 store their norms as
1 + w (llama.cpp's form) and gemma2's norm names are shifted against HF's
(``ffn_norm`` is the pre-feed-forward norm); phi3's fused ``attn_qkv`` /
``ffn_up`` are the row concatenations of the per-projection artifacts, and
its longrope factors are written as the ``rope_factors_long`` / ``_short``
tensors. Metadata: the architecture keys, then the tokenizer's (BPE
``tokenizer.json`` or SentencePiece ``tokenizer.model``), then any extra
keys, then ``general.file_type``.

Host code: numpy, no card. Other model types, multimodal wrappers and the
Unigram, WordPiece and RWKV vocabularies raise ``NotImplementedError``
naming what is missing.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..formats import convert, ggml, safetensors
from ..formats.ggml import FILE_TYPE_IDS, GGMLQuantizationType
from ..formats.gguf import GGUFWriter
from ..models.loader import SUPPORTED_MODEL_TYPES
from ..quant import artifacts

def hf_to_gguf_name(name: str) -> Optional[str]:
    """The GGUF tensor name of an HF tensor name, or None (not packed)."""
    fixed = {
        "model.embed_tokens.weight": "token_embd.weight",
        "model.norm.weight": "output_norm.weight",
        "lm_head.weight": "output.weight",
    }
    if name in fixed:
        return fixed[name]
    if not name.startswith("model.layers."):
        return None
    parts = name.split(".")
    m = {
        "input_layernorm.weight": "attn_norm.weight",
        "post_attention_layernorm.weight": "ffn_norm.weight",
        "self_attn.q_proj.weight": "attn_q.weight",
        "self_attn.k_proj.weight": "attn_k.weight",
        "self_attn.v_proj.weight": "attn_v.weight",
        "self_attn.o_proj.weight": "attn_output.weight",
        "self_attn.q_proj.bias": "attn_q.bias",
        "self_attn.k_proj.bias": "attn_k.bias",
        "self_attn.v_proj.bias": "attn_v.bias",
        "self_attn.o_proj.bias": "attn_output.bias",
        "self_attn.q_norm.weight": "attn_q_norm.weight",
        "self_attn.k_norm.weight": "attn_k_norm.weight",
        "post_feedforward_layernorm.weight": "post_ffw_norm.weight",
        "mlp.gate_proj.bias": "ffn_gate.bias",
        "mlp.up_proj.bias": "ffn_up.bias",
        "mlp.down_proj.bias": "ffn_down.bias",
        "mlp.gate_proj.weight": "ffn_gate.weight",
        "mlp.up_proj.weight": "ffn_up.weight",
        "mlp.down_proj.weight": "ffn_down.weight",
    }
    rest = ".".join(parts[3:])
    return f"blk.{parts[2]}.{m[rest]}" if rest in m else None


class LlamaArch:
    """llama.cpp's conversion rules for a llama checkpoint: its metadata keys
    and the rope permutation of the q / k rows."""

    gguf_arch = "llama"
    permute_qk = True

    def __init__(self, hf_config: Dict[str, Any]):
        self.hf = hf_config

    def metadata(self) -> Dict[str, Any]:
        c = self.hf
        a = self.gguf_arch
        hidden = c["hidden_size"]
        n_head = c["num_attention_heads"]
        md = {
            "general.architecture": a,
            "general.name": c.get("_name_or_path", "model"),
            "general.quantization_version": 2,
            f"{a}.context_length": c.get("max_position_embeddings", 4096),
            f"{a}.embedding_length": hidden,
            f"{a}.block_count": c["num_hidden_layers"],
            f"{a}.feed_forward_length": c.get("intermediate_size") or 4 * hidden,
            f"{a}.attention.head_count": n_head,
            f"{a}.attention.head_count_kv": c.get("num_key_value_heads", n_head),
            f"{a}.attention.layer_norm_rms_epsilon": float(c.get("rms_norm_eps", 1e-5)),
            f"{a}.rope.freq_base": float(c.get("rope_theta", 10000.0)),
            f"{a}.rope.dimension_count": c.get("head_dim") or hidden // n_head,
            f"{a}.vocab_size": c["vocab_size"],
        }
        rs = dict(c.get("rope_scaling") or {})
        rt = rs.get("rope_type", rs.get("type"))
        if rt == "linear":
            md[f"{a}.rope.scaling.type"] = "linear"
            md[f"{a}.rope.scaling.factor"] = float(rs["factor"])
        elif rt == "yarn":
            md[f"{a}.rope.scaling.type"] = "yarn"
            md[f"{a}.rope.scaling.factor"] = float(rs["factor"])
            md[f"{a}.rope.scaling.original_context_length"] = int(
                rs.get("original_max_position_embeddings", 4096))
        elif rt == "llama3":
            # llama.cpp reads these keys and applies the correction through
            # the rope_freqs.weight tensor that pack_model writes
            md[f"{a}.rope.scaling.type"] = "linear"
            md[f"{a}.rope.scaling.factor"] = float(rs.get("factor", 8.0))
            md[f"{a}.rope.scaling.original_context_length"] = int(
                rs.get("original_max_position_embeddings", 8192))
        return md

    def row_permutation(self, hf_name: str, n_rows: int) -> Optional[np.ndarray]:
        if not self.permute_qk:
            return None
        n_head = self.hf["num_attention_heads"]
        if ".self_attn.q_proj." in hf_name:
            return convert.gqa_permute_rows(n_rows, n_head)
        if ".self_attn.k_proj." in hf_name:
            return convert.gqa_permute_rows(n_rows, self.hf.get("num_key_value_heads", n_head))
        return None

    def tensor_name(self, hf_name: str) -> Optional[str]:
        return hf_to_gguf_name(hf_name)

    def transform_float(self, gguf_name: str, arr: np.ndarray) -> np.ndarray:
        """A float tensor's stored value (gemma folds its norms' + 1)."""
        return arr

    def extra_tensors(self) -> List[Tuple[str, np.ndarray]]:
        """Tensors made from the config alone (phi3's rope factors)."""
        return []

    def _head_dim_metadata(self, md: Dict[str, Any]) -> Dict[str, Any]:
        """The explicit key / value widths (head_dim need not be hidden / heads)."""
        c = self.hf
        head_dim = c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]
        md[f"{self.gguf_arch}.attention.key_length"] = head_dim
        md[f"{self.gguf_arch}.attention.value_length"] = head_dim
        return md


class MistralArch(LlamaArch):
    """mistral: llama's keys and permutation under the llama arch tag, as
    the JAX package writes it."""


class Qwen2Arch(LlamaArch):
    """qwen2: its own arch tag, q / k rows in HF's order."""

    gguf_arch = "qwen2"
    permute_qk = False


class Qwen3Arch(Qwen2Arch):
    """qwen3: qwen2's rules plus the explicit head width (its head_dim is
    not hidden / heads)."""

    gguf_arch = "qwen3"

    def metadata(self) -> Dict[str, Any]:
        return self._head_dim_metadata(super().metadata())


class GemmaArch(Qwen2Arch):
    """gemma: q / k rows in HF's order, the explicit head width, and the
    (1 + w) of its RMSNorm folded into every stored norm weight."""

    gguf_arch = "gemma"

    def metadata(self) -> Dict[str, Any]:
        return self._head_dim_metadata(super().metadata())

    def transform_float(self, gguf_name: str, arr: np.ndarray) -> np.ndarray:
        return arr + 1.0 if gguf_name.endswith("norm.weight") else arr


class Gemma2Arch(GemmaArch):
    """gemma2: gemma's rules, the softcaps, the sliding window and
    ``query_pre_attn_scalar``; its GGUF norm names are shifted against HF's:
    ``post_attention_norm`` holds HF's post_attention_layernorm and
    ``ffn_norm`` the pre-feed-forward norm."""

    gguf_arch = "gemma2"

    def tensor_name(self, hf_name: str) -> Optional[str]:
        if hf_name.startswith("model.layers."):
            parts = hf_name.split(".")
            rest = ".".join(parts[3:])
            if rest == "post_attention_layernorm.weight":
                return f"blk.{parts[2]}.post_attention_norm.weight"
            if rest == "pre_feedforward_layernorm.weight":
                return f"blk.{parts[2]}.ffn_norm.weight"
        return hf_to_gguf_name(hf_name)

    def metadata(self) -> Dict[str, Any]:
        md = LlamaArch.metadata(self)
        c, a = self.hf, self.gguf_arch
        md[f"{a}.attn_logit_softcapping"] = float(c.get("attn_logit_softcapping", 50.0))
        md[f"{a}.final_logit_softcapping"] = float(c.get("final_logit_softcapping", 30.0))
        md[f"{a}.attention.sliding_window"] = int(c.get("sliding_window", 4096))
        self._head_dim_metadata(md)
        if c.get("query_pre_attn_scalar") is not None:
            md[f"{a}.attention.query_pre_attn_scalar"] = float(c["query_pre_attn_scalar"])
        return md


class Phi3Arch(Qwen2Arch):
    """phi3: q / k rows in HF's order; the longrope keys and factor tensors
    (``rope.scaling.original_context_length``, ``attention.sliding_window``,
    0 when absent, ``rope.scaling.attn_factor``); llama.cpp's fused
    ``attn_qkv`` (q, k, v) and ``ffn_up`` (gate, up), made by row
    concatenation of the per-projection artifacts (exact: K-quant rows are
    independent)."""

    gguf_arch = "phi3"
    fused = {"self_attn.qkv_proj.weight": ("attn_qkv.weight",
                                           ("self_attn.q_proj", "self_attn.k_proj",
                                            "self_attn.v_proj")),
             "mlp.gate_up_proj.weight": ("ffn_up.weight", ("mlp.gate_proj", "mlp.up_proj"))}

    def metadata(self) -> Dict[str, Any]:
        md = super().metadata()
        c, a = self.hf, self.gguf_arch
        orig = int(c.get("original_max_position_embeddings",
                         c.get("max_position_embeddings", 4096)))
        md[f"{a}.rope.scaling.original_context_length"] = orig
        md[f"{a}.attention.sliding_window"] = int(c.get("sliding_window") or 0)
        rs = dict(c.get("rope_scaling") or {})
        rt = (rs.get("rope_type", rs.get("type")) or "").lower()
        if rt in ("su", "longrope", "yarn"):
            scale = c["max_position_embeddings"] / orig
            if rt == "yarn":
                attn = 0.1 * math.log(scale) + 1.0 if scale > 1.0 else 1.0
            else:
                attn = math.sqrt(1 + math.log(scale) / math.log(orig)) if scale > 1.0 else 1.0
            md[f"{a}.rope.scaling.attn_factor"] = float(attn)
        return md

    def extra_tensors(self) -> List[Tuple[str, np.ndarray]]:
        rs = dict(self.hf.get("rope_scaling") or {})
        long_f, short_f = rs.get("long_factor"), rs.get("short_factor")
        if long_f is None or short_f is None:
            return []
        return [("rope_factors_long.weight", np.asarray(long_f, dtype=np.float32)),
                ("rope_factors_short.weight", np.asarray(short_f, dtype=np.float32))]


# the conversion rules of each HF model type the port packs
ARCH_BY_MODEL_TYPE = {"llama": LlamaArch, "mistral": MistralArch, "qwen2": Qwen2Arch,
                      "qwen3": Qwen3Arch, "gemma": GemmaArch, "gemma2": Gemma2Arch,
                      "phi3": Phi3Arch}


# ---------------------------------------------------------------------------
# Tokenizer metadata
# ---------------------------------------------------------------------------

# llama.cpp picks its pretokenizer regex from tokenizer.ggml.pre
PRE_TOKENIZER_BY_MODEL_TYPE = {"llama": "llama-bpe", "mistral": "llama-bpe",
                               "qwen2": "qwen2", "qwen3": "qwen2", "phi3": "llama-bpe"}

_NORMAL, _CONTROL, _USER_DEFINED, _UNUSED = 1, 3, 4, 5  # GGUF token types


def _chat_template_metadata(model_dir: Path) -> Dict[str, Any]:
    """tokenizer.chat_template keys from tokenizer_config.json: a plain
    string, or a named list that becomes tokenizer.chat_templates plus a key
    per name, "default" promoted to tokenizer.chat_template."""
    p = model_dir / "tokenizer_config.json"
    if not p.exists():
        return {}
    with open(p) as f:
        tmpl = json.load(f).get("chat_template")
    if tmpl is None:
        return {}
    if isinstance(tmpl, str):
        return {"tokenizer.chat_template": tmpl}
    md: Dict[str, Any] = {}
    names = []
    for entry in tmpl:
        name, text = entry.get("name"), entry.get("template")
        if not name or not isinstance(text, str):
            continue
        if name == "default":
            md["tokenizer.chat_template"] = text
        else:
            names.append(name)
            md[f"tokenizer.chat_template.{name}"] = text
    if names:
        md["tokenizer.chat_templates"] = names
    return md


def _special_token_ids(model_dir: Path) -> Dict[str, Any]:
    """bos / eos / pad ids and the add_bos / add_eos flags, the first found
    in generation_config.json, config.json, tokenizer_config.json."""
    md: Dict[str, Any] = {}
    ids: Dict[str, int] = {}
    for p in (model_dir / "generation_config.json", model_dir / "config.json",
              model_dir / "tokenizer_config.json"):
        if p.exists():
            with open(p) as f:
                d = json.load(f)
            for key in ("bos_token_id", "eos_token_id", "pad_token_id"):
                v = d.get(key)
                if isinstance(v, list):
                    v = v[0]
                if isinstance(v, int) and key not in ids:
                    ids[key] = v
            for key in ("add_bos_token", "add_eos_token"):
                flag = d.get(key)
                gk = f"tokenizer.ggml.{key}"
                if isinstance(flag, bool) and gk not in md:
                    md[gk] = flag
    for key, gk in (("bos_token_id", "tokenizer.ggml.bos_token_id"),
                    ("eos_token_id", "tokenizer.ggml.eos_token_id"),
                    ("pad_token_id", "tokenizer.ggml.padding_token_id")):
        if key in ids:
            md[gk] = ids[key]
    return md


def _bpe_tokenizer_metadata(tok: Dict[str, Any], model_type: str) -> Dict[str, Any]:
    model = tok["model"]
    vocab: Dict[str, int] = model["vocab"]
    merges = [" ".join(m) if isinstance(m, (list, tuple)) else m for m in model.get("merges", [])]
    size = max(vocab.values()) + 1
    tokens = [""] * size
    for t, i in vocab.items():
        tokens[i] = t
    toktypes = [_NORMAL] * size
    for i, t in {t["id"]: t for t in tok.get("added_tokens", [])}.items():
        if i >= size:
            tokens.extend([""] * (i + 1 - size))
            toktypes.extend([_NORMAL] * (i + 1 - size))
            size = i + 1
        tokens[i] = t["content"]
        toktypes[i] = _CONTROL if t.get("special") else _USER_DEFINED
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.pre": PRE_TOKENIZER_BY_MODEL_TYPE.get(model_type, "llama-bpe"),
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": toktypes,
        "tokenizer.ggml.merges": merges,
    }


def _spm_tokenizer_metadata(model_dir: Path) -> Dict[str, Any]:
    """A SentencePiece tokenizer.model (plus added_tokens.json and
    tokenizer_config.json's added_tokens_decoder) as GGUF llama-vocab keys."""
    from . import spm

    model = spm.parse_model((model_dir / "tokenizer.model").read_bytes())
    tokens = [p.piece for p in model.pieces]
    scores = [p.score for p in model.pieces]
    toktypes = [p.type for p in model.pieces]
    added: Dict[int, Tuple[str, bool]] = {}
    at_path = model_dir / "added_tokens.json"
    if at_path.exists():
        with open(at_path) as f:
            for content, i in json.load(f).items():
                added[int(i)] = (content, True)
    cfg_path = model_dir / "tokenizer_config.json"
    if cfg_path.exists():
        with open(cfg_path) as f:
            dec = json.load(f).get("added_tokens_decoder", {})
        for i, t in dec.items():
            added.setdefault(int(i), (t["content"], bool(t.get("special", True))))
    for i, (content, special) in sorted(added.items()):
        if i >= len(tokens):
            tokens.extend([f"[PAD{j}]" for j in range(len(tokens), i + 1)])
            scores.extend([-1000.0] * (i + 1 - len(scores)))
            toktypes.extend([_UNUSED] * (i + 1 - len(toktypes)))
        if tokens[i] != content:
            tokens[i] = content
            scores[i] = -1000.0
            toktypes[i] = _CONTROL if special else _USER_DEFINED
    md: Dict[str, Any] = {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.pre": "default",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.token_type": toktypes,
    }
    for attr, key in (("unk_id", "tokenizer.ggml.unknown_token_id"),
                      ("bos_id", "tokenizer.ggml.bos_token_id"),
                      ("eos_id", "tokenizer.ggml.eos_token_id"),
                      ("pad_id", "tokenizer.ggml.padding_token_id")):
        v = getattr(model, attr)
        if v is not None and v >= 0:
            md[key] = v
    return md


def tokenizer_metadata(model_dir: Path, model_type: str = "llama") -> Dict[str, Any]:
    """GGUF tokenizer keys of an HF checkpoint: a SentencePiece
    ``tokenizer.model`` or a BPE ``tokenizer.json``; none for a checkpoint
    without a tokenizer. Raises for a vocabulary the port cannot write (a
    GGUF without its vocab does not load in llama.cpp)."""
    model_dir = Path(model_dir)
    if (model_dir / "rwkv_vocab_v20230424.txt").exists():
        raise NotImplementedError("the RWKV world vocabulary is not ported yet")
    if (model_dir / "tokenizer.model").exists():
        md = _spm_tokenizer_metadata(model_dir)
    elif (model_dir / "tokenizer.json").exists():
        with open(model_dir / "tokenizer.json") as f:
            tok = json.load(f)
        mtype = tok.get("model", {}).get("type")
        if mtype in ("Unigram", "WordPiece"):
            raise NotImplementedError(f"the {mtype} tokenizer.json is not ported yet")
        if mtype != "BPE":
            raise NotImplementedError(
                f"tokenizer.json model type {mtype!r} cannot be packed into GGUF")
        md = _bpe_tokenizer_metadata(tok, model_type)
    else:
        return {}  # no tokenizer shipped (synthetic checkpoints)
    md.update(_special_token_ids(model_dir))
    md.update(_chat_template_metadata(model_dir))
    return md


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def _permute_artifact(art: artifacts.LayerArtifact, perm: np.ndarray) -> artifacts.LayerArtifact:
    return artifacts.LayerArtifact(
        q_type=art.q_type,
        qweight=art.qweight[perm],
        super_group_scale=art.super_group_scale[perm],
        super_group_zero=art.super_group_zero[perm],
        group_scale_quant=art.group_scale_quant[perm],
        group_zero_quant=art.group_zero_quant[perm],
    )


def _concat_artifacts(arts) -> artifacts.LayerArtifact:
    """The row concatenation of per-projection artifacts (phi3's attn_qkv /
    ffn_up); the parts must share a quant type."""
    if len({a.q_type for a in arts}) != 1:
        raise ValueError("the fused parts must share a quant type")
    return artifacts.LayerArtifact(q_type=arts[0].q_type, **{
        f: np.concatenate([getattr(a, f) for a in arts], axis=0)
        for f in ("qweight", "super_group_scale", "super_group_zero", "group_scale_quant",
                  "group_zero_quant")})


def _to_f32(t: torch.Tensor) -> np.ndarray:
    """A checkpoint tensor as f32 numpy (bf16 and f16 widen exactly)."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy().astype(np.float32)


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint16), rounding to nearest even; a NaN becomes
    the quiet NaN of its sign (ml_dtypes' conversion)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    bits = a.view(np.uint32)
    r = bits >> 16  # in place from here: one uint32 temporary for a 2-D weight
    r &= 1
    r += 0x7FFF
    r += bits
    r >>= 16
    out = r.astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out[nan] = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0)
    return out


def pack_model(model_dir: Union[str, Path], quant_dir: Optional[Union[str, Path]],
               out_path: Union[str, Path], *,
               default_float: GGMLQuantizationType = GGMLQuantizationType.F16,
               extra_metadata: Optional[Dict[str, Any]] = None,
               vocab_only: bool = False) -> Path:
    """Write a llama.cpp-loadable GGUF of an HF checkpoint of a family the
    port packs (``ARCH_BY_MODEL_TYPE``) and its artifacts.

    model_dir: config.json + *.safetensors (+ tokenizer files). quant_dir:
    the ``<hf_module_name>/data.npz`` artifacts tree of ``quantize`` (None:
    none). default_float: F32 / F16 / BF16 / Q8_0, the type of every tensor
    without an artifact (norms and 1-D tensors stay F32; Q8_0 needs rows of
    a multiple of 32, else F16). vocab_only: metadata and vocabulary only.
    """
    model_dir = Path(model_dir)
    with open(model_dir / "config.json") as f:
        hf_cfg = json.load(f)
    model_type = hf_cfg.get("model_type", "llama")
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet; supported: {SUPPORTED_MODEL_TYPES}")
    if "text_config" in hf_cfg:
        raise NotImplementedError("multimodal checkpoints (text_config) are not ported yet")
    spec = ARCH_BY_MODEL_TYPE[model_type](hf_cfg)
    quant_layers = artifacts.list_layers(quant_dir) if quant_dir is not None else {}

    writer = GGUFWriter(out_path)
    for k, v in spec.metadata().items():
        writer.add_kv(k, v)
    for k, v in tokenizer_metadata(model_dir, model_type).items():
        writer.add_kv(k, v)
    for k, v in (extra_metadata or {}).items():
        writer.add_kv(k, v)
    if vocab_only:
        writer.add_kv("general.file_type", FILE_TYPE_IDS.get(default_float, 1))
        writer.write()
        return Path(out_path)

    spec_extras = spec.extra_tensors()
    rs = dict(hf_cfg.get("rope_scaling") or {})
    if rs.get("rope_type", rs.get("type")) == "llama3":
        # llama.cpp's per-dimension frequency divisors (rope_freqs.weight)
        from ..models import llama

        cfg = llama.LlamaConfig.from_hf_dict(hf_cfg)
        hd = cfg.head_dim_
        base_inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
        corrected, _ = llama._rope_params(cfg)
        writer.add_tensor("rope_freqs.weight", (base_inv / corrected).astype(np.float32))
    for ename, earr in spec_extras:
        writer.add_tensor(ename, earr)

    type_counts: Dict[GGMLQuantizationType, int] = {}

    def add_quantized(gguf_name: str, hf_name: str, art: artifacts.LayerArtifact):
        perm = spec.row_permutation(hf_name, art.qweight.shape[0])
        if perm is not None:
            art = _permute_artifact(art, perm)
        blocks = convert.pack_layer(art.qweight, art.super_group_scale, art.group_scale_quant,
                                    art.super_group_zero, art.group_zero_quant, art.q_type)
        writer.add_tensor(gguf_name, blocks, raw_dtype=art.q_type, raw_shape=art.qweight.shape)
        type_counts[art.q_type] = type_counts.get(art.q_type, 0) + 1

    def add_float(gguf_name: str, hf_name: str, t: torch.Tensor):
        arr = spec.transform_float(gguf_name, _to_f32(t))
        perm = spec.row_permutation(hf_name, arr.shape[0])
        if perm is not None:
            arr = arr[perm]
        if (gguf_name.endswith("_norm.weight") or arr.ndim == 1
                or default_float == GGMLQuantizationType.F32):
            writer.add_tensor(gguf_name, arr)
        elif default_float == GGMLQuantizationType.BF16:
            writer.add_tensor(gguf_name, _bf16_bits(arr), raw_dtype=GGMLQuantizationType.BF16)
        elif (default_float == GGMLQuantizationType.Q8_0
              and arr.ndim == 2 and arr.shape[-1] % 32 == 0):
            writer.add_tensor(gguf_name, ggml.quantize_q8_0(arr.reshape(-1, 32)),
                              raw_dtype=GGMLQuantizationType.Q8_0, raw_shape=arr.shape)
        else:
            writer.add_tensor(gguf_name, arr.astype(np.float16))

    seen_embed: Optional[torch.Tensor] = None
    has_lm_head = False
    fused = getattr(spec, "fused", {})
    for name, t in safetensors.iter_dir(model_dir):
        gguf_name = spec.tensor_name(name)
        if gguf_name is None and name.startswith("model.layers."):
            parts = name.split(".")
            rest = ".".join(parts[3:])
            if rest in fused:  # phi3: the split projections' artifacts, re-fused
                gname, subs = fused[rest]
                gname = f"blk.{parts[2]}.{gname}"
                sub_names = [f"model.layers.{parts[2]}.{sub}" for sub in subs]
                if all(sub in quant_layers for sub in sub_names):
                    add_quantized(gname, name, _concat_artifacts(
                        [artifacts.load_layer(quant_dir, sub) for sub in sub_names]))
                else:
                    add_float(gname, name, t)
                continue
        if gguf_name is None:
            continue
        base = name[: -len(".weight")] if name.endswith(".weight") else name
        if name == "model.embed_tokens.weight":
            seen_embed = t
        if name == "lm_head.weight":
            has_lm_head = True
        if name.endswith(".weight") and base in quant_layers:
            add_quantized(gguf_name, name, artifacts.load_layer(quant_dir, base))
        else:
            add_float(gguf_name, name, t)

    # tied embeddings: llama.cpp needs output.weight; reuse token_embd
    if not has_lm_head and hf_cfg.get("tie_word_embeddings") and seen_embed is not None:
        if "lm_head" in quant_layers:
            add_quantized("output.weight", "lm_head.weight",
                          artifacts.load_layer(quant_dir, "lm_head"))
        else:
            add_float("output.weight", "lm_head.weight", seen_embed)

    dominant = max(type_counts, key=type_counts.get) if type_counts else default_float
    writer.add_kv("general.file_type", FILE_TYPE_IDS.get(dominant, 1))
    writer.write()
    return Path(out_path)
