"""HF -> GGUF layer names in search config files.

Copy of ``gptq_gguf_tpu/mapper/config_converter.py``: turns the search's
output config (HF layer names) into the stitcher's (GGUF tensor names),
with the dense and MoE maps, MoE detection, and a value for each tensor the
input does not name (the block norms among them). Pure text.
"""

from __future__ import annotations

from typing import Dict

DENSE_MAPPING = {
    "mlp.down_proj": "ffn_down.weight",
    "mlp.gate_proj": "ffn_gate.weight",
    "mlp.up_proj": "ffn_up.weight",
    "self_attn.k_proj": "attn_k.weight",
    "self_attn.q_proj": "attn_q.weight",
    "self_attn.v_proj": "attn_v.weight",
    "self_attn.o_proj": "attn_output.weight",
}

MOE_MAPPING = {
    "self_attn.k_proj": "attn_k.weight",
    "self_attn.q_proj": "attn_q.weight",
    "self_attn.v_proj": "attn_v.weight",
    "self_attn.o_proj": "attn_output.weight",
    "mlp.experts.down_proj": "ffn_down_exps.weight",
    "mlp.experts.gate_proj": "ffn_gate_exps.weight",
    "mlp.experts.up_proj": "ffn_up_exps.weight",
    "mlp.gate": "ffn_gate_inp.weight",
    "self_attn.k_norm": "attn_k_norm.weight",
    "self_attn.q_norm": "attn_q_norm.weight",
    # MLA (deepseek2)
    "self_attn.q_a_proj": "attn_q_a.weight",
    "self_attn.q_b_proj": "attn_q_b.weight",
    "self_attn.kv_a_proj_with_mqa": "attn_kv_a_mqa.weight",
    "self_attn.kv_b_proj": "attn_kv_b.weight",
}

_MOE_INDICATORS = ("experts", "mlp.gate.", "router", "shared_expert")


def detect_moe(hf_config_text: str) -> bool:
    for line in hf_config_text.strip().split("\n"):
        low = line.strip().lower()
        if any(ind in low for ind in _MOE_INDICATORS):
            return True
    return False


def parse_config_text(text: str) -> Dict[str, str]:
    """`key: value` lines -> dict; value kept verbatim (incl. `bw (file)`)."""
    out = {}
    for line in text.strip().split("\n"):
        line = line.strip()
        if not line or line.startswith("#") or ":" not in line:
            continue
        key, value = line.split(":", 1)
        out[key.strip()] = value.strip()
    return out


def convert_hf_to_gguf_config(
    hf_config_text: str, missing_value: str = "32", is_moe: bool = False
) -> Dict[str, str]:
    hf = parse_config_text(hf_config_text)
    mapping = MOE_MAPPING if is_moe else DENSE_MAPPING
    gguf: Dict[str, str] = {}
    layers: Dict[int, Dict[str, str]] = {}

    for key, value in hf.items():
        if "model.layers." in key:
            parts = key.split(".")
            if len(parts) < 4:
                continue
            try:
                i = int(parts[2])
            except ValueError:
                continue
            component = ".".join(parts[3:])
            # strip trailing .weight so both naming flavors work
            if component.endswith(".weight"):
                component = component[: -len(".weight")]
            layers.setdefault(i, {})[component] = value

    for i in sorted(layers):
        base = f"blk.{i}"
        for hf_comp, gguf_comp in mapping.items():
            gguf[f"{base}.{gguf_comp}"] = layers[i].get(hf_comp, missing_value)
        gguf[f"{base}.attn_norm.weight"] = missing_value
        gguf[f"{base}.ffn_norm.weight"] = missing_value
        if is_moe:
            gguf.setdefault(f"{base}.attn_k_norm.weight", missing_value)
            gguf.setdefault(f"{base}.attn_q_norm.weight", missing_value)

    for key, value in hf.items():
        if "model.layers." in key:
            continue
        if "embed_tokens" in key:
            gguf["token_embd.weight"] = value
        elif "lm_head" in key:
            gguf["output.weight"] = value
        elif "model.norm" in key:
            gguf["output_norm.weight"] = value
        else:
            gguf[key] = value
    return gguf


def convert_file(
    in_path: str, out_path: str, missing_value: str = "32", is_moe=None
) -> Dict[str, str]:
    with open(in_path) as f:
        text = f.read()
    if is_moe is None:
        is_moe = detect_moe(text)
    cfg = convert_hf_to_gguf_config(text, missing_value, is_moe)
    with open(out_path, "w") as f:
        for key in sorted(cfg):
            f.write(f"{key}: {cfg[key]}\n")
    return cfg
