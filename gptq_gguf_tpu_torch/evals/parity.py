"""Real-model parity harness: quantize -> pack -> perplexity against the
reference's tables.

Port of ``gptq_gguf_tpu/evals/parity.py``. The acceptance bar is a
WikiText2 perplexity within 0.05 of the reference's published GPTQ numbers
at the same bit width:

    python -m gptq_gguf_tpu_torch parity --model_name_or_path /models/Llama-3.2-1B \\
        --bit_widths Q4_K Q5_K

runs, per bit width, the GPTQ calibration walk on the card, the perplexity
of the dequantized model and ``pack`` into a GGUF, compares with the table
and writes ``parity_report.json``. Without weights, ``--synthetic-shapes``
writes a random checkpoint at a real model's shapes and the datasets become
the offline synthetic corpus, which runs every piece of the plumbing.

Reference numbers: IST-DASLab/gptq-gguf-toolkit README.md:377-412 (8B),
:482-504 (1B); see BASELINE.md.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

# WikiText2 perplexity, reference GPTQ at matched type (BASELINE.md)
REFERENCE_PPL: Dict[str, Dict[str, float]] = {
    "llama-3.2-1b": {
        "F32": 11.55, "Q3_K": 16.84, "Q4_K": 12.16, "Q5_K": 11.67, "Q6_K": 11.58,
    },
    "llama-3.1-8b": {
        "F32": 6.73, "Q2_K": 10.96, "Q3_K": 8.02, "Q4_K": 6.89,
        "Q5_K": 6.79, "Q6_K": 6.75,
    },
}

PPL_TOLERANCE = 0.05  # BASELINE.json acceptance bar

# the shapes of ``make_synthetic_checkpoint``'s presets (HF LlamaConfig keys)
PRESETS = {
    "llama-3.2-1b": dict(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, max_position_embeddings=131072, rope_theta=500000.0,
        tie_word_embeddings=True,
    ),
    "llama-3.1-8b": dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=500000.0,
    ),
    "tiny": dict(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512,
    ),
}


def reference_row(model_name: str) -> Optional[Dict[str, float]]:
    name = model_name.lower().replace("_", "-")
    for key, row in REFERENCE_PPL.items():
        if key in name:
            return row
    return None


@dataclasses.dataclass
class ParityResult:
    bit_width: str
    measured_ppl: float
    reference_ppl: Optional[float]
    delta: Optional[float]
    passed: Optional[bool]
    gguf_path: Optional[str]
    seconds: float


def make_synthetic_checkpoint(out_dir: Union[str, Path], preset: str = "llama-3.2-1b",
                              seed: int = 0) -> Path:
    """Random-weights HF llama checkpoint at a preset's shapes (a dry run
    of the plumbing): ``config.json`` with HF LlamaConfig's defaults,
    f32 tensors in one safetensors file per layer (plus one for the
    embedding and one for the norm and head), and a minimal BPE
    ``tokenizer.json`` so ``pack`` writes a vocabulary.

    The weights follow HF's initialization (normal of std
    ``initializer_range`` 0.02 for the embedding and every linear, ones for
    the norms), drawn from a ``torch.Generator`` seeded with ``seed`` in
    module order. The JAX package draws them through ``transformers``, so
    the values differ from its checkpoint's; the config, the tensor names
    and the shapes do not.
    """
    import torch

    from ..formats import safetensors

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shapes = PRESETS[preset]
    hf = dict(architectures=["LlamaForCausalLM"], model_type="llama", attention_bias=False,
              attention_dropout=0.0, bos_token_id=1, eos_token_id=2, hidden_act="silu",
              initializer_range=0.02, max_position_embeddings=2048, mlp_bias=False,
              pretraining_tp=1, rms_norm_eps=1e-6, rope_scaling=None, rope_theta=10000.0,
              tie_word_embeddings=False, torch_dtype="float32", use_cache=True)
    hf.update(shapes)
    hf.setdefault("head_dim", hf["hidden_size"] // hf["num_attention_heads"])
    (out_dir / "config.json").write_text(json.dumps(hf, indent=2))

    V, H, I = hf["vocab_size"], hf["hidden_size"], hf["intermediate_size"]
    hd, nH, nKV = hf["head_dim"], hf["num_attention_heads"], hf["num_key_value_heads"]
    n_layers = hf["num_hidden_layers"]
    gen = torch.Generator()
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen) * hf["initializer_range"]

    def ones(n):
        return torch.ones(n, dtype=torch.float32)

    n_files = n_layers + 2
    name = "model-{:05d}-of-{:05d}.safetensors".format
    safetensors.write_safetensors({"model.embed_tokens.weight": normal(V, H)},
                                  out_dir / name(1, n_files))
    for i in range(n_layers):
        p = f"model.layers.{i}."
        t = {p + "self_attn.q_proj.weight": normal(nH * hd, H),
             p + "self_attn.k_proj.weight": normal(nKV * hd, H),
             p + "self_attn.v_proj.weight": normal(nKV * hd, H),
             p + "self_attn.o_proj.weight": normal(H, nH * hd),
             p + "mlp.gate_proj.weight": normal(I, H),
             p + "mlp.up_proj.weight": normal(I, H),
             p + "mlp.down_proj.weight": normal(H, I),
             p + "input_layernorm.weight": ones(H),
             p + "post_attention_layernorm.weight": ones(H)}
        safetensors.write_safetensors(t, out_dir / name(i + 2, n_files))
    last = {"model.norm.weight": ones(H)}
    if not hf["tie_word_embeddings"]:
        last["lm_head.weight"] = normal(V, H)
    safetensors.write_safetensors(last, out_dir / name(n_files, n_files))
    # a minimal byte-level BPE, so the packer writes a vocabulary
    vocab = {f"<b{i}>": i for i in range(V)}
    with open(out_dir / "tokenizer.json", "w") as f:
        json.dump({"model": {"type": "BPE", "vocab": vocab, "merges": []},
                   "added_tokens": []}, f)
    return out_dir


def run_parity(
    model_dir: Union[str, Path],
    out_dir: Union[str, Path],
    bit_widths: Sequence[str] = ("Q4_K",),
    *,
    calibration_data: str = "wikitext2",
    calibration_tokens: int = 2 ** 19,
    sequence_length: Optional[int] = None,
    eval_data: Optional[str] = None,
    eval_tokens: int = 2 ** 19,
    reference_name: Optional[str] = None,
    pack: bool = True,
    verbose: bool = True,
    device="cuda",
) -> List[ParityResult]:
    """Per bit width: the GPTQ walk (``quant.calibrate.quantize_model``,
    artifacts in ``<out_dir>/layers-<bw>``), the dequantized model's
    perplexity (``evals.ppl.compute_perplexity``) and, with ``pack``,
    ``<out_dir>/model-<bw>.gguf`` (``export.packer.pack_model``); the
    report goes to ``<out_dir>/parity_report.json``. Datasets are
    ``synthetic`` or token files (``utils.data.get_data``)."""
    from .. import resolve_device
    from ..export import packer
    from ..models import loader
    from ..quant import calibrate
    from ..utils.data import get_data
    from .ppl import compute_perplexity

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = loader.load_config(model_dir)
    params = loader.load_params(model_dir, cfg)
    seq = sequence_length or min(cfg.max_position_embeddings, 4096)
    calib = get_data(calibration_data, calibration_tokens, seq, train=True,
                     vocab_size=cfg.vocab_size)
    eval_name = eval_data or (
        "wikitext2" if not calibration_data.startswith("synthetic") else "synthetic")
    eval_seqs = get_data(eval_name, eval_tokens, seq, train=False, vocab_size=cfg.vocab_size)

    ref_row = reference_row(reference_name or str(model_dir))
    results: List[ParityResult] = []
    for bw in bit_widths:
        t0 = time.time()
        qdir = out / f"layers-{bw}"
        qparams = calibrate.quantize_model(
            params, cfg, calib,
            quant_config={k: bw for k in ("q_proj", "k_proj", "v_proj", "o_proj",
                                          "gate_proj", "up_proj", "down_proj")},
            save_dir=qdir, device=dev)
        qparams = {k: v.to(dev).float() for k, v in qparams.items() if k != "layers"} | {
            "layers": [{k: v.to(dev).float() for k, v in layer.items()}
                       for layer in qparams["layers"]]}
        ppl = compute_perplexity(qparams, cfg, eval_seqs)
        del qparams
        gguf_path = None
        if pack:
            gguf_path = str(out / f"model-{bw}.gguf")
            packer.pack_model(model_dir, qdir, gguf_path)
        ref = ref_row.get(bw) if ref_row else None
        delta = (ppl - ref) if ref is not None else None
        passed = (delta <= PPL_TOLERANCE) if delta is not None else None
        results.append(ParityResult(bw, float(ppl), ref, delta, passed, gguf_path,
                                    time.time() - t0))
        if verbose:
            tag = ("PASS" if passed else "FAIL") if passed is not None else "n/a"
            ref_s = f"{ref:.2f}" if ref is not None else "—"
            print(f"{bw}: ppl {ppl:.3f} vs reference {ref_s} [{tag}] "
                  f"({results[-1].seconds:.0f}s)")

    report = {
        "model": str(model_dir),
        "eval_dataset": eval_name,
        "tolerance": PPL_TOLERANCE,
        "results": [dataclasses.asdict(r) for r in results],
    }
    with open(out / "parity_report.json", "w") as f:
        json.dump(report, f, indent=2)
    return results
