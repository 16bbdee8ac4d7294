"""The ``pack`` and ``ppl`` subcommands of the port (after
``gptq_gguf_tpu/cli/tools.py``).

    python -m gptq_gguf_tpu_torch pack --model_dir /models/llama \\
      --quant_dir out/layers --outfile model.gguf [--outtype f16|f32|bf16|q8_0|auto]

writes a K-quant GGUF from an HF llama checkpoint and the artifacts of
``quantize`` (``export/packer.py``), optionally sharded
(``--split-max-tensors`` / ``--split-max-size``). It runs on the host
(numpy) and launches nothing on the card.

    python -m gptq_gguf_tpu_torch ppl --gguf-file model.gguf \\
      --datasets synthetic --eval_tokens 4096 --sequence_length 512 \\
      [--gguf-path auto|dense|serving] [--output_path ppl.json] [--device cpu]

    python -m gptq_gguf_tpu_torch ppl --model_name_or_path /models/llama ...

A GGUF is scored either dense (every tensor dequantized to f32, through
``models.llama.forward``) or through the serving forward with the weights
kept packed (``--gguf-path serving``: every projection and the lm_head run
through the runtime format's kernel). ``auto`` picks dense below 2e9 bytes
of f32 weights. Datasets are ``synthetic`` or pre-tokenized files, so no
tokenizer is read; the text datasets raise in ``utils.data.get_data``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from . import common


def build_pack(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_dir", help="HF checkpoint")
    p.add_argument("--quant_dir", default=None, help="calibration artifacts")
    p.add_argument("--outfile")
    p.add_argument("--outtype", default="f16", choices=["f32", "f16", "bf16", "q8_0", "auto"],
                   help="format of the tensors without an artifact ('auto': the 16-bit "
                        "float of the checkpoint's dtype)")
    p.add_argument("--vocab-only", action="store_true", help="write metadata + vocab, no tensors")
    p.add_argument("--metadata", default=None, help="JSON file of extra metadata overrides")
    p.add_argument("--model-name", default=None, help="override general.name")
    p.add_argument("--print-supported-models", action="store_true")
    p.add_argument("--split-max-tensors", type=int, default=0,
                   help="shard the output GGUF every N tensors")
    p.add_argument("--split-max-size", default=None,
                   help="shard the output GGUF at ~SIZE (e.g. 40G)")
    p.add_argument("--mmproj", action="store_true", help="not ported yet")


def _resolve_outtype(args):
    from ..formats import safetensors
    from ..formats.ggml import GGMLQuantizationType as T

    name = args.outtype
    if name == "auto":  # the 16-bit float of the first file's first tensor
        files = sorted(Path(args.model_dir).glob("*.safetensors"))
        name = "f16"
        if files:
            header, _ = safetensors.read_header(files[0])
            if header:
                name = "bf16" if header[min(header)]["dtype"] == "BF16" else "f16"
    return {"f32": T.F32, "f16": T.F16, "bf16": T.BF16, "q8_0": T.Q8_0}[name]


def _size_bytes(text: str) -> int:
    """"40G" / "512M" / "64K" or a plain byte count."""
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}
    sfx = text[-1].upper()
    return int(text[:-1]) * units[sfx] if sfx in units else int(text)


def run_pack(args):
    """Write the GGUF (or its shards); returns the paths written."""
    from ..export import packer

    if args.print_supported_models:
        for mt in packer.SUPPORTED_MODEL_TYPES:
            print(mt)
        return []
    if args.mmproj:
        raise NotImplementedError("pack --mmproj is not ported yet")
    if not args.model_dir or not args.outfile:
        raise SystemExit("--model_dir and --outfile are required")
    if args.quant_dir is None and not args.vocab_only:
        raise SystemExit("--quant_dir is required unless --vocab-only is given")
    extra = {}
    if args.metadata:
        with open(args.metadata) as f:
            extra.update(json.load(f))
    if args.model_name:
        extra["general.name"] = args.model_name
    t0 = time.perf_counter()
    out = packer.pack_model(args.model_dir, args.quant_dir, args.outfile,
                            default_float=_resolve_outtype(args),
                            extra_metadata=extra or None, vocab_only=args.vocab_only)
    written = [out]
    if args.split_max_tensors or args.split_max_size:
        from ..mapper import shards

        prefix = str(out)[:-5] if str(out).endswith(".gguf") else str(out)
        written = shards.split_gguf_file(
            out, prefix, max_tensors=args.split_max_tensors,
            max_size=_size_bytes(args.split_max_size) if args.split_max_size else 0)
        os.unlink(out)
    for path in written:
        print(f"wrote {path}")
    print(f"pack took {time.perf_counter() - t0:.2f} s")
    return written


def build_ppl(p: argparse.ArgumentParser) -> None:
    common.add_model_args(p, required=False)
    p.add_argument("--gguf-file", default=None,
                   help="evaluate a GGUF directly (through the serving loader)")
    p.add_argument("--datasets", nargs="+", default=["synthetic"],
                   help="synthetic | token file (.npy/.npz/.pt)")
    p.add_argument("--sequence_length", type=int, default=None)
    p.add_argument("--eval_tokens", type=int, default=2**17)
    p.add_argument("--gguf-path", default="auto", choices=["auto", "dense", "serving"],
                   help="GGUF scoring path: 'dense' dequantizes every weight to f32, "
                        "'serving' scores through the fused dequant kernels with the "
                        "weights kept packed; 'auto' picks dense below ~2 GB of f32 "
                        "weights")
    p.add_argument("--output_path", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    # options of the JAX CLI that the port does not take yet
    p.add_argument("--compressed_weights_path", default=None, help="not ported yet")
    p.add_argument("--drop_layer_config", default=None, help="not ported yet")
    p.add_argument("--memory_efficient", action="store_true", help="not ported yet")


def run_ppl(args) -> dict:
    """Score each dataset; prints and returns {dataset: perplexity}."""
    from .. import resolve_device
    from ..evals import ppl
    from ..models.llama import _DTYPES
    from ..utils.data import get_data

    for flag in ("compressed_weights_path", "drop_layer_config", "memory_efficient"):
        if getattr(args, flag):
            raise NotImplementedError(f"ppl --{flag} is not ported yet")
    dev = resolve_device(args.device)
    serving_path = False
    if args.gguf_file:
        from ..mapper.shards import open_gguf
        from ..serving import model as qmodel

        mode = args.gguf_path
        if mode == "auto":  # every shard of a split set counts
            n_el = sum(int(np.prod(i.shape)) for i in open_gguf(args.gguf_file).tensors.values())
            mode = "dense" if n_el * 4 < 2e9 else "serving"
        serving_path = mode == "serving"
        params, cfg = qmodel.load_gguf_for_serving(
            args.gguf_file, dtype=_DTYPES[args.dtype], device=dev, dense=not serving_path)
    else:
        if not args.model_name_or_path:
            raise SystemExit("need --model_name_or_path or --gguf-file")
        cfg, host = common.load_model(args)
        params = {k: v.to(dev).float() for k, v in host.items() if k != "layers"}
        params["layers"] = [{k: v.to(dev).float() for k, v in layer.items()}
                            for layer in host["layers"]]
    seq = args.sequence_length or min(cfg.max_position_embeddings, 4096)
    results = {}
    for name in args.datasets:
        data = get_data(name, args.eval_tokens, seq, train=False, vocab_size=cfg.vocab_size)
        results[name] = ppl.compute_perplexity(params, cfg, data, serving=serving_path)
        print(f"{name} perplexity: {results[name]:.3f}")
    if args.output_path:
        with open(args.output_path, "w") as f:
            json.dump(results, f, indent=2)
    return results
