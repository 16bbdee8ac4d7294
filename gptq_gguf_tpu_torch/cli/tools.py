"""The ``ppl`` subcommand of the port (after ``gptq_gguf_tpu/cli/tools.py``).

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

import numpy as np

from . import common


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
