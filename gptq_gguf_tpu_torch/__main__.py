"""Command line of the port: ``python -m gptq_gguf_tpu_torch {quantize,serve} ...``.

``quantize`` runs the GPTQ calibration walk over an HF llama checkpoint and
writes one K-quant artifact per linear (``cli/quantize.py``). ``serve``
loads a K-quant llama GGUF onto the card, fuses q/k/v and gate/up, and
greedily decodes one prompt of token ids through the continuous-batching
engine (the non-HTTP ``serve`` of the JAX package).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


def build_serve(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gguf-file", required=True)
    p.add_argument("--prompt-tokens", type=int, nargs="+", default=[1, 2, 3, 4],
                   help="prompt token ids")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def run_serve(args) -> None:
    from .serving import engine, model as qmodel

    params, cfg = qmodel.load_gguf_for_serving(args.gguf_file, device=args.device)
    params = qmodel.fuse_params_for_serving(params, cfg)
    eng = engine.ContinuousBatchingEngine(params, cfg, num_slots=args.num_slots,
                                          max_len=args.max_len)
    eng.submit(np.asarray(args.prompt_tokens, dtype=np.int64),
               max_new_tokens=args.max_new_tokens)
    t0 = time.time()
    out = eng.run_until_done()[0].output
    dt = time.time() - t0
    print(f"generated {len(out)} tokens in {dt:.2f}s ({len(out) / dt:.1f} tok/s)")
    print(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gptq_gguf_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    from .cli import quantize

    quantize.build_parser(sub.add_parser("quantize", help="GPTQ K-quant calibration walk"))
    build_serve(sub.add_parser("serve", help="greedy decoding from a K-quant GGUF"))
    args = ap.parse_args(argv)
    if args.cmd == "quantize":
        quantize.run(args)
    else:
        run_serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
