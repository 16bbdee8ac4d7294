"""Command line of the port: ``python -m gptq_gguf_tpu_torch <command> ...``.

``quantize`` runs the GPTQ calibration walk over an HF llama checkpoint and
writes one K-quant artifact per linear (``cli/quantize.py``). ``pack``
writes the checkpoint and those artifacts as a K-quant GGUF, on the host
(``cli/tools.py``, ``export/packer.py``). ``build-db`` splits GGUFs of
several quantization levels into the layer database (``split`` one file
into one layout), ``search`` runs EvoPress over it on the card,
``convert-config`` renames its config to GGUF tensors and ``stitch``
assembles the chosen tensors into one GGUF; ``gguf-split`` shards or
merges a GGUF (``cli/tools.py``, ``mapper/``, ``search/``). ``ppl``
scores a GGUF (dense, or through the serving kernels) or an HF checkpoint
(``cli/tools.py``). ``serve``
loads a K-quant llama GGUF onto the card, fuses q/k/v and gate/up, and
either greedily decodes one prompt (token ids or text) or, with
``--http``, serves HTTP requests; ``--paged`` takes the paged-KV engine
instead of the contiguous one.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


def build_serve(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gguf-file", required=True)
    p.add_argument("--prompt-tokens", type=int, nargs="+", default=None,
                   help="prompt token ids (no tokenizer needed)")
    p.add_argument("--prompt", default=None,
                   help="text prompt, tokenized with the GGUF's own vocab "
                        "(tokenizer.ggml.* metadata, like llama.cpp)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--paged", action="store_true", help="block-table paged KV cache")
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--http", action="store_true", help="run the HTTP server loop")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir for text prompts over HTTP")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def make_engine(args, params, cfg, eos_id=None):
    """The engine the flags ask for: paged (--paged) or contiguous."""
    from .serving import engine

    if args.paged:
        return engine.PagedContinuousBatchingEngine(
            params, cfg, num_slots=args.num_slots, max_len=args.max_len,
            page_size=args.page_size, eos_token_id=eos_id, device=args.device)
    return engine.ContinuousBatchingEngine(params, cfg, num_slots=args.num_slots,
                                           max_len=args.max_len, eos_token_id=eos_id)


def _gguf_tokenizer(path):
    from .formats.gguf import GGUFReader
    from .serving import tokenizer as gtok

    return gtok.from_gguf(GGUFReader(path))


def run_serve(args) -> None:
    from .serving import model as qmodel

    params, cfg = qmodel.load_gguf_for_serving(args.gguf_file, device=args.device)
    params = qmodel.fuse_params_for_serving(params, cfg)

    if args.http:
        from .serving.server import serve_http, wrap_gguf_tokenizer

        tokenizer = eos_id = None
        if args.tokenizer:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
            eos_id = tokenizer.eos_token_id
        else:  # fall back to the GGUF's own vocab (llama.cpp behavior)
            gg = _gguf_tokenizer(args.gguf_file)
            if gg is not None:
                tokenizer, eos_id = wrap_gguf_tokenizer(gg), gg.eos_id
        serve_http(make_engine(args, params, cfg, eos_id), host=args.host, port=args.port,
                   tokenizer=tokenizer)
        return

    gg = None
    if args.prompt_tokens is not None:
        prompt = np.asarray(args.prompt_tokens, dtype=np.int64)
    elif args.prompt is not None:
        gg = _gguf_tokenizer(args.gguf_file)
        if gg is None:
            raise SystemExit("--prompt needs a GGUF with tokenizer.ggml.* metadata; "
                             "use --prompt-tokens for vocab-less files")
        prompt = np.asarray(gg.encode(args.prompt), dtype=np.int64)
        if prompt.size == 0:
            raise SystemExit("--prompt tokenized to 0 tokens with this GGUF's vocab; "
                             "pass --prompt-tokens instead")
    else:
        prompt = np.asarray([1, 2, 3, 4], dtype=np.int64)
    eng = make_engine(args, params, cfg)
    eng.submit(prompt, max_new_tokens=args.max_new_tokens)
    t0 = time.time()
    out = eng.run_until_done()[0].output
    dt = time.time() - t0
    print(f"generated {len(out)} tokens in {dt:.2f}s ({len(out) / dt:.1f} tok/s)")
    print(out)
    if gg is not None:
        print(repr(gg.decode(out)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gptq_gguf_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    from .cli import quantize, tools

    quantize.build_parser(sub.add_parser("quantize", help="GPTQ K-quant calibration walk"))
    tools.build_pack(sub.add_parser("pack", help="HF checkpoint + artifacts -> GGUF"))
    build_serve(sub.add_parser("serve", help="greedy decoding from a K-quant GGUF"))
    tools.build_ppl(sub.add_parser("ppl", help="perplexity of a GGUF or an HF checkpoint"))
    runs = {"quantize": quantize.run, "pack": tools.run_pack, "serve": run_serve,
            "ppl": tools.run_ppl}
    for name, build, run, text in (
            ("split", tools.build_split, tools.run_split, "GGUF -> layer database"),
            ("stitch", tools.build_stitch, tools.run_stitch, "layer database + config -> GGUF"),
            ("convert-config", tools.build_convert_config, tools.run_convert_config,
             "search config (HF names) -> stitch config (GGUF names)"),
            ("build-db", tools.build_build_db, tools.run_build_db,
             "GGUFs of several levels -> the search's layer database"),
            ("search", tools.build_search, tools.run_search, "EvoPress bit-width search"),
            ("gguf-split", tools.build_gguf_split, tools.run_gguf_split,
             "shard a GGUF, or merge shards")):
        build(sub.add_parser(name, help=text))
        runs[name] = run
    args = ap.parse_args(argv)
    runs[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
