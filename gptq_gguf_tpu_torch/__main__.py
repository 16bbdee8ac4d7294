"""Command line of the port: ``python -m gptq_gguf_tpu_torch <command> ...``.

``quantize`` runs the GPTQ calibration walk over an HF llama checkpoint and
writes one K-quant artifact per linear (``cli/quantize.py``). ``pack``
writes the checkpoint and those artifacts as a K-quant GGUF, on the host
(``cli/tools.py``, ``export/packer.py``). ``build-db`` splits GGUFs of
several quantization levels into the layer database (``split`` one file
into one layout), ``search`` runs EvoPress over it on the card,
``convert-config`` renames its config to GGUF tensors and ``stitch``
assembles the chosen tensors into one GGUF; ``gguf-split`` shards or
merges a GGUF (``cli/tools.py``, ``mapper/``, ``search/``). The
llama-quantize route: ``imatrix`` measures each linear's importance
vector, ``rtn-quantize`` writes round-to-nearest artifacts (and a GGUF),
``llama-quantize`` requantizes a float GGUF with a llama.cpp recipe
(``quant/{rtn,recipes,imatrix_io}.py``). ``ppl``
scores a GGUF (dense, or through the serving kernels) or an HF checkpoint
(``cli/tools.py``). ``serve``
loads a K-quant llama GGUF onto the card, fuses q/k/v and gate/up, and
either greedily decodes one prompt (token ids or text), or, with
``--http``, serves HTTP requests (greedy or sampled, with logprobs), or,
with ``--benchmark``, times decode steps with every slot filled and prints
one JSON line; ``--paged`` takes the paged-KV engine instead of the
contiguous one, ``--kv-dtype int8 | int4`` a quantized KV cache.
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--benchmark", action="store_true",
                   help="measure decode throughput on this GGUF: fill all slots, run "
                        "timed decode steps, print one JSON line")
    p.add_argument("--benchmark-steps", type=int, default=32)
    p.add_argument("--benchmark-prompt-len", type=int, default=64)
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--kv-quantized", action="store_true",
                   help="int8 KV cache (halves KV memory and traffic)")
    p.add_argument("--kv-dtype", default=None, choices=["bf16", "int8", "int4"],
                   help="KV cache dtype (int4: packed codes + group scales, 3.2x less KV "
                        "memory and traffic); overrides --kv-quantized")
    p.add_argument("--paged", action="store_true", help="block-table paged KV cache")
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--http", action="store_true", help="run the HTTP server loop")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir for text prompts over HTTP")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")


def kv_dtype(args) -> str:
    """The KV cache dtype the flags ask for: --kv-dtype, else int8 under
    --kv-quantized, else bf16."""
    return args.kv_dtype or ("int8" if args.kv_quantized else "bf16")


def make_engine(args, params, cfg, eos_id=None):
    """The engine the flags ask for: paged (--paged; bf16 or int4 pools) or
    contiguous (bf16, int8 or int4 cache)."""
    from .serving import engine

    kvd = kv_dtype(args)
    if args.paged:
        if kvd == "int8":
            raise SystemExit("--paged takes --kv-dtype bf16 or int4 (no paged int8 pools)")
        return engine.PagedContinuousBatchingEngine(
            params, cfg, num_slots=args.num_slots, max_len=args.max_len,
            page_size=args.page_size, eos_token_id=eos_id,
            kv_quantized="int4" if kvd == "int4" else False, device=args.device)
    return engine.ContinuousBatchingEngine(params, cfg, num_slots=args.num_slots,
                                           max_len=args.max_len, eos_token_id=eos_id,
                                           kv_quantized=kvd)


def run_benchmark(args, params, cfg) -> dict:
    """Decode throughput with every slot filled: each slot prefilled with
    one random prompt, 4 warm-up steps, then --benchmark-steps decode
    steps, each read back; returns the JSON record."""
    import torch

    from .serving import engine, model as qmodel

    rng = np.random.default_rng(0)
    B, P = args.num_slots, args.benchmark_prompt_len
    dev = params["embed_tokens"].device
    cache = qmodel.init_cache(cfg, B, args.max_len, kv_dtype=kv_dtype(args), device=dev)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, P)), device=dev)
    t0 = time.time()
    for slot in range(B):
        tok, _, cache = engine._prefill_slot(params, cfg, prompt, cache, slot)
        int(tok)
    prefill_s = time.time() - t0
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B,)), dtype=torch.int32,
                             device=dev)
    fill = P
    for _ in range(4):  # warm-up
        tokens, _, cache = engine._decode_step(params, cfg, tokens, cache, fill)
        tokens.tolist()
        fill += 1
    t0 = time.time()
    for _ in range(args.benchmark_steps):
        tokens, _, cache = engine._decode_step(params, cfg, tokens, cache, fill)
        tokens.tolist()  # the readback waits for the step
        fill += 1
    dt = (time.time() - t0) / args.benchmark_steps
    return {"tokens_per_s": round(B / dt, 2), "ms_per_step": round(dt * 1e3, 3),
            "batch": B, "prompt_len": P, "max_len": args.max_len,
            "prefill_s_total": round(prefill_s, 2), "kv_dtype": kv_dtype(args)}


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
    if args.benchmark:
        print(json.dumps(run_benchmark(args, params, cfg)))
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
    build_serve(sub.add_parser("serve", help="serve a K-quant GGUF (one prompt, HTTP or a "
                                             "decode benchmark)"))
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
             "shard a GGUF, or merge shards"),
            ("rtn-quantize", tools.build_rtn, tools.run_rtn,
             "round-to-nearest K-quant artifacts (optionally imatrix-weighted)"),
            ("imatrix", tools.build_imatrix, tools.run_imatrix,
             "importance vectors of every linear (.npz or llama.cpp .imatrix)"),
            ("llama-quantize", tools.build_llama_quantize, tools.run_llama_quantize,
             "GGUF -> GGUF with a llama.cpp recipe (Q4_K_M, IQ4_XS, ...)")):
        build(sub.add_parser(name, help=text))
        runs[name] = run
    args = ap.parse_args(argv)
    runs[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
