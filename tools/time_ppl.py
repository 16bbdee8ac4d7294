#!/usr/bin/env python3
"""Time perplexity scoring through the serving kernels on the card, for one
or more checkouts of the repository, each in a process of its own.

    python3 tools/time_ppl.py [--formats v4,v2] [--seqs 2] [--len 512]
                              [ROOT ...]   (default: this checkout)

Roots run in the order given (pass A B B A to compare two trees within one
run). Each root builds chip_smoke.py's seeded Llama-3-8B-width serving
model (32 layers of synthetic Q4_K weights, the Q6_K lm_head; this
checkout's chip_smoke.py, the root's package) on the card, converts it to
each runtime format of ``--formats`` (v2 as built; v1, v4, "v4 i8", "v4
bf16" as chip_smoke's phase 7 converts them) and times
``compute_perplexity(..., serving=True)`` over SEQS synthetic sequences of
LEN tokens after one warm-up sequence: every projection and the lm_head at
M = LEN rows; v2 runs the kernel variant that ``GG_PALLAS_V2_VARIANT``
names (v2g by default). Host clock around synchronised calls. Prints the
card's name and power limit, then one JSON line per root and format:
seconds per sequence, nats per token, and the dequant-matmul launches of
the timed run. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def one_root(root: str, formats: list, seqs: int, length: int) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from gptq_gguf_tpu_torch.evals import ppl
    from gptq_gguf_tpu_torch.ops import qmatmul, qmv4
    from gptq_gguf_tpu_torch.utils.data import get_data

    wrappers = {"v1": qmatmul.dequant_matmul_v1, "v4": qmv4.dequant_matmul_v4,
                **{v: getattr(qmatmul, name) for v, name in qmatmul.V2_WRAPPERS.items()}}

    def counts():  # launches, and tensor-core launches where a wrapper counts them
        out = {k: fn.launches for k, fn in wrappers.items()}
        out.update({f"{k}_mma": fn.mma_launches for k, fn in wrappers.items()
                    if hasattr(fn, "mma_launches")})
        return out

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params, cfg = cs.build_8b(np.random.default_rng(cs.SEED), dev)
    data = get_data("synthetic", seqs * length, length, train=False, vocab_size=cs.V)
    for fmt in formats:
        p = params if fmt == "v2" else cs.format_params(params, fmt)
        ppl.compute_perplexity(p, cfg, data[:1], serving=True)  # builds, first launches
        n0 = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        value = ppl.compute_perplexity(p, cfg, data, serving=True)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t) / len(data)
        launches = {k: n - n0[k] for k, n in counts().items() if n - n0[k]}
        print(json.dumps({"root": root, "format": fmt, "seqs": len(data), "len": length,
                          "s_per_seq": secs, "nll": float(np.log(value)),
                          "launches": launches}), flush=True)
        del p
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--formats", default="v4", help="comma list of v2, v1, v4, v4 i8, v4 bf16")
    ap.add_argument("--seqs", type=int, default=2)
    ap.add_argument("--len", type=int, default=512)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    formats = args.formats.split(",")
    if args.one:
        one_root(args.one, formats, args.seqs, args.len)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_ppl: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    for root in args.roots:
        rc = subprocess.run([sys.executable, __file__, "--one", root, "--formats", args.formats,
                             "--seqs", str(args.seqs), "--len", str(args.len)]).returncode
        if rc != 0:
            print(f"time_ppl: root {root} failed ({rc})", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
