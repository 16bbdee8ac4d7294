#!/usr/bin/env python3
"""Time the GPTQ column-block solve kernel (``ops/csrc/gptq_solve.cu``) on
the card, for one or more checkouts of the repository, each in a process of
its own.

    python3 tools/time_gptq_solve.py [--reps 50] [ROOT ...]   (default: this checkout)

Roots run in the order given (pass A B B A to compare two trees within one
run). Each root calls ``gptq.solve_block`` at chip_smoke's shapes: the
block shapes one Llama-3-8B-width layer gives it at the default block of
128 columns (``SOLVE_SHAPES``) and the wide blocks of the o projection
(``WIDE_SOLVES``: 512 columns and the whole 4096, ``--static_groups
--block_size 0``); a root whose kernel refuses a wide block records null
for it. Inputs, costs and timing are chip_smoke's own (``solve_factor``,
``u_block``, ``solve_inputs`` at Q4_K, ``solve_cost``, ``cuda_ms``: CUDA
events around each call, the L2 cache flushed outside them), taken from
the ``chip_smoke.py`` beside this tool whatever the root, so every root
gets the same inputs. Each case is checked bit-equal to
``gptq.solve_block_reference`` first; the card spins for a second before
the timings (a cold first timing ran slow). Prints the card's name and
power limit, then per root the ptxas report of the kernel library
(registers, spill store and load bytes per kernel) and one JSON line: ms
per call by shape, ms per layer (208 calls: 32 each of q/k/v, o, gate/up,
112 of down) and the bound per shape and per layer (the larger of the
bytes over the card's memory rate and the f32 operations over its CUDA-core
rate). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from time_v2_kernels import ptxas_report  # noqa: E402


def chip_smoke():
    """This checkout's chip_smoke.py as a module (a root may hold another)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_root(root: str, reps: int) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from gptq_gguf_tpu_torch.formats.ggml import GGMLQuantizationType as T
    from gptq_gguf_tpu_torch.ops import cuda_build, gptq

    cs = chip_smoke()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    nvcc_log = cuda_build.build("gptq_solve")
    saved = cuda_build.library_path("gptq_solve").with_suffix(".log")
    nvcc_log = nvcc_log or (saved.read_text() if saved.exists() else None)
    print(json.dumps({"root": root, "library": "gptq_solve",
                      "ptxas": ptxas_report(nvcc_log) if nvcc_log else "cached"}), flush=True)

    rng = np.random.default_rng(cs.SEED)
    U_full = cs.solve_factor(rng, dev)
    shapes = [(name, d_row, cs.BLOCK, per_layer) for name, d_row, per_layer in cs.SOLVE_SHAPES]
    shapes += [(f"{name}_bs{bs}", d_row, bs, 0) for name, d_row, bs in cs.WIDE_SOLVES]
    cases = {name: cs.solve_inputs(rng, cs.u_block(U_full, bs), d_row, T.Q4_K, dev)
             for name, d_row, bs, _ in shapes}
    del U_full
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    warm = torch.ones((4096, 4096), device=dev)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        warm @ warm
        torch.cuda.synchronize()
    del warm

    ms, bound, equal = {}, {}, {}
    for name, d_row, bs, _ in shapes:
        args = cases[name]
        nbytes, ops = cs.solve_cost(d_row, bs)
        bound[name] = max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.F32_FLOP_PER_S) * 1e3
        try:
            qk, ek = gptq.solve_block(*args)
        except ValueError:  # a kernel that takes narrower blocks only
            ms[name] = equal[name] = None
            continue
        qp, ep = gptq.solve_block_reference(*args)
        equal[name] = bool(torch.equal(qk, qp) and torch.equal(ek, ep))
        del qk, ek, qp, ep
        ms[name] = cs.cuda_ms(lambda: gptq.solve_block(*args), reps, flush.zero_)
    per_layer = {k: sum(d[name] * n for name, _, _, n in shapes if n) for k, d in
                 (("ms", ms), ("bound", bound))}
    print(json.dumps({"root": root, "ms_per_call": ms, "bound_ms_per_call": bound,
                      "bit_equal_to_plain": equal, "ms_per_layer": per_layer["ms"],
                      "bound_ms_per_layer": per_layer["bound"]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_root(args.one, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_gptq_solve: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    for root in args.roots:
        rc = subprocess.run([sys.executable, __file__, "--one", root, "--reps",
                             str(args.reps)]).returncode
        if rc != 0:
            print(f"time_gptq_solve: root {root} failed ({rc})", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
